"""Multi-host runtime (parallel/distributed.py) exercised for REAL:
two localhost processes bring up jax.distributed over a coordinator,
build the global mesh, and run the point-sharded windowed BA with
cross-process psum (Gloo on CPU) — asserting parity with the
single-process result computed in this test process.

This is the 2-host north star of BASELINE.json scaled down to CI: the
code path (distributed.initialize -> global_mesh -> sharded_ba_optimize)
is exactly what a 2-host GPU deployment runs; only the transport differs
(NCCL over NVLink/the network there, localhost gRPC+Gloo here)."""
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS_DIR)

WORKER = r"""
import os, sys
pid = int(sys.argv[1]); port = sys.argv[2]; out = sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
sys.path.insert(0, {repo!r}); sys.path.insert(0, {tests!r})
import numpy as np
from hslam_tpu.parallel import distributed as D
D.initialize(coordinator_address=f"localhost:{{port}}",
             num_processes=2, process_id=pid)
import jax
assert len(jax.devices()) == 8, jax.devices()
assert jax.process_count() == 2
mesh = D.global_mesh("points")

import jax.numpy as jnp
from test_ba import make_synthetic_window
from hslam_tpu.parallel.dist_ba import sharded_ba_optimize

wnd, calib, cfg = make_synthetic_window()
wnd = wnd._replace(frames=wnd.frames._replace(
    prior=jnp.full_like(wnd.frames.prior, 1e8)))
# numpy pytrees: multi-process meshes treat numpy inputs as replicated
wnd = jax.tree.map(np.asarray, wnd)
calib = jax.tree.map(np.asarray, calib)

res = sharded_ba_optimize(mesh, wnd, calib, cfg, 4)
# replicated outputs (P() spec) are fully addressable on every process
rmse = float(res.rmse)
state = np.asarray(res.window.frames.state)
cal = np.asarray(res.calib.value)
eth = np.asarray(res.window.frames.energy_th)
if pid == 0:
    np.savez(out, rmse=rmse, state=state, cal=cal, eth=eth)
print(f"proc {{pid}}: rmse={{rmse:.6f}}", flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


@pytest.mark.slow
def test_two_process_distributed_ba_parity(tmp_path):
    worker_py = tmp_path / "worker.py"
    worker_py.write_text(WORKER.format(repo=REPO, tests=TESTS_DIR))
    out = tmp_path / "result.npz"
    port = _free_port()

    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env["PYTHONPATH"] = ""
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker_py), str(i), str(port), str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            o, _ = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(o.decode(errors="replace"))
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{outs[i][-4000:]}"
    assert out.exists(), "process 0 wrote no result"

    # single-process reference (identical fixture + conditioning)
    from test_ba import make_synthetic_window
    from hslam_tpu.models.optimizer import ba_optimize

    wnd, calib, cfg = make_synthetic_window()
    wnd = wnd._replace(frames=wnd.frames._replace(
        prior=jnp.full_like(wnd.frames.prior, 1e8)))
    res_s = jax.jit(lambda w, c: ba_optimize(w, c, cfg, 4))(wnd, calib)

    got = np.load(out)
    np.testing.assert_allclose(float(got["rmse"]), float(res_s.rmse),
                               rtol=1e-4)
    np.testing.assert_allclose(got["state"],
                               np.asarray(res_s.window.frames.state),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["cal"], np.asarray(res_s.calib.value),
                               rtol=1e-5)
    np.testing.assert_allclose(got["eth"],
                               np.asarray(res_s.window.frames.energy_th),
                               rtol=1e-4)
