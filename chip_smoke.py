"""Smoke run of the SLAM main path on one NVIDIA GPU.

    python chip_smoke.py               # one card: parity + system + photocal
    python chip_smoke.py --four-cards  # four cards: sharded BA vs one card,
                                       # and dryrun_multichip(4); nothing else

Phases, in one process (a JAX process reserves most of the card's memory):

1. Device: refuses anything but a GPU (no CPU fallback); prints the device,
   the card's name and power limit, and the compile-cache directory.
2. Parity at real widths: the pyramid (640x480, 6 levels, gamma weights),
   one BA Hessian/gradient assembly (8 frames, 2048 points) and one
   track_step, each run on the GPU and on the CPU device of the same
   process. The CPU is the plain reference here, not a fallback.
3. System: SLAMSystem(sequential=False) with loop closure on the bench
   renderer's 640x480 sequences; then a 40-frame run with online
   photometric calibration.

Every check prints its own line; a failed check or phase does not skip the
phases after it. The last line of stdout is the JSON contract line,
printed only when every check passed; otherwise the exit code is 1.
"""
from __future__ import annotations

import argparse
import faulthandler
import json
import subprocess
import sys
import time
import traceback
from functools import partial

import numpy as np

H, W = 480, 640
PYR_LEVELS = 6
TOL_PYR_ABS = 1e-3      # I, dx, dy: intensity units
TOL_PYR_G2_REL = 1e-5   # |grad|^2, relative to max(1, |ref|)
TOL_BA_REL = 1e-4       # relative Frobenius error per frame block of H, b
TOL_TRACK = 1e-4        # abs error of the tracked rotation and translation
TOL_SHARDED_REL = 1e-4  # four-card BA vs one card: rmse and frame states
ATE_MAX = 0.08
WARMUP, ARC = 30, 80
PHOTOCAL_FRAMES = 40
WATCHDOG_S = 1150      # dump every thread's stack and exit 1


FAILED: list = []   # messages of the checks and phases that failed


def check(ok: bool, msg: str) -> None:
    print(("ok   " if ok else "FAIL ") + msg, flush=True)
    if not ok:
        FAILED.append(msg)


def run_phase(name, fn, *args):
    """Run one phase; an exception fails it without skipping the others."""
    t0 = time.perf_counter()
    try:
        fn(*args)
    except Exception:  # noqa: BLE001 — reported, and fails the run
        traceback.print_exc()
        check(False, f"phase {name} raised")
    print(f"phase {name} {time.perf_counter() - t0:.2f} s", flush=True)


def gpu_missing(devices) -> str | None:
    """Why this process cannot run the smoke, or None: a CPU result is no
    evidence, so there is no fallback."""
    if not devices or devices[0].platform != "gpu":
        plat = devices[0].platform if devices else "none"
        return f"no GPU found (JAX platform: {plat})"
    return None


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({e})"


def _on(dev, fn, *args):
    import jax
    return jax.device_get(jax.jit(fn)(*jax.device_put(args, dev)))


def _frame_u8(frame_at, t):
    from bench import _arc_xi
    img, _ = frame_at(_arc_xi(t))
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


# ----------------------------------------------------------------- parity
def parity_pyramid(gpu, cpu, frame_at):
    from hslam_tpu.ops.pyramid import build_direct_pyramid
    img = _frame_u8(frame_at, 0.0)
    gw = np.linspace(0.5, 1.5, 256).astype(np.float32)

    def f(img, gw):
        return build_direct_pyramid(img.astype(np.float32), PYR_LEVELS,
                                    gamma_grad_weight=gw)

    (lv_g, g2_g), (lv_c, g2_c) = _on(gpu, f, img, gw), _on(cpu, f, img, gw)
    e_abs = max(float(np.max(np.abs(a - b))) for a, b in zip(lv_g, lv_c))
    e_g2 = max(float(np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b))))
               for a, b in zip(g2_g, g2_c))
    check(e_abs <= TOL_PYR_ABS,
          f"pyramid {img.shape[0]}x{img.shape[1]}x{PYR_LEVELS}: I/dx/dy max "
          f"abs err {e_abs:.3g} (tol {TOL_PYR_ABS:g})")
    check(e_g2 <= TOL_PYR_G2_REL,
          f"pyramid |grad|^2 max rel err {e_g2:.3g} (tol {TOL_PYR_G2_REL:g})")


def _assemble(wnd, calib, cfg):
    """One BA Hessian/gradient assembly: linearize + accumulate."""
    from hslam_tpu.models import window as Wn
    from hslam_tpu.ops import ba

    F = cfg.max_frames
    frames, points = wnd.frames, wnd.points
    lin = ba.linearize(frames, points, calib, cfg)
    grid = ((points.status == Wn.PT_ACTIVE)[:, None] & frames.valid[None]
            & (points.host[:, None] != np.arange(F)[None]))
    active = grid & (lin.new_state == Wn.RES_IN)
    AH, AT = ba.compute_adjoints(frames)
    sys_ = ba.accumulate(lin, active, points.host, AH, AT, F)
    return sys_.H, sys_.b, sys_.num_res


def parity_ba_assembly(gpu, cpu, cfg, height, width):
    from __graft_entry__ import _build_ba_inputs
    from hslam_tpu.config import CPARS

    wnd, calib = _build_ba_inputs(cfg, height=height, width=width)
    F = cfg.max_frames

    assemble = partial(_assemble, cfg=cfg)
    Hg, bg, n_g = _on(gpu, assemble, wnd, calib)
    Hc, bc, n_c = _on(cpu, assemble, wnd, calib)
    check(int(n_g) == int(n_c) and int(n_c) > 0,
          f"BA assembly {F} frames x {cfg.max_points} points at "
          f"{width}x{height}: active residuals gpu {int(n_g)} cpu {int(n_c)}")

    def rel(a, b):
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))

    blocks = [slice(0, CPARS)] + [slice(CPARS + 8 * f, CPARS + 8 * f + 8)
                                  for f in range(F)]
    e_h = max(rel(Hg[s], Hc[s]) for s in blocks)
    e_b = rel(bg, bc)
    check(np.all(np.isfinite(Hg)) and e_h <= TOL_BA_REL,
          f"BA H max rel Frobenius err over frame blocks {e_h:.3g} "
          f"(tol {TOL_BA_REL:g})")
    check(np.all(np.isfinite(bg)) and e_b <= TOL_BA_REL,
          f"BA b rel err {e_b:.3g} (tol {TOL_BA_REL:g})")


def synthetic_track_inputs(frame_at, cfg, height, width, n_pts=2048):
    """A tracking template on the plane the bench renderer draws (depth
    known), and a frame a few camera steps further along the arc."""
    import jax
    import jax.numpy as jnp
    from bench import DEPTH
    from hslam_tpu.ops import tracker as trk
    from hslam_tpu.ops.pyramid import build_direct_pyramid

    ref = jnp.asarray(_frame_u8(frame_at, 0.0), jnp.float32)
    pyr, _ = build_direct_pyramid(ref, cfg.pyr_levels)
    k = jax.random.PRNGKey(3)
    u = jax.random.uniform(k, (n_pts,), minval=8.0, maxval=width - 8.0)
    v = jax.random.uniform(jax.random.fold_in(k, 1), (n_pts,), minval=8.0,
                           maxval=height - 8.0)
    # the renderer's plane sits at depth DEPTH in the first camera
    tpl = trk.build_template(u, v, jnp.full(n_pts, 1.0 / DEPTH),
                             jnp.ones(n_pts), jnp.ones(n_pts, bool), pyr)
    return tpl, _frame_u8(frame_at, 0.15)


def parity_track_step(gpu, cpu, frame_at, cfg, calib_value, height, width):
    import jax.numpy as jnp
    from hslam_tpu.ops import tracker as trk

    tpl, img = synthetic_track_inputs(frame_at, cfg, height, width)
    eye = np.eye(4, dtype=np.float32)
    z2 = np.zeros(2, np.float32)
    one = np.float32(1.0)
    step = partial(trk.track_step, cfg=cfg, n_levels=cfg.pyr_levels)

    def f(tpl, img, calib_value, eye, z2, one):
        out = step(tpl, img, calib_value, eye, eye, eye, jnp.bool_(False),
                   z2, one, one, z2, dt_ratio=one)
        return out.R, out.t, out.ok

    args = (tpl, img, np.asarray(calib_value, np.float32), eye, z2, one)
    Rg, tg, okg = _on(gpu, f, *args)
    Rc, tc, okc = _on(cpu, f, *args)
    e = max(float(np.max(np.abs(Rg - Rc))), float(np.max(np.abs(tg - tc))))
    check(bool(okg) and bool(okc) and e <= TOL_TRACK,
          f"track_step {width}x{height}: ok gpu {bool(okg)} cpu {bool(okc)}, "
          f"pose max abs err {e:.3g} (tol {TOL_TRACK:g}), "
          f"|t| {float(np.linalg.norm(tc)):.4f}")


# ----------------------------------------------------------------- system
def run_system(frame_at, cfg, fx, fy, cx, cy, height, width):
    import bench
    from hslam_tpu.models.system import SLAMSystem

    n_arc = WARMUP + ARC
    t0 = time.perf_counter()
    slam = SLAMSystem(fx, fy, cx, cy, width, height, cfg, sequential=False)
    try:
        frames, gt_t = bench.make_frames(n_arc, frame_at)
        gt_by_ts = {round(i * 0.05, 4): gt_t[i] for i in range(n_arc)}
        for i in range(WARMUP):
            slam.process_frame_pipelined(frames[i], i * 0.05)
        slam.flush_pipeline()
        slam.finish()
        slam.wait_compiles()
        print(f"warmup_s {time.perf_counter() - t0:.2f} (construction, "
              f"{WARMUP} frames, all precompiles)", flush=True)

        t1 = time.perf_counter()
        for i in range(WARMUP, n_arc):
            slam.process_frame_pipelined(frames[i], i * 0.05)
        slam.flush_pipeline()
        slam.finish(wait_lc=False)
        dt = time.perf_counter() - t1
        print(f"smoke_fps {ARC / dt:.2f} ({ARC} arc frames unpaced; smoke "
              f"only, not a benchmark)", flush=True)
        ate, n_used, n_excl = bench.shells_ate(
            slam, lambda ts: gt_by_ts.get(round(ts, 4)),
            lo_ts=WARMUP * 0.05, hi_ts=(n_arc - 1) * 0.05)

        # loop-back frames, fed at the bench's 40 fps camera rate so the
        # keyframe cadence does not depend on host speed
        loop_frames, _, loop_ts = bench.make_loop_frames(n_arc, frame_at)
        t2 = time.perf_counter()
        for k, ts in enumerate(loop_ts):
            wait = t2 + k / bench.PACE_FPS - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            slam.process_frame_pipelined(loop_frames[k], ts)
        slam.flush_pipeline()
        slam.finish()
    finally:
        slam.close()

    n_valid = sum(s.pose_valid for s in slam.shells)
    check(slam.initialized and slam.next_kf_id >= 3,
          f"system initialized {slam.initialized}, keyframes "
          f"{slam.next_kf_id} (>= 3)")
    frac = n_valid / max(len(slam.shells), 1)
    check(frac >= 0.95, f"pose_valid shells {n_valid}/{len(slam.shells)} "
          f"= {frac:.3f} (>= 0.95)")
    check(np.isfinite(ate) and ate <= ATE_MAX,
          f"ATE on the arc {ate:.4f} over {n_used} shells, {n_excl} invalid "
          f"(<= {ATE_MAX})")
    check(len(slam.lc_detect_ms) >= 1,
          f"loop-closure detect queries {len(slam.lc_detect_ms)} (>= 1); "
          f"loops closed {slam.n_loops_closed}")


def run_photocal(frame_at, cfg, fx, fy, cx, cy, height, width):
    import jax
    import bench
    from hslam_tpu.models.system import SLAMSystem

    frames, exps, _ = bench.make_photocal_frames(PHOTOCAL_FRAMES, frame_at)
    s = SLAMSystem(fx, fy, cx, cy, width, height, cfg, sequential=False,
                   online_photo_calib=True, photo_calib_every=8,
                   enable_loop_closure=False)
    try:
        for i in range(PHOTOCAL_FRAMES):
            s.process_frame_pipelined(frames[i], i * 0.05, exposure=exps[i])
        s.flush_pipeline()
        s.finish()
        s.wait_compiles()
    finally:
        s.close()
    params = s._pc_params
    leaves = [np.asarray(x) for x in jax.tree.leaves(jax.device_get(params))]
    check(params is not None and all(np.all(np.isfinite(x)) for x in leaves),
          f"online photocal over {PHOTOCAL_FRAMES} frames: fitted "
          f"{params is not None}, parameters finite")


# ------------------------------------------------------------- four cards
def four_cards(devices, cfg, height, width, n_iter=6):
    import jax
    from jax.sharding import Mesh

    from __graft_entry__ import _build_ba_inputs, dryrun_multichip
    from hslam_tpu.models.optimizer import ba_optimize
    from hslam_tpu.parallel.dist_ba import sharded_ba_optimize

    from hslam_tpu.config import CPARS

    if len(devices) < 4:
        check(False, f"four-card phase on {len(devices)} device(s)")
        return
    mesh = Mesh(np.array(devices[:4]), ("points",))
    wnd, calib = _build_ba_inputs(cfg, height=height, width=width)
    # pose priors at the Hessian's own scale condition the camera solve:
    # with the weak default priors the gauge-deficient solve amplifies the
    # float32 psum-order noise (~1e-7 relative on H) to percent-level steps
    H0, _, _ = _on(devices[0], partial(_assemble, cfg=cfg), wnd, calib)
    prior = float(np.median(np.diag(H0)[CPARS:]))
    wnd = wnd._replace(frames=wnd.frames._replace(
        prior=np.full(wnd.frames.prior.shape, prior, np.float32)))
    t0 = time.perf_counter()
    one = jax.device_get(_on(devices[0], lambda w, c: ba_optimize(
        w, c, cfg, n_iter), wnd, calib))
    t1 = time.perf_counter()
    four = jax.device_get(sharded_ba_optimize(mesh, wnd, calib, cfg, n_iter))
    print(f"ba_optimize one device {t1 - t0:.2f} s, sharded on 4 devices "
          f"{time.perf_counter() - t1:.2f} s (compile included)", flush=True)
    e_rmse = abs(float(four.rmse) - float(one.rmse)) / abs(float(one.rmse))
    s1, s4 = np.asarray(one.window.frames.state), np.asarray(
        four.window.frames.state)
    e_state = float(np.linalg.norm(s4 - s1) / max(np.linalg.norm(s1), 1e-30))
    check(np.isfinite(float(four.rmse)) and e_rmse <= TOL_SHARDED_REL,
          f"sharded BA on 4 devices, {cfg.max_points} points, pose priors "
          f"{prior:.3g}: rmse "
          f"{float(four.rmse):.6f} vs one device {float(one.rmse):.6f}, rel "
          f"err {e_rmse:.3g} (tol {TOL_SHARDED_REL:g})")
    check(e_state <= TOL_SHARDED_REL,
          f"sharded BA frame states rel err {e_state:.3g} "
          f"(tol {TOL_SHARDED_REL:g})")
    t0 = time.perf_counter()
    dryrun_multichip(4)
    print(f"dryrun_multichip(4) {time.perf_counter() - t0:.2f} s", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase and its comparison")
    args = ap.parse_args(argv)

    import jax
    import hslam_tpu
    from hslam_tpu.config import Config

    devices = jax.devices()
    missing = gpu_missing(devices)
    if missing:
        print(f"FAIL {missing}", flush=True)
        return 1
    # a hang shows where it is, and fails the run inside its time limit
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    d0 = devices[0]
    print(f"device {d0.platform} {d0.device_kind} count {len(devices)} "
          f"jax {jax.__version__}", flush=True)
    print(f"nvidia-smi {nvidia_smi()}", flush=True)
    print(f"compile cache {hslam_tpu.ensure_compile_cache()}", flush=True)
    cfg = Config(max_frames=8, max_points=2048, max_immature=2048,
                 pyr_levels=PYR_LEVELS)
    if args.four_cards:
        run_phase("four_cards", four_cards, devices, cfg, H, W)
    else:
        import bench
        cpu = jax.devices("cpu")[0]
        frame_at = bench.make_renderer()
        cam = (bench.FX, bench.FY, bench.CX, bench.CY)
        with jax.default_matmul_precision("highest"):
            run_phase("parity_pyramid", parity_pyramid, d0, cpu, frame_at)
            run_phase("parity_ba", parity_ba_assembly, d0, cpu, cfg, H, W)
            run_phase("parity_track_step", parity_track_step, d0, cpu,
                      frame_at, cfg, cam, H, W)
        run_phase("system", run_system, frame_at, cfg, *cam, H, W)
        run_phase("photocal", run_photocal, frame_at, cfg, *cam, H, W)
        # the real-dataset reader and debug drawing import these lazily;
        # the synthetic main path must not need them
        extra = sorted({"cv2", "yaml"} & set(sys.modules))
        check(not extra, f"optional imports loaded by the main path: {extra}")
        peak = d0.memory_stats().get("peak_bytes_in_use")
        print(f"peak_bytes_in_use {peak}", flush=True)
    if FAILED:
        print(f"FAIL {len(FAILED)} check(s): {FAILED}", flush=True)
        return 1
    print(f"nvidia-smi {nvidia_smi()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
