"""hslam_tpu — a hybrid direct-indirect monocular SLAM framework in JAX.

A from-scratch JAX/XLA re-design of the capability set of H-SLAM
(reference: /root/reference, a DSO-style sliding-window photometric odometry
with ORB-feature-hosted candidate points, two-view indirect initialization,
and — as declared capabilities — BoW loop closure and pose-graph relaxation).

Design stance (not a port):
  * struct-of-arrays, fixed-capacity, masked state pytrees (no pointer graphs)
  * every numeric hot path is jit-compiled; batched over points/residuals
  * images live on device as (I, dx, dy) pyramids
  * multi-chip scaling via jax.sharding Mesh + shard_map/psum over point shards

Subpackages:
  utils     — Lie groups (SO3/SE3/Sim3), interpolation, robust losses
  ops       — device kernels: pyramids, undistortion, tracking, BA, epipolar
  models    — stateful subsystems: calib, frames, window BA, tracker, system
  parallel  — device meshes and sharded/distributed solvers
  io        — dataset readers (TUM-mono / EuRoC / KITTI), calib, trajectory
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# SLAM estimation is ill-conditioned (Hessians with priors up to 1e14). On
# the GPU a float32 matmul may otherwise run in TF32 (about three decimal
# digits), which destroys them: every matmul runs in full float32.
_jax.config.update("jax_default_matmul_precision", "highest")

_CHECKOUT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def compile_cache_dir(environ=None) -> str:
    """Directory of JAX's persistent compilation cache:
    $JAX_COMPILATION_CACHE_DIR when set, else `.jax_cache/` at the root of
    the checkout. The path is fixed, so every process of one checkout
    finds the executables the previous one compiled."""
    environ = _os.environ if environ is None else environ
    return (environ.get("JAX_COMPILATION_CACHE_DIR")
            or _os.path.join(_CHECKOUT, ".jax_cache"))


def ensure_compile_cache():
    """Turn the persistent compilation cache on for an accelerator backend
    and return its directory; on the CPU backend it stays off (XLA:CPU
    entries embed host CPU features and do not reload reliably) and this
    returns None.

    Called lazily (SLAMSystem construction, bench, `__graft_entry__`,
    chip_smoke.py) rather than at import: resolving the backend at import
    would break callers that must run jax.distributed.initialize() first."""
    if _jax.default_backend() == "cpu":
        return None
    cache_dir = compile_cache_dir()
    if "JAX_COMPILATION_CACHE_DIR" not in _os.environ:
        # JAX reads the variable itself when it is set
        _jax.config.update("jax_compilation_cache_dir", cache_dir)
    return cache_dir
