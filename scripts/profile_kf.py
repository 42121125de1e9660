"""Profile the keyframe pipeline on the current backend (GPU or CPU).

The reference has no profiling story (SURVEY.md §5: wall-clock pacing
only); this is ours. Two modes, composable:

  python scripts/profile_kf.py                 # per-phase timings
  python scripts/profile_kf.py --trace /tmp/tr # + JAX profiler trace
                                               #   (perfetto .pb, open in
                                               #    ui.perfetto.dev or
                                               #    tensorboard)

Drives the REAL `SLAMSystem` on a synthetic 640x480 sequence to a warm
steady state (all kernels compiled), then times each phase of the
keyframe path separately — the fused kf_step dispatch, the tracking
step, the windowed-BA optimize inside it, the epipolar trace, the
selector, and the indirect feature extract — plus the device->host
bundle pull. This is the breakdown of the per-KF latency budget
(`HSLAM_KF_TIMING=1` gives the coarse live version inside bench.py).
"""
import argparse
import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def call_ms(fn, x0, reps=10):
    """Warm per-call time of `fn(x0)` in ms: host clock around each call
    and its block_until_ready, after one call that compiles. It includes
    the dispatch; a profiler trace (--trace) gives device time alone."""
    import jax
    jax.block_until_ready(fn(x0))
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(fn(x0))
    return (time.perf_counter() - t0) / reps * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", type=str, default=None,
                    help="write a JAX profiler trace (perfetto) here")
    ap.add_argument("--frames", type=int, default=26)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    timed = partial(call_ms, reps=args.reps)

    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.dirname(__file__))
    from bench import H, W, FX, FY, CX, CY, make_frames, make_renderer

    from hslam_tpu.config import Config
    from hslam_tpu.models.system import SLAMSystem

    print(f"backend: {jax.default_backend()}  devices: {jax.devices()}")
    frames, _ = make_frames(args.frames, make_renderer())
    cfg = Config(max_frames=8, max_points=2048, max_immature=2048,
                 pyr_levels=6)
    # pipelined warmup: the same kernel set bench.py compiles (and the
    # persistent compile cache already holds), not the sequential path's
    # separate batched-hypothesis tracker
    slam = SLAMSystem(FX, FY, CX, CY, W, H, cfg, sequential=False,
                      enable_loop_closure=False)

    print("warming up (init + compiles)...")
    t0 = time.perf_counter()
    for i, img in enumerate(frames):
        slam.process_frame_pipelined(img, i * 0.05)
    slam.flush_pipeline()
    slam.finish()
    slam.wait_compiles()
    print(f"  {len(frames)} frames in {time.perf_counter()-t0:.1f}s, "
          f"{slam.next_kf_id} KFs, initialized={slam.initialized}")
    assert slam.initialized and slam.template is not None

    img = jnp.asarray(frames[-1])
    ref_c2w = jnp.asarray(
        slam.shells[slam.ref_shell_id].cam_to_world, jnp.float32)

    rows = []
    imgf = jnp.asarray(np.asarray(frames[-1]), jnp.float32)
    pyr, grads = slam._prep(img)

    rows.append(("pyramid build (prep)",
                 timed(lambda x: slam._prep(x), imgf)))

    rows.append(("track_step (fused frame tracking)", timed(
        lambda x: slam._track_step(
            slam.template, x, slam.calib.value, ref_c2w,
            ref_c2w, ref_c2w, jnp.bool_(False), jnp.zeros(2),
            jnp.float32(1.0), jnp.float32(1.0), jnp.zeros(2),
            dt_ratio=jnp.float32(1.0)), imgf)))

    rows.append(("pixel selector", timed(
        lambda x: slam._select_px(
            slam.selector_pot, x, grads,
            int(cfg.desired_immature_density), 7), pyr[0])))

    rows.append(("indirect features (FAST+rBRIEF)", timed(
        lambda x: slam._extract_feats(x), pyr[0][..., 0])))

    Tw = np.linalg.inv(slam.shells[-1].cam_to_world)
    rows.append(("epipolar trace (all candidates)", timed(
        lambda x: slam._trace_step(
            slam.imm, slam.window.frames, slam.calib.value,
            jnp.asarray(Tw[:3, :3], jnp.float32),
            jnp.asarray(Tw[:3, 3], jnp.float32),
            jnp.zeros(2), jnp.float32(1.0), x), pyr[0])))

    wimg = slam.window.frames.images
    rows.append((f"ba_optimize ({cfg.max_opt_iterations} GN iters)", timed(
        lambda x: slam._ba(
            slam.window._replace(
                frames=slam.window.frames._replace(images=x)),
            slam.calib, jnp.int32(cfg.max_opt_iterations)), wimg)))

    rows.append(("map cloud (viewer feed)", timed(
        lambda x: slam._map_cloud(
            slam.window.frames, slam.window.points._replace(idepth=x),
            slam.calib.value), slam.window.points.idepth)))

    # the whole fused kf_step (trace + insert + activation + BA + template
    # + marginalization + new traces) as ONE dispatch, state restored after
    sel = slam._select_px(slam.selector_pot, pyr[0], grads,
                          int(cfg.desired_immature_density), 11)
    Twc = np.linalg.inv(slam.shells[-1].cam_to_world)
    F = cfg.max_frames
    free = np.flatnonzero(~np.asarray(slam.window.frames.valid))
    kf_slot = int(free[0]) if free.size else 0
    rows.append(("kf_step (whole fused KF dispatch)", timed(
        lambda x: slam._kf_step(
            slam.window, slam.calib, slam.imm, slam.feats,
            (x,) + tuple(pyr[1:]),
            jnp.asarray(Twc[:3, :3], jnp.float32),
            jnp.asarray(Twc[:3, 3], jnp.float32),
            jnp.zeros(2), jnp.float32(1.0),
            jnp.int32(kf_slot), jnp.int32(slam.next_kf_id),
            jnp.int32(slam.ref_slot),
            jnp.asarray(np.zeros(F, bool)),
            jnp.float32(slam.current_min_act_dist),
            jnp.int32(cfg.max_opt_iterations),
            sel[0], sel[1], sel[2], sel[3]), pyr[0])))

    if args.trace:
        from jax import profiler
        os.makedirs(args.trace, exist_ok=True)
        with profiler.trace(args.trace):
            for _ in range(3):
                out = slam._track_step(
                    slam.template, img, slam.calib.value, ref_c2w,
                    ref_c2w, ref_c2w, jnp.bool_(False), jnp.zeros(2),
                    jnp.float32(1.0), jnp.float32(1.0), jnp.zeros(2),
                    dt_ratio=jnp.float32(1.0))
                jax.block_until_ready(out)
                ba = slam._ba(slam.window, slam.calib, jnp.int32(6))
                jax.block_until_ready(ba)
        print(f"profiler trace written to {args.trace}")

    print(f"\nper-phase warm call timings (mean of {args.reps}, ms):")
    total = 0.0
    for name, ms in rows:
        print(f"  {name:42s} {ms:8.2f}")
        total += ms
    print(f"  {'SUM of phases':42s} {total:8.2f}")
    print("\n(bench.py with HSLAM_KF_TIMING=1 prints the live "
          "sel/dispatch/pull split per keyframe)")
    slam.close()


if __name__ == "__main__":
    main()
