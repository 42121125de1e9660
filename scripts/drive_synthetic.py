"""Drive the framework end-to-end on synthetic data through the public API.

Usage:
    JAX_PLATFORMS=cpu python scripts/drive_synthetic.py   # CPU (fast check)
    python scripts/drive_synthetic.py                      # the GPU

Builds a synthetic two-frame scene (textured fronto-parallel plane), then:
  1. builds direct pyramids,
  2. builds a tracking template and runs the coarse tracker from a perturbed
     initial pose -> reports pose error before/after,
  3. runs one windowed-BA optimize on a 4-frame window -> reports RMSE.
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from hslam_tpu.config import Config
from hslam_tpu.models import window as W
from hslam_tpu.models.calib import make_calib, level_intrinsics
from hslam_tpu.ops import tracker as trk
from hslam_tpu.ops.pyramid import build_direct_pyramid, image_gradients
from hslam_tpu.utils import lie
from hslam_tpu.utils.interp import bilinear

H, Wd = 240, 320
FX = FY = 150.0
CX, CY = Wd / 2 - 0.5, H / 2 - 0.5
DEPTH = 2.0


def smooth_image(key, h, w):
    ky, kx = jax.random.uniform(key, (2, 6), minval=0.5, maxval=4.5)
    phases = jax.random.uniform(jax.random.fold_in(key, 1), (6,)) * 6.28
    amps = jnp.array([40.0, 30.0, 20.0, 15.0, 10.0, 8.0])
    ys, xs = jnp.mgrid[0:h, 0:w]
    img = 120.0 + sum(
        amps[i] * jnp.sin(2 * jnp.pi * (kx[i] * xs / w + ky[i] * ys / h) + phases[i])
        for i in range(6)
    )
    return img.astype(jnp.float32)


def render(I0, Rf, tf):
    ys, xs = jnp.mgrid[0:H, 0:Wd]
    px = (xs - CX) / FX
    py = (ys - CY) / FY
    Rinv, tinv = lie.se3_inverse(Rf, tf)
    dz = Rinv[2, 0] * px + Rinv[2, 1] * py + Rinv[2, 2]
    s = (DEPTH - tinv[2]) / dz
    X = s * (Rinv[0, 0] * px + Rinv[0, 1] * py + Rinv[0, 2]) + tinv[0]
    Y = s * (Rinv[1, 0] * px + Rinv[1, 1] * py + Rinv[1, 2]) + tinv[1]
    u0 = FX * X / DEPTH + CX
    v0 = FY * Y / DEPTH + CY
    return bilinear(I0, u0, v0)


def main():
    print(f"devices: {jax.devices()}")
    cfg = Config(max_frames=4, max_points=512, pyr_levels=4)
    calib = make_calib(FX, FY, CX, CY, Wd, H)

    I0 = smooth_image(jax.random.PRNGKey(7), H, Wd)

    # ground-truth relative pose frame0 -> frame1
    xi_gt = jnp.array([0.06, -0.03, 0.02, 0.01, -0.008, 0.004])
    R_gt, t_gt = lie.se3_exp(xi_gt)
    I1 = render(I0, R_gt, t_gt)

    t0 = time.time()
    pyr0, _ = build_direct_pyramid(I0, cfg.pyr_levels)
    pyr1, _ = build_direct_pyramid(I1, cfg.pyr_levels)
    jax.block_until_ready(pyr1)
    print(f"[1] pyramids built in {time.time()-t0:.2f}s; "
          f"levels: {[p.shape for p in pyr0]}")

    # --- tracker: template from dense plane depth in frame 0
    P = cfg.max_points
    key = jax.random.PRNGKey(0)
    u = jax.random.uniform(key, (P,), minval=5.0, maxval=Wd - 5.0)
    v = jax.random.uniform(jax.random.fold_in(key, 1), (P,), minval=5.0, maxval=H - 5.0)
    tmpl = trk.build_template(
        u, v,
        idepth=jnp.full(P, 1.0 / DEPTH),
        weight=jnp.ones(P),
        point_valid=jnp.ones(P, bool),
        ref_pyr=pyr0,
    )
    K_pyr = jnp.stack([level_intrinsics(calib, l) for l in range(cfg.pyr_levels)])

    t0 = time.time()
    track_fn = jax.jit(
        lambda R, t: trk.track_coarse(
            tmpl, pyr1, K_pyr,
            R, t, jnp.zeros(2),
            jnp.float32(1.0), jnp.float32(1.0), jnp.zeros(2), cfg,
        )
    )
    res = track_fn(jnp.eye(3), jnp.zeros(3))
    jax.block_until_ready(res.t)
    t_compile = time.time() - t0
    t0 = time.time()
    res = track_fn(jnp.eye(3), jnp.zeros(3))
    jax.block_until_ready(res.t)
    t_run = time.time() - t0

    err0 = float(jnp.linalg.norm(xi_gt))
    dR, dt = lie.se3_mul(res.R, res.t, *lie.se3_inverse(R_gt, t_gt))
    err1 = float(jnp.linalg.norm(lie.se3_log(dR, dt)))
    print(f"[2] tracker: pose error {err0:.4f} -> {err1:.6f} "
          f"(ok={bool(res.ok)}, rmse L0={float(res.residuals[0]):.2f}), "
          f"compile {t_compile:.1f}s run {t_run*1000:.1f}ms")
    assert err1 < 0.1 * err0, "tracker did not converge"

    # --- windowed BA on a 4-frame window
    from hslam_tpu.models.optimizer import ba_optimize
    from hslam_tpu.config import PATTERN

    F = cfg.max_frames
    xi = jnp.stack([
        jnp.zeros(6),
        xi_gt,
        jnp.array([-0.05, 0.02, 0.01, -0.006, 0.004, 0.01]),
        jnp.array([0.02, 0.06, -0.02, 0.004, 0.01, -0.006]),
    ])
    R_all, t_all = lie.se3_exp(xi)
    images = []
    for f in range(F):
        If = render(I0, R_all[f], t_all[f])
        dx, dy = image_gradients(If)
        images.append(jnp.stack([If, dx, dy], axis=-1))
    images = jnp.stack(images)

    wnd = W.empty_window(cfg, H, Wd)
    frames = wnd.frames._replace(
        valid=jnp.ones(F, bool),
        evalpt_R=R_all, evalpt_t=t_all,
        kf_id=jnp.arange(F, dtype=jnp.int32),
        images=images,
        prior=jnp.stack([jnp.asarray(W.first_frame_prior(cfg))]
                        + [jnp.asarray(W.later_frame_prior(cfg))] * (F - 1)),
    )
    pert = jax.random.normal(jax.random.PRNGKey(3), (F, 8)) * jnp.array(
        [0.01] * 3 + [0.005] * 3 + [0.0, 0.0])
    pert = pert.at[0].set(0.0)
    frames = frames._replace(state=pert.astype(jnp.float32))

    pat = jnp.asarray(PATTERN, jnp.float32)
    up = u[:, None] + pat[None, :, 0]
    vp = v[:, None] + pat[None, :, 1]
    points = wnd.points._replace(
        status=jnp.ones(P, jnp.int32),
        host=jnp.zeros(P, jnp.int32),
        u=u, v=v,
        idepth=jnp.full(P, 1.0 / DEPTH),
        idepth_zero=jnp.full(P, 1.0 / DEPTH),
        color=bilinear(images[0, :, :, 0], up, vp),
        weight=jnp.ones((P, 8)),
    )
    wnd = W.Window(frames=frames, points=points, HM=wnd.HM, bM=wnd.bM)

    t0 = time.time()
    ba_fn = jax.jit(lambda w, c: ba_optimize(w, c, cfg, 6))
    out = ba_fn(wnd, calib)
    jax.block_until_ready(out.rmse)
    t_compile = time.time() - t0
    t0 = time.time()
    out = ba_fn(wnd, calib)
    jax.block_until_ready(out.rmse)
    t_run = time.time() - t0
    print(f"[3] BA: rmse={float(out.rmse):.3f}, "
          f"state norm before={float(jnp.linalg.norm(pert)):.4f} "
          f"after(delta vs evalPT)={float(jnp.linalg.norm(out.window.frames.state[:, :6])):.4f}, "
          f"compile {t_compile:.1f}s run {t_run*1000:.1f}ms")
    assert np.isfinite(float(out.rmse)), "BA produced non-finite energy"
    print("DRIVE OK")


if __name__ == "__main__":
    main()
