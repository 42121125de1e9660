"""Online photometric calibration: recover synthetic response/vignette/
exposures from tracked-point observations."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hslam_tpu.models.photo_calib import (
    PhotoParams, calibrate, gamma_lut, init_params, vignette_map,
)


def test_recovers_exposures_and_response():
    key = jax.random.PRNGKey(0)
    P, F = 200, 8

    # ground truth: gamma-style response, radial vignette, varying exposure
    def G(x):      # irradiance (0..255) -> observed
        return 255.0 * (x / 255.0) ** 0.7

    gt_log_exp = jnp.concatenate(
        [jnp.zeros(1), jax.random.uniform(key, (F - 1,), minval=-0.4, maxval=0.4)]
    )
    a2_gt = -0.3

    L = jax.random.uniform(jax.random.fold_in(key, 1), (P,), minval=30.0, maxval=220.0)
    r2 = jax.random.uniform(jax.random.fold_in(key, 2), (P, F), minval=0.0, maxval=1.0)
    V = 1.0 + a2_gt * r2
    irr = jnp.exp(gt_log_exp)[None, :] * V * L[:, None]
    obs = jnp.clip(G(jnp.clip(irr, 0.0, 255.0)), 0.0, 255.0)
    mask = (irr > 5.0) & (irr < 250.0)
    frame_idx = jnp.broadcast_to(jnp.arange(F)[None, :], (P, F))

    params = init_params(F)
    fitted, rms = calibrate(params, obs, frame_idx, r2, mask, n_iters=30)

    # the 16-knot piecewise-linear U leaves a small discretization floor at
    # the steep dark end of the log response; exposures/vignette are exact
    assert float(rms) < 0.08, f"residual rms {rms}"
    # with UNKNOWN exposures the problem has a 1-parameter log-gauge alpha
    # (U' = a U + b fits equally with log e' = a log e, log V' = a log V, the
    # classic gamma ambiguity); the smoothness prior picks an arbitrary
    # alpha, so exposures and vignette are recovered up to ONE consistent
    # alpha (pass exposure telemetry via exp_known to pin it — covered by
    # test_online_calibration_in_live_system).
    est = np.asarray(fitted.log_exp)
    est = est - est[0]
    gt = np.asarray(gt_log_exp)
    corr = np.corrcoef(est, gt)[0, 1]
    alpha = np.polyfit(gt, est, 1)[0]
    assert corr > 0.99, f"exposure correlation {corr}"
    assert 0.1 < alpha < 10.0, f"exposure gauge {alpha}"
    # vignette coefficient scales with the same alpha (log V' = alpha log V)
    a2_est = float(fitted.vig[0])
    assert abs(a2_est - alpha * a2_gt) < 0.3 * abs(alpha * a2_gt) + 0.05, (
        a2_est, alpha * a2_gt)

    lut = np.asarray(gamma_lut(fitted))
    assert lut.shape == (256,)
    assert (np.diff(lut) >= -1e-3).all(), "response LUT must be monotone"

    vm = np.asarray(vignette_map(fitted, 24, 32))
    assert vm.shape == (24, 32)
    # vignette darker at corners than center for a2 < 0
    assert vm[12, 16] > vm[0, 0]


@pytest.mark.slow
def test_online_calibration_in_live_system():
    """Online calibration end to end: run the LIVE system on a synthetic
    sequence whose raw frames carry a ground-truth gamma + vignette; the
    online calibrator must produce a monotone response estimate whose
    inverse de-gammas better than identity, and the system must keep
    tracking (bounded ATE)."""
    import sys as _sys, os as _os
    _sys.path.insert(0, _os.path.dirname(__file__))
    from test_system import make_texture, render, H, W, FX, FY, CX, CY
    from hslam_tpu.config import Config
    from hslam_tpu.models.system import SLAMSystem
    from hslam_tpu.utils import lie
    from hslam_tpu.io.trajectory import ate_rmse

    cfg = Config(
        max_frames=6, max_points=512, max_immature=512, max_features=512,
        pyr_levels=3, init_min_matches=50, init_ransac_iters=100,
        desired_point_density=400.0, desired_immature_density=300.0,
        tracker_iters_per_level=(6, 10, 10),
    )
    slam = SLAMSystem(FX, FY, CX, CY, W, H, cfg,
                      online_photo_calib=True, photo_calib_every=6)
    I0 = make_texture()

    # ground-truth photometric distortion
    gamma = 0.7
    ys, xs = np.mgrid[0:H, 0:W]
    ccx, ccy = (W - 1) / 2.0, (H - 1) / 2.0
    r2 = ((xs - ccx) ** 2 + (ys - ccy) ** 2) / (ccx * ccx + ccy * ccy)
    vig = 1.0 - 0.30 * r2

    gt = []
    for i in range(20):
        t = i / 10.0
        xi = jnp.array(
            [0.5 * np.sin(0.3 * t), 0.3 * (1 - np.cos(0.35 * t)),
             0.15 * np.sin(0.2 * t),
             0.03 * np.sin(0.25 * t), 0.03 * (1 - np.cos(0.2 * t)), 0.02 * t]
        )
        R, tt = lie.se3_exp(xi)
        gt.append((np.asarray(R), np.asarray(tt)))
        clean = np.asarray(render(I0, R, tt))
        exposure = 1.0 + 0.15 * np.sin(0.9 * i)         # flicker
        raw = 255.0 * np.clip(vig * exposure * clean / 255.0, 0, 1) ** gamma
        # exposure telemetry is passed through (TUM-MonoVO ships exposure
        # times; pinning log-exposures breaks the response-scale gauge)
        slam.process_frame(raw.astype(np.float32), t, exposure=exposure)
        assert not slam.is_lost, f"lost at frame {i}"

    assert slam.initialized
    assert slam._inv_response is not None, "calibrator never ran"
    assert np.isfinite(float(jax.device_get(slam._pc_rms)))

    # estimated inverse response must de-gamma: applying it to G(x)=x^0.7
    # should be closer to linear than doing nothing
    from hslam_tpu.models.photo_calib import gamma_lut
    lut = np.asarray(gamma_lut(slam._pc_params))        # estimated G
    xs256 = np.arange(256.0)
    gt_G = 255.0 * (xs256 / 255.0) ** gamma
    err_est = np.sqrt(np.mean((lut - gt_G) ** 2))
    err_identity = np.sqrt(np.mean((xs256 - gt_G) ** 2))
    assert err_est < 0.6 * err_identity, (
        f"response fit rmse {err_est:.1f} vs identity {err_identity:.1f}")
    assert (np.diff(lut) >= -1e-3).all()

    # vignette estimate must darken corners
    vm = np.asarray(
        __import__("hslam_tpu.models.photo_calib", fromlist=["vignette_map"])
        .vignette_map(slam._pc_params, H, W))
    assert vm[H // 2, W // 2] > vm[0, 0], "vignette corners not darker"

    est, gtp = [], []
    for s in slam.shells:
        Tcw = np.eye(4)
        Tcw[:3, :3], Tcw[:3, 3] = gt[s.id]
        gtp.append(np.linalg.inv(Tcw)[:3, 3])
        est.append(s.cam_to_world[:3, 3])
    err = ate_rmse(np.array(gtp), np.array(est))
    assert np.isfinite(err) and err < 0.2, f"ATE too high: {err}"


@pytest.mark.slow
def test_online_calibration_improves_ate():
    """The capability's core claim, locked in as a regression gate: on a
    sequence whose raw frames carry unmodeled gamma + vignette + exposure
    flicker, running WITH the online calibrator must beat running WITHOUT
    it (calibrated r5: 0.009 vs 0.031 — the first-fit window re-sync plus
    vignette regularization are what make this hold; before them the
    calibrated run was WORSE, 0.037 vs 0.032)."""
    import sys as _sys, os as _os
    _sys.path.insert(0, _os.path.dirname(__file__))
    from test_system import make_texture, render, H, W, FX, FY, CX, CY
    from hslam_tpu.config import Config
    from hslam_tpu.models.system import SLAMSystem
    from hslam_tpu.utils import lie
    from hslam_tpu.io.trajectory import ate_rmse

    N = 60
    ys, xs = np.mgrid[0:H, 0:W]
    ccx, ccy = (W - 1) / 2.0, (H - 1) / 2.0
    r2 = ((xs - ccx) ** 2 + (ys - ccy) ** 2) / (ccx * ccx + ccy * ccy)
    vig = 1.0 - 0.45 * r2
    I0 = make_texture()
    frames, exps, gts = [], [], []
    for i in range(N):
        t = i * 0.05
        xi = jnp.array([0.35 * np.sin(0.25 * t), 0.22 * (1 - np.cos(0.3 * t)),
                        0.10 * np.sin(0.17 * t), 0.02 * np.sin(0.2 * t),
                        0.02 * (1 - np.cos(0.15 * t)), 0.01 * t])
        R, tt = lie.se3_exp(xi)
        clean = render(I0, R, tt)
        exp = 1.0 + 0.35 * np.sin(0.45 * i)
        raw = 255.0 * np.clip(exp * vig * clean / 255.0, 0, 1) ** 0.7
        frames.append(np.clip(np.round(raw), 0, 255).astype(np.uint8))
        exps.append(exp)
        gts.append(np.asarray(tt, np.float64))
    gts = np.stack(gts)

    cfg = Config(max_frames=6, max_points=512, max_immature=512,
                 max_features=512, pyr_levels=3, init_min_matches=50,
                 init_ransac_iters=100, desired_point_density=400.0,
                 desired_immature_density=300.0,
                 tracker_iters_per_level=(6, 10, 10))

    def run(enable):
        slam = SLAMSystem(FX, FY, CX, CY, W, H, cfg,
                          online_photo_calib=enable, photo_calib_every=8,
                          enable_loop_closure=False)
        for i in range(N):
            slam.process_frame(frames[i], i * 0.05, exposure=exps[i])
        slam.finish()
        assert slam.initialized
        est, gtt = [], []
        for s in slam.shells:
            if s.pose_valid:
                est.append(s.cam_to_world[:3, 3])
                gtt.append(gts[s.id])
        a = ate_rmse(np.array(gtt), np.array(est))
        slam.close()
        return a

    ate_off = run(False)
    ate_on = run(True)
    # calibrated margins: 0.0087 vs 0.0306; gate at "no worse than 0.8x"
    # so run-to-run noise cannot flip it while a real regression (the
    # with-run merely TYING the without-run) still fails
    assert ate_on < 0.8 * ate_off, (
        f"online calibration no longer improves ATE: {ate_on:.4f} with vs "
        f"{ate_off:.4f} without")


def test_pipelined_path_matches_sequential_pyramids():
    """Round-3 gap: the pipelined tracking path applied intensity
    correction only, skipping the gamma gradient-reweighting the
    sequential path applies (Frame.cpp:158-164). Both entry points must
    now produce the SAME corrected pyramids + gradient maps: the
    sequential `prep_calibrated` vs the fused `track_step_cal` dispatch."""
    from hslam_tpu.models.system import SLAMSystem
    from hslam_tpu.config import Config
    from hslam_tpu.ops import tracker as trk_ops

    H_, W_ = 64, 96
    cfg = Config(max_frames=4, max_points=64, max_immature=64,
                 max_features=64, pyr_levels=3)
    slam = SLAMSystem(80.0, 80.0, W_ / 2 - 0.5, H_ / 2 - 0.5, W_, H_, cfg,
                      online_photo_calib=True, enable_loop_closure=False)

    key = jax.random.PRNGKey(5)
    raw = jax.random.uniform(key, (H_, W_), minval=10.0, maxval=245.0)
    # synthetic calibration state: nonlinear inverse response, radial
    # inverse vignette, and its gradient reweighting LUT
    x = jnp.arange(256, dtype=jnp.float32)
    inv_resp = 255.0 * (x / 255.0) ** 1.4
    ys, xs = jnp.mgrid[0:H_, 0:W_]
    r2 = (((xs - W_ / 2) ** 2 + (ys - H_ / 2) ** 2)
          / ((W_ / 2) ** 2 + (H_ / 2) ** 2))
    inv_vig = (1.0 / (1.0 - 0.3 * r2)).astype(jnp.float32)
    grad_w = (0.5 + x / 510.0).astype(jnp.float32)

    # sequential entry point
    pyr_s, grads_s = slam._prep_calibrated(raw, inv_resp, inv_vig, grad_w)

    # pipelined entry point (fused correction + pyramid + tracking)
    pts = 32
    tpl = trk_ops.build_template(
        jnp.linspace(5, W_ - 5, pts), jnp.linspace(5, H_ - 5, pts),
        jnp.full(pts, 0.5), jnp.ones(pts), jnp.ones(pts, bool), pyr_s,
    )
    eye = jnp.eye(4, dtype=jnp.float32)
    out = slam._track_step_cal(
        tpl, raw, inv_resp, inv_vig, grad_w, slam.calib.value,
        eye, eye, eye, jnp.bool_(False), jnp.zeros(2),
        jnp.float32(1.0), jnp.float32(1.0), jnp.zeros(2))

    for a, b in zip(pyr_s, out.pyr):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-4)
    for a, b in zip(grads_s, out.grads):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-4)
    # and the gamma reweighting must actually bite (differ from unweighted)
    pyr_u, grads_u = slam._prep_calibrated(
        raw, inv_resp, inv_vig, jnp.ones(256))
    assert float(jnp.max(jnp.abs(grads_u[0] - grads_s[0]))) > 1e-3
    slam.close()
