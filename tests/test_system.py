"""End-to-end system test: run the full SLAM pipeline on a small synthetic
sequence (textured plane, smooth camera arc) and check it initializes,
tracks, makes keyframes, and keeps trajectory error bounded."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hslam_tpu.config import Config
from hslam_tpu.utils import lie
from hslam_tpu.utils.interp import bilinear

H, W = 96, 128
FX = FY = 80.0
CX, CY = W / 2 - 0.5, H / 2 - 0.5
DEPTH = 2.0


def make_texture():
    key = jax.random.PRNGKey(3)
    ky, kx = jax.random.uniform(key, (2, 8), minval=0.5, maxval=6.5)
    ph = jax.random.uniform(jax.random.fold_in(key, 1), (8,)) * 6.28
    amps = jnp.array([35.0, 30.0, 22.0, 18.0, 14.0, 10.0, 8.0, 6.0])
    ys, xs = jnp.mgrid[0:H, 0:W]
    I0 = 120.0 + sum(
        amps[i] * jnp.sin(2 * jnp.pi * (kx[i] * xs / W + ky[i] * ys / H) + ph[i])
        for i in range(8)
    )
    return I0.astype(jnp.float32)


def render(I0, Rf, tf):
    ys, xs = jnp.mgrid[0:H, 0:W]
    px = (xs - CX) / FX
    py = (ys - CY) / FY
    Rinv, tinv = lie.se3_inverse(Rf, tf)
    dz = Rinv[2, 0] * px + Rinv[2, 1] * py + Rinv[2, 2]
    s = (DEPTH - tinv[2]) / dz
    X = s * (Rinv[0, 0] * px + Rinv[0, 1] * py + Rinv[0, 2]) + tinv[0]
    Y = s * (Rinv[1, 0] * px + Rinv[1, 1] * py + Rinv[1, 2]) + tinv[1]
    u0 = FX * X / DEPTH + CX
    v0 = FY * Y / DEPTH + CY
    return np.asarray(bilinear(I0, u0, v0))


@pytest.mark.slow
def test_end_to_end_synthetic():
    from hslam_tpu.models.system import SLAMSystem

    cfg = Config(
        max_frames=6, max_points=512, max_immature=512, max_features=512,
        pyr_levels=3, init_min_matches=50, init_ransac_iters=100,
        desired_point_density=400.0, desired_immature_density=300.0,
        tracker_iters_per_level=(6, 10, 10),
    )
    slam = SLAMSystem(FX, FY, CX, CY, W, H, cfg)
    I0 = make_texture()

    n_frames = 20
    gt = []
    for i in range(n_frames):
        t = i / 10.0
        xi = jnp.array(
            [0.35 * np.sin(0.5 * t), 0.18 * (1 - np.cos(0.5 * t)), 0.05 * t,
             0.015 * np.sin(0.4 * t), 0.025 * t, 0.01 * np.sin(0.3 * t)]
        )
        R, tt = lie.se3_exp(xi)
        gt.append((np.asarray(R), np.asarray(tt)))
        img = render(I0, R, tt)
        slam.process_frame(img, i / 10.0)
        assert not slam.is_lost, f"lost at frame {i}"

    assert slam.initialized, "system failed to initialize"
    assert slam.next_kf_id >= 2, "no keyframes created"

    # trajectory error: sim3-aligned ATE must be small vs scene depth 2.0
    from hslam_tpu.io.trajectory import ate_rmse

    est, gtp = [], []
    for s in slam.shells:
        if s.pose_valid and s.tracking_ref is not None or s.is_kf:
            Tcw = np.eye(4)
            Tcw[:3, :3], Tcw[:3, 3] = gt[s.id]
            gtp.append(np.linalg.inv(Tcw)[:3, 3])
            est.append(s.cam_to_world[:3, 3])
    assert len(est) >= 10
    err = ate_rmse(np.array(gtp), np.array(est))
    assert np.isfinite(err)
    assert err < 0.15, f"ATE too high: {err}"


def test_metrics_stream(tmp_path):
    """metrics_path produces a JSONL stream with per-frame and per-keyframe
    records (the structured observability layer, SURVEY.md §5)."""
    import json
    from hslam_tpu.models.system import SLAMSystem

    cfg = Config(
        max_frames=6, max_points=512, max_immature=512, max_features=512,
        pyr_levels=3, init_min_matches=50, init_ransac_iters=100,
        desired_point_density=400.0, desired_immature_density=300.0,
        tracker_iters_per_level=(6, 10, 10),
    )
    path = str(tmp_path / "metrics.jsonl")
    slam = SLAMSystem(FX, FY, CX, CY, W, H, cfg, metrics_path=path)
    I0 = make_texture()
    for i in range(12):
        t = i / 10.0
        xi = jnp.array(
            [0.35 * np.sin(0.5 * t), 0.18 * (1 - np.cos(0.5 * t)), 0.05 * t,
             0.015 * np.sin(0.4 * t), 0.025 * t, 0.01 * np.sin(0.3 * t)])
        R, tt = lie.se3_exp(xi)
        slam.process_frame(render(I0, R, tt), t)
    slam.close()
    recs = [json.loads(ln) for ln in open(path)]
    frames = [r for r in recs if r["t"] == "frame"]
    kfs = [r for r in recs if r["t"] == "kf"]
    maps = [r for r in recs if r["t"] == "map"]
    assert len(frames) >= 5 and len(kfs) >= 1
    assert {"id", "ts", "rmse", "pose_valid"} <= set(frames[0])
    assert {"kf_id", "ba_rmse", "n_active", "latency_ms"} <= set(kfs[0])
    assert all(np.isfinite(r["rmse"]) for r in frames)
    # live-3D-map feed: every keyframe carries a map record with a world
    # point cloud ([x, y, z, intensity]) + window KF poses for frusta
    assert len(maps) == len(kfs)
    m = maps[-1]
    assert {"kf_id", "pts", "kfs"} <= set(m)
    assert len(m["pts"]) > 10 and len(m["pts"][0]) == 4
    assert all(np.isfinite(p).all() for p in np.asarray(m["pts"]))
    assert len(m["kfs"]) >= 1
    assert {"kf", "R", "t"} <= set(m["kfs"][0])
    assert len(m["kfs"][0]["R"]) == 9 and len(m["kfs"][0]["t"]) == 3
    # the cloud must sit in front of the map at sane depths (scene z~2)
    z = np.asarray(m["pts"])[:, 2]
    assert (np.abs(z) < 50).all()


def test_fast_detector_path():
    """cfg.use_fast selects FAST+NMS keypoints as the candidate source."""
    import jax.numpy as jnp
    from hslam_tpu.models.system import SLAMSystem

    cfg = Config(
        max_frames=4, max_points=128, max_immature=128, max_features=128,
        pyr_levels=3, use_fast=True,
    )
    slam = SLAMSystem(FX, FY, CX, CY, W, H, cfg)
    I0 = make_texture()
    pyr, grads = slam._prep(jnp.asarray(I0))
    u, v, ptype, valid = slam._select_px(5, pyr[0], grads, 100, 0)
    n = int(valid.sum())
    assert n > 20, f"FAST path found only {n} keypoints"
    # all keypoints inside the image
    import numpy as np
    uu = np.asarray(u[valid])
    vv = np.asarray(v[valid])
    assert (uu >= 0).all() and (uu < W).all()
    assert (vv >= 0).all() and (vv < H).all()


@pytest.mark.slow
def test_hybrid_beats_direct_under_gamma_flicker():
    """The hybrid indirect layer (matched-keypoint reprojection factors in
    the window BA — the reference's declared direct+indirect capability)
    must (a) create live indirect observations and (b) beat direct-only ATE
    on a scene with unmodeled nonlinear gamma flicker + sensor noise, which
    the affine brightness model cannot absorb. Deterministic on the CPU
    mesh (fixed seeds), measured gap hybrid 0.0182 vs direct 0.0239."""
    from hslam_tpu.models.system import SLAMSystem
    from hslam_tpu.io.trajectory import ate_rmse

    base = dict(
        max_frames=6, max_points=512, max_immature=512, max_features=512,
        pyr_levels=3, init_min_matches=50, init_ransac_iters=100,
        desired_point_density=400.0, desired_immature_density=300.0,
        tracker_iters_per_level=(6, 10, 10),
    )
    I0 = make_texture()
    gammas = [1.0 + 0.35 * np.sin(1.7 * i) for i in range(24)]

    def run(cfg, noise=8.0):
        slam = SLAMSystem(FX, FY, CX, CY, W, H, cfg)
        gt = []
        r2 = np.random.RandomState(7)
        for i in range(24):
            t = i / 10.0
            xi = jnp.array(
                [0.35 * np.sin(0.5 * t), 0.18 * (1 - np.cos(0.5 * t)),
                 0.05 * t,
                 0.015 * np.sin(0.4 * t), 0.025 * t, 0.01 * np.sin(0.3 * t)]
            )
            R, tt = lie.se3_exp(xi)
            gt.append((np.asarray(R), np.asarray(tt)))
            img = render(I0, R, tt)
            img = (255.0 * np.clip(img / 255.0, 0, 1) ** gammas[i]
                   + r2.randn(*img.shape) * noise)
            slam.process_frame(np.clip(img, 0, 255), t)
        est, gtp = [], []
        for s in slam.shells:
            Tcw = np.eye(4)
            Tcw[:3, :3], Tcw[:3, 3] = gt[s.id]
            gtp.append(np.linalg.inv(Tcw)[:3, 3])
            est.append(s.cam_to_world[:3, 3])
        return ate_rmse(np.array(gtp), np.array(est)), slam.ind_obs_history

    ate_hybrid, obs = run(Config(**base))
    ate_direct, _ = run(Config(**base, enable_indirect=False))
    assert sum(obs) > 0, "hybrid layer created no indirect observations"
    assert obs[-1] >= 10, f"too few live indirect obs at the end: {obs}"
    assert np.isfinite(ate_hybrid) and ate_hybrid < 0.035, ate_hybrid
    assert ate_hybrid < ate_direct, (
        f"hybrid {ate_hybrid} did not beat direct {ate_direct}")


@pytest.mark.slow
def test_tracking_loss_triggers_relocalization():
    """Kidnapped-camera recovery: after initialization, the camera teleports
    (large pose jump outside the direct tracker's basin) with a simultaneous
    4x exposure change (outside the affine model's sanity bound,
    CoarseTracker.cpp:667-675 semantics) — every motion hypothesis is
    rejected, and the BoW/PnP relocalizer (_attempt_relocalization, a
    capability beyond the reference's "hope to recover" fallback,
    System.cpp:483-489) must recover the pose, force a re-anchoring
    keyframe, and resume tracking."""
    from hslam_tpu.models.system import SLAMSystem
    from hslam_tpu.io.trajectory import ate_rmse

    cfg = Config(
        max_frames=6, max_points=512, max_immature=512, max_features=512,
        pyr_levels=3, init_min_matches=50, init_ransac_iters=100,
        desired_point_density=400.0, desired_immature_density=300.0,
        tracker_iters_per_level=(6, 10, 10),
    )
    slam = SLAMSystem(FX, FY, CX, CY, W, H, cfg)
    I0 = make_texture()

    def pose(i):
        t = i / 10.0
        xi = jnp.array(
            [0.35 * np.sin(0.5 * t), 0.18 * (1 - np.cos(0.5 * t)), 0.05 * t,
             0.015 * np.sin(0.4 * t), 0.025 * t, 0.01 * np.sin(0.3 * t)])
        return lie.se3_exp(xi)

    gt_all, est_all = [], []
    for i in range(15):
        R, tt = pose(i)
        slam.process_frame(render(I0, R, tt), i / 10.0)
        Tcw = np.eye(4)
        Tcw[:3, :3], Tcw[:3, 3] = np.asarray(R), np.asarray(tt)
        gt_all.append(np.linalg.inv(Tcw))
        est_all.append(slam.shells[-1].cam_to_world.copy())
    assert slam.initialized and slam.n_relocs == 0

    # kidnap: persistent pose offset + 4x gain from frame 15 on
    for i in range(15, 26):
        dR, dt = lie.se3_exp(jnp.array([0.5, 0.25, 0.0, 0.0, 0.15, 0.0]))
        R0, t0 = pose(i)
        R = np.asarray(dR) @ np.asarray(R0)
        tt = np.asarray(dR) @ np.asarray(t0) + np.asarray(dt)
        img = render(I0, jnp.asarray(R), jnp.asarray(tt)) * 4.0
        slam.process_frame(img, i / 10.0)
        Tcw = np.eye(4)
        Tcw[:3, :3], Tcw[:3, 3] = R, tt
        gt_all.append(np.linalg.inv(Tcw))
        est_all.append(slam.shells[-1].cam_to_world.copy())

    assert slam.n_relocs >= 1, "relocalization never triggered"
    assert not slam.is_lost
    # tracking resumed: the tail frames have valid tracked poses
    assert all(s.pose_valid for s in slam.shells[-5:])
    err_full = ate_rmse(np.array([g[:3, 3] for g in gt_all]),
                        np.array([e[:3, 3] for e in est_all]))
    err_post = ate_rmse(np.array([g[:3, 3] for g in gt_all[17:]]),
                        np.array([e[:3, 3] for e in est_all[17:]]))
    assert np.isfinite(err_full) and err_full < 0.15, err_full
    assert err_post < 0.08, err_post


@pytest.mark.slow
def test_large_loop_correction_keeps_ba_stable():
    """Weak spot flagged in round 1: after a LARGE pose-graph correction the
    marginalization prior HM/bM must stay consistent with the window's moved
    linearization points. The window re-anchor applies one common gauge
    transform (system._apply_loop_correction), which preserves all relative
    poses exactly — so BA must keep converging afterwards with no ATE blowup."""
    from hslam_tpu.models.system import SLAMSystem
    from hslam_tpu.io.trajectory import ate_rmse

    cfg = Config(
        max_frames=6, max_points=512, max_immature=512, max_features=512,
        pyr_levels=3, init_min_matches=50, init_ransac_iters=100,
        desired_point_density=400.0, desired_immature_density=300.0,
        tracker_iters_per_level=(6, 10, 10),
    )
    slam = SLAMSystem(FX, FY, CX, CY, W, H, cfg)
    I0 = make_texture()

    def pose(i):
        t = i / 10.0
        xi = jnp.array(
            [0.35 * np.sin(0.5 * t), 0.18 * (1 - np.cos(0.5 * t)), 0.05 * t,
             0.015 * np.sin(0.4 * t), 0.025 * t, 0.01 * np.sin(0.3 * t)])
        return lie.se3_exp(xi)

    gt_all = []
    for i in range(15):
        R, tt = pose(i)
        gt_all.append((np.asarray(R), np.asarray(tt)))
        slam.process_frame(render(I0, R, tt), i / 10.0)
    assert slam.initialized
    kfs_before = slam.next_kf_id

    # a LARGE simulated pose-graph correction: 25 deg + |t| ~ 1.0 applied to
    # every shell (the window re-anchor path must keep HM/bM consistent)
    Rg, tg = lie.se3_exp(jnp.array([0.8, -0.5, 0.3, 0.25, -0.3, 0.2]))
    G = np.eye(4)
    G[:3, :3], G[:3, 3] = np.asarray(Rg), np.asarray(tg)
    by_shell = {sh.id: G @ sh.cam_to_world for sh in slam.shells if sh.is_kf}
    slam._apply_loop_correction(by_shell)

    for i in range(15, 28):
        R, tt = pose(i)
        gt_all.append((np.asarray(R), np.asarray(tt)))
        slam.process_frame(render(I0, R, tt), i / 10.0)
        assert not slam.is_lost, f"lost at {i} after large correction"
    assert slam.next_kf_id > kfs_before, "no keyframes after correction"

    est, gtp = [], []
    for s in slam.shells:
        Tcw = np.eye(4)
        Tcw[:3, :3], Tcw[:3, 3] = gt_all[s.id]
        gtp.append(np.linalg.inv(Tcw)[:3, 3])
        est.append(s.cam_to_world[:3, 3])
        assert np.isfinite(s.cam_to_world).all()
    # sim3 alignment absorbs the (consistent) global re-gauge: ATE must stay
    # at clean-run levels, proving BA didn't fight an inconsistent prior
    err = ate_rmse(np.array(gtp), np.array(est))
    assert np.isfinite(err) and err < 0.15, err


@pytest.mark.slow
def test_end_to_end_pipelined_async():
    """Same scene through the lag-1 pipelined tracker + async mapping
    thread (process_frame_pipelined, sequential=False): device-side motion
    hypotheses, batched coarsest-level scoring, one dispatch per frame,
    double-buffered tracker-reference swap."""
    from hslam_tpu.models.system import SLAMSystem

    cfg = Config(
        max_frames=6, max_points=512, max_immature=512, max_features=512,
        pyr_levels=3, init_min_matches=50, init_ransac_iters=100,
        desired_point_density=400.0, desired_immature_density=300.0,
        tracker_iters_per_level=(6, 10, 10),
    )
    slam = SLAMSystem(FX, FY, CX, CY, W, H, cfg, sequential=False)
    I0 = make_texture()
    gt = []
    try:
        for i in range(20):
            t = i / 10.0
            xi = jnp.array(
                [0.5 * np.sin(0.3 * t), 0.3 * (1 - np.cos(0.35 * t)),
                 0.15 * np.sin(0.2 * t),
                 0.03 * np.sin(0.25 * t), 0.03 * (1 - np.cos(0.2 * t)),
                 0.02 * t]
            )
            R, tt = lie.se3_exp(xi)
            gt.append((np.asarray(R), np.asarray(tt)))
            img = render(I0, R, tt)
            slam.process_frame_pipelined(img, t)
        slam.flush_pipeline()
        slam.finish()
        assert slam.initialized, "pipelined system failed to initialize"
        assert not slam.is_lost
        assert slam.next_kf_id >= 2

        from hslam_tpu.io.trajectory import ate_rmse

        est, gtp = [], []
        for s in slam.shells:
            Tcw = np.eye(4)
            Tcw[:3, :3], Tcw[:3, 3] = gt[s.id]
            gtp.append(np.linalg.inv(Tcw)[:3, 3])
            est.append(s.cam_to_world[:3, 3])
        err = ate_rmse(np.array(gtp), np.array(est))
        assert np.isfinite(err) and err < 0.15, f"ATE too high: {err}"
    finally:
        slam.close()


def test_input_skip_dt_scaled_tracking():
    """Fast-lane end-to-end smoke of the pipelined path AND the paced-load
    regression test: the realtime input loop skips input
    frames when behind (Main.cpp:91-106), so consecutive PROCESSED frames
    can be several camera periods apart. The motion hypotheses must scale
    the constant-velocity twist by the timestamp-gap ratio — without that
    (round-4 bug) every post-skip frame rejects the batched winner and
    falls into the synchronous retry/reloc spiral. Deterministic (no
    wall-clock pacing): frames are fed at a 3x timestamp gap directly.

    Runs the FULL hybrid pipeline: pipelined tracking + async mapping
    thread + loop-closure worker (shipped vocabulary) live."""
    from hslam_tpu.models.system import SLAMSystem

    cfg = Config(
        max_frames=6, max_points=512, max_immature=512, max_features=512,
        pyr_levels=3, init_min_matches=50, init_ransac_iters=100,
        desired_point_density=400.0, desired_immature_density=300.0,
        tracker_iters_per_level=(6, 10, 10),
    )
    slam = SLAMSystem(FX, FY, CX, CY, W, H, cfg, sequential=False)
    I0 = make_texture()

    def xi_at(t):
        return jnp.array(
            [0.4 * np.sin(0.3 * t), 0.25 * (1 - np.cos(0.35 * t)),
             0.12 * np.sin(0.2 * t),
             0.03 * np.sin(0.25 * t), 0.03 * (1 - np.cos(0.2 * t)),
             0.015 * t])

    gt = {}
    try:
        # phase A: consecutive frames (dt = 0.1) — init + steady state
        for i in range(14):
            t = i / 10.0
            R, tt = lie.se3_exp(xi_at(t))
            gt[i] = (np.asarray(R), np.asarray(tt))
            slam.process_frame_pipelined(render(I0, R, tt), t)
        slam.flush_pipeline()
        slam.finish()
        assert slam.initialized, "failed to initialize in phase A"
        retries_a = slam.n_track_retries

        # phase B: every 3rd frame only (dt = 0.3) — the skip regime
        skip_ids = list(range(15, 45, 3))
        for i in skip_ids:
            t = i / 10.0
            R, tt = lie.se3_exp(xi_at(t))
            gt[i] = (np.asarray(R), np.asarray(tt))
            slam.process_frame_pipelined(render(I0, R, tt), t)
        slam.flush_pipeline()
        slam.finish()

        assert not slam.is_lost
        # every skip-cadence frame must have tracked (no failure spiral)
        bad = [s.id for s in slam.shells if not s.pose_valid]
        assert not bad, f"pose-invalid frames under 3x skip: {bad}"
        retries_b = slam.n_track_retries - retries_a
        assert retries_b <= 1, (
            f"{retries_b} batched-winner rejections under 3x skip — "
            f"dt-scaled motion hypotheses regressed")

        from hslam_tpu.io.trajectory import ate_rmse
        est, gtp = [], []
        for s in slam.shells:
            i = int(round(s.timestamp * 10))
            Tcw = np.eye(4)
            Tcw[:3, :3], Tcw[:3, 3] = gt[i]
            gtp.append(np.linalg.inv(Tcw)[:3, 3])
            est.append(s.cam_to_world[:3, 3])
        err = ate_rmse(np.array(gtp), np.array(est))
        assert np.isfinite(err) and err < 0.15, f"ATE too high: {err}"
        # the loop-closure worker ran live on every keyframe
        assert slam.loop_closer is not None
        assert len(slam.loop_closer.entries) >= slam.next_kf_id - 1
    finally:
        slam.close()


@pytest.mark.slow
def test_sustained_load_new_terrain_kf_cadence():
    """Round-3 weakness: the hard 1-KF backpressure silently demoted KF
    decisions under load, so a trajectory entering NEW terrain at full rate
    tracked against an aging template until it failed. With reference
    catch-up semantics (keyframes always queue, only non-KF trace work
    drops — Mapping.cpp:169-190) the async pipeline must keep a KF cadence
    and ATE comparable to sequential mode while the camera sweeps across a
    wide texture it has never seen."""
    from hslam_tpu.io.trajectory import ate_rmse
    from hslam_tpu.models.system import SLAMSystem

    W_TEX = W + 560          # ~4.4 view-widths of fresh terrain
    key = jax.random.PRNGKey(9)
    ky, kx = jax.random.uniform(key, (2, 10), minval=0.5, maxval=6.0)
    ph = jax.random.uniform(jax.random.fold_in(key, 1), (10,)) * 6.28
    amps = jnp.array([32.0, 27.0, 21.0, 17.0, 13.0, 10.0, 8.0, 7.0, 6.0, 5.0])
    ys, xs = jnp.mgrid[0:H, 0:W_TEX]
    I0w = 120.0 + sum(
        amps[i] * jnp.sin(2 * jnp.pi * (kx[i] * xs / W + ky[i] * ys / H)
                          + ph[i])
        for i in range(10)
    )
    grid = jax.random.uniform(jax.random.fold_in(key, 2),
                              (H // 4 + 2, W_TEX // 4 + 2),
                              minval=-18.0, maxval=18.0)
    I0w = I0w + bilinear(grid, xs / 4.0, ys / 4.0)
    I0w = jnp.clip(I0w, 5.0, 250.0).astype(jnp.float32)

    def render_wide(Rf, tf):
        yy, xx = jnp.mgrid[0:H, 0:W]
        px = (xx - CX) / FX
        py = (yy - CY) / FY
        Rinv, tinv = lie.se3_inverse(Rf, tf)
        dz = Rinv[2, 0] * px + Rinv[2, 1] * py + Rinv[2, 2]
        s = (DEPTH - tinv[2]) / dz
        X = s * (Rinv[0, 0] * px + Rinv[0, 1] * py + Rinv[0, 2]) + tinv[0]
        Y = s * (Rinv[1, 0] * px + Rinv[1, 1] * py + Rinv[1, 2]) + tinv[1]
        # texture origin shifted so the whole sweep stays on-texture
        u0 = FX * X / DEPTH + CX + 40.0
        v0 = FY * Y / DEPTH + CY
        return np.asarray(bilinear(I0w, u0, v0))

    n_frames = 56
    gt = []
    frames_np = []
    for i in range(n_frames):
        t = i / 10.0
        # steady lateral sweep into fresh texture + mild wobble
        xi = jnp.array(
            [-0.058 * i, 0.03 * np.sin(0.4 * t), 0.015 * np.sin(0.3 * t),
             0.004 * np.sin(0.5 * t), 0.006 * np.sin(0.35 * t), 0.0])
        R, tt = lie.se3_exp(xi)
        gt.append((np.asarray(R), np.asarray(tt)))
        frames_np.append(render_wide(R, tt))

    cfg = Config(
        max_frames=6, max_points=512, max_immature=512, max_features=512,
        pyr_levels=3, init_min_matches=50, init_ransac_iters=100,
        desired_point_density=400.0, desired_immature_density=300.0,
        tracker_iters_per_level=(6, 10, 10),
    )

    import time as _t

    WARM = 12   # unpaced warmup frames: init + every kernel compile

    def run(sequential, period=0.0):
        slam = SLAMSystem(FX, FY, CX, CY, W, H, cfg,
                          sequential=sequential,
                          enable_loop_closure=False)
        # warmup: unpaced, mapper drained after every frame — XLA compiles
        # (~minutes on this host) must not masquerade as mapping load
        for i in range(WARM):
            if sequential:
                slam.process_frame(frames_np[i], i / 10.0)
            else:
                slam.process_frame_pipelined(frames_np[i], i / 10.0)
                slam.flush_pipeline()
                slam.finish()
        assert slam.initialized, "failed to initialize in warmup"
        if not sequential:
            slam.wait_compiles()
        # paced input with INPUT-SIDE frame skip when behind — the
        # reference driver's own policy (Main.cpp:91-106): a real camera
        # delivers at fixed wall rate and a loaded system drops input
        # frames, it does not buffer an unbounded backlog.
        t0 = _t.perf_counter()
        n_proc = 0
        i = WARM
        while i < len(frames_np):
            target = t0 + (i - WARM) * period
            now = _t.perf_counter()
            if now < target:
                _t.sleep(target - now)
            if sequential:
                slam.process_frame(frames_np[i], i / 10.0)
            else:
                slam.process_frame_pipelined(frames_np[i], i / 10.0)
            n_proc += 1
            assert not slam.is_lost, f"lost at frame {i} (seq={sequential})"
            i += 1
            if not sequential:
                now = _t.perf_counter()
                while (i < len(frames_np) - 1
                       and t0 + (i - WARM) * period < now):
                    i += 1     # input frame skipped (arrived while busy)
        if not sequential:
            slam.flush_pipeline()
            slam.finish()
        wall = _t.perf_counter() - t0
        est, gtp = [], []
        n_kf_measured = 0
        for s in slam.shells:
            if s.id >= WARM and s.is_kf:
                n_kf_measured += 1
            if s.pose_valid and s.id >= WARM:
                Tcw = np.eye(4)
                Tcw[:3, :3], Tcw[:3, 3] = gt[s.id]
                gtp.append(np.linalg.inv(Tcw)[:3, 3])
                est.append(s.cam_to_world[:3, 3])
        err = ate_rmse(np.array(gtp), np.array(est))
        slam.close()
        return n_kf_measured, err, n_proc, wall

    # sequential first: it defines the frame rate this host can sustain
    # (input blocks on every keyframe, so its average frame period is the
    # fastest cadence at which ALL mapping work still gets done)
    n_meas = len(frames_np) - WARM
    kf_seq, ate_seq, _, wall_seq = run(True, period=1e-6)
    # async at 1.5x that period: frames arrive while keyframes are in
    # flight, so the mapping queue takes real pressure (catch-up, drops,
    # input skips) — the r3 backpressure starved the map here; the latch
    # must keep KF cadence proportional to the frames actually tracked
    kf_async, ate_async, n_proc, _ = run(
        False, period=1.5 * wall_seq / n_meas)

    # the sweep must actually demand keyframes (new terrain)
    assert kf_seq >= 6, f"scene too easy: only {kf_seq} sequential KFs"
    assert n_proc >= 12, f"async processed only {n_proc} frames"
    # async must keep the map fed in proportion to what it tracked
    assert kf_async / n_proc >= 0.4 * kf_seq / n_meas, (
        f"KF starvation: async {kf_async}/{n_proc} vs "
        f"sequential {kf_seq}/{n_meas}")
    assert np.isfinite(ate_async)
    # overloaded-async drift bound: input-side skips halve the trace/BA
    # observations, so parity with sequential is not expected — 6% of
    # scene depth over a 3-view-width sweep is the healthy envelope
    assert ate_async < max(3.0 * ate_seq, 0.12), (
        f"async ATE {ate_async:.4f} vs sequential {ate_seq:.4f}")
