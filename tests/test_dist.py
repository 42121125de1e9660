"""Distributed BA: point-sharded step on the virtual 8-device CPU mesh must
(a) run, and (b) produce the same camera system as the single-device path."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from hslam_tpu.config import CPARS
from hslam_tpu.models import window as W
from hslam_tpu.ops import ba


def test_sharded_step_matches_single_device():
    from test_ba import make_synthetic_window, _lin_and_sys
    from hslam_tpu.parallel.dist_ba import sharded_ba_step
    from hslam_tpu.models.optimizer import (
        _prior_vectors, _slot_mask, _stitched_delta, solve_camera_system,
    )

    wnd, calib, cfg = make_synthetic_window()
    devices = np.array(jax.devices()[:8])
    mesh = Mesh(devices, ("points",))

    rmse, new_state, d_step = sharded_ba_step(mesh, wnd, calib, cfg)
    assert np.isfinite(float(rmse))

    # single-device reference: one GN step with identical algebra
    lin, active, AH, AT, sys = _lin_and_sys(wnd, calib, cfg)
    pt_active = (wnd.points.status == W.PT_ACTIVE) & (jnp.sum(active, 1) > 0)
    H_sc, b_sc, HdiF = ba.schur_complement(sys, wnd.points.prior, pt_active)
    delta = _stitched_delta(wnd.frames, calib)
    prior_diag, prior_b = _prior_vectors(wnd.frames, calib, cfg)
    ns_proj = ba.nullspace_projector(ba.nullspaces(wnd.frames),
                                     cfg.solver_mode_delta)
    x = solve_camera_system(
        sys.H, sys.b, H_sc, b_sc, wnd.HM, wnd.bM, delta, prior_diag,
        prior_b, _slot_mask(wnd.frames), ns_proj, jnp.float32(cfg.fix_lambda),
        jnp.bool_(False), cfg,
    )
    F = cfg.max_frames
    expect_state = wnd.frames.state - (
        x[CPARS:].reshape(F, 8) * wnd.frames.valid[:, None]
    )
    # psum reduces in a different order than the single-device matmul; the
    # near-singular camera solve amplifies f32 rounding to the % level
    np.testing.assert_allclose(
        np.asarray(new_state), np.asarray(expect_state), rtol=5e-2, atol=1e-3
    )
    expect_d = ba.resubstitute(sys, HdiF, x)
    np.testing.assert_allclose(
        np.asarray(d_step), np.asarray(expect_d), rtol=5e-2, atol=2e-3
    )


@pytest.mark.slow
def test_graft_dryrun():
    """The driver's multichip dry-run contract must hold on the CPU mesh.
    (@slow: it duplicates the driver's own MULTICHIP artifact — run it in
    the --full lane, not on every CI pass.)"""
    import sys, os
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import __graft_entry__

    __graft_entry__.dryrun_multichip(8)


def test_sharded_full_optimize_matches_single_device():
    """The FULL sharded GN optimize (while_loop + sticky states + final
    fixing pass) must match the single-device ba_optimize bit-for-bit in
    structure and to tight tolerance numerically. The fixture adds strong
    pose priors so the camera solve is well-conditioned — parity then
    reflects the collective reductions, not f32 noise amplified through a
    near-singular solve."""
    from test_ba import make_synthetic_window
    from hslam_tpu.models.optimizer import ba_optimize
    from hslam_tpu.parallel.dist_ba import sharded_ba_optimize

    wnd, calib, cfg = make_synthetic_window()
    # condition the solve: diagonal priors at the Hessian's own scale (~3e8
    # here) — with weak priors the gauge-deficient camera solve amplifies
    # the f32 psum-order noise (~1e-7 relative on H) to percent-level steps
    wnd = wnd._replace(frames=wnd.frames._replace(
        prior=jnp.full_like(wnd.frames.prior, 1e8)))

    devices = np.array(jax.devices()[:8])
    mesh = Mesh(devices, ("points",))

    res_d = sharded_ba_optimize(mesh, wnd, calib, cfg, 4)
    res_s = jax.jit(lambda w, c: ba_optimize(w, c, cfg, 4))(wnd, calib)

    np.testing.assert_allclose(float(res_d.rmse), float(res_s.rmse),
                               rtol=1e-4)
    np.testing.assert_allclose(np.asarray(res_d.window.frames.state),
                               np.asarray(res_s.window.frames.state),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(res_d.calib.value),
                               np.asarray(res_s.calib.value), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(res_d.window.points.idepth),
                               np.asarray(res_s.window.points.idepth),
                               rtol=1e-3, atol=1e-4)
    # sticky residual states and energy thresholds must agree exactly
    assert (np.asarray(res_d.window.points.res_state)
            == np.asarray(res_s.window.points.res_state)).all()
    np.testing.assert_allclose(np.asarray(res_d.window.frames.energy_th),
                               np.asarray(res_s.window.frames.energy_th),
                               rtol=1e-4)


def test_sharded_marginalize_points_matches():
    from test_ba import make_synthetic_window
    from hslam_tpu.models.optimizer import marginalize_points
    from hslam_tpu.parallel.dist_ba import sharded_marginalize_points

    wnd, calib, cfg = make_synthetic_window()
    P_ = cfg.max_points
    to_marg = (np.arange(P_) % 5 == 0)
    to_drop = (np.arange(P_) % 7 == 3) & ~to_marg
    wnd_d = sharded_marginalize_points(
        Mesh(np.array(jax.devices()[:8]), ("points",)), wnd, calib,
        jnp.asarray(to_marg), jnp.asarray(to_drop), cfg)
    wnd_s = jax.jit(lambda w, c: marginalize_points(
        w, c, jnp.asarray(to_marg), jnp.asarray(to_drop), cfg))(wnd, calib)
    np.testing.assert_allclose(np.asarray(wnd_d.HM), np.asarray(wnd_s.HM),
                               rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(np.asarray(wnd_d.bM), np.asarray(wnd_s.bM),
                               rtol=1e-4, atol=1e-2)
    assert (np.asarray(wnd_d.points.status)
            == np.asarray(wnd_s.points.status)).all()


@pytest.mark.slow
def test_system_with_dist_mesh():
    """The live system with dist_mesh: the whole keyframe pipeline runs with
    the BA + point-marginalization point-sharded over the 8-device mesh and
    still initializes, tracks, and keeps trajectory error bounded."""
    from test_system import FX, FY, CX, CY, H, W as W_IMG, make_texture, render
    from hslam_tpu.config import Config
    from hslam_tpu.models.system import SLAMSystem
    from hslam_tpu.utils import lie

    cfg = Config(
        max_frames=6, max_points=512, max_immature=512, max_features=512,
        pyr_levels=3, init_min_matches=50, init_ransac_iters=100,
        desired_point_density=400.0, desired_immature_density=300.0,
        tracker_iters_per_level=(6, 10, 10),
    )
    mesh = Mesh(np.array(jax.devices()[:8]), ("points",))
    slam = SLAMSystem(FX, FY, CX, CY, W_IMG, H, cfg, dist_mesh=mesh)
    I0 = make_texture()

    gt = []
    for i in range(14):
        t = i / 10.0
        xi = jnp.array(
            [0.35 * np.sin(0.5 * t), 0.18 * (1 - np.cos(0.5 * t)), 0.05 * t,
             0.015 * np.sin(0.4 * t), 0.025 * t, 0.01 * np.sin(0.3 * t)]
        )
        R, tt = lie.se3_exp(xi)
        gt.append((np.asarray(R), np.asarray(tt)))
        img = render(I0, R, tt)
        slam.process_frame(img, t)
        assert not slam.is_lost, f"lost at frame {i}"
    assert slam.initialized
    assert slam.next_kf_id >= 3

    from hslam_tpu.io.trajectory import ate_rmse
    est, gtp = [], []
    for s in slam.shells:
        if s.pose_valid and s.tracking_ref is not None or s.is_kf:
            Tcw = np.eye(4)
            Tcw[:3, :3], Tcw[:3, 3] = gt[s.id]
            gtp.append(np.linalg.inv(Tcw)[:3, 3])
            est.append(s.cam_to_world[:3, 3])
    err = ate_rmse(np.array(gtp), np.array(est))
    assert np.isfinite(err) and err < 0.15, f"ATE too high: {err}"


def test_sharded_pose_graph_matches_single_device():
    """Edge-sharded PCG pose graph (8-way edge partition, psum'd
    reductions) must match the single-device PCG solver on the Strasdat
    circle fixture — same algorithm, only the reduction order differs."""
    from test_loop import _build_circle_sim3, _pg_chi2
    from hslam_tpu.models.pose_graph import optimize_pose_graph_pcg
    from hslam_tpu.parallel.dist_pose_graph import (
        pad_edges, sharded_optimize_pose_graph_pcg)

    pg = _build_circle_sim3(61, scale_drift=1.002, noise=0.005)
    assert pg.edge_i.shape[0] % 8 != 0  # exercise the padding path

    s1, R1, t1 = optimize_pose_graph_pcg(pg, n_iters=8, cg_iters=400)
    mesh = Mesh(np.array(jax.devices()[:8]), ("edges",))
    s8, R8, t8 = sharded_optimize_pose_graph_pcg(mesh, pg, n_iters=8,
                                                 cg_iters=400)

    np.testing.assert_allclose(np.asarray(s8), np.asarray(s1),
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(np.asarray(t8), np.asarray(t1),
                               rtol=0, atol=5e-3)
    # both must actually have relaxed the graph
    chi_in = _pg_chi2(pg, pg.s, pg.R, pg.t)
    chi_1 = _pg_chi2(pg, s1, R1, t1)
    chi_8 = _pg_chi2(pg, s8, R8, t8)
    assert chi_1 < 0.1 * chi_in
    assert chi_8 < 1.05 * chi_1 + 1e-6

    # padding must be a pure no-op on the unsharded solver too
    pgp = pad_edges(pg, 8)
    sp, Rp, tp = optimize_pose_graph_pcg(pgp, n_iters=8, cg_iters=400)
    np.testing.assert_allclose(np.asarray(sp), np.asarray(s1), rtol=1e-5)


def _sharded_ba_call(mesh):
    from test_ba import make_synthetic_window
    from hslam_tpu.parallel.dist_ba import sharded_ba_optimize

    wnd, calib, cfg = make_synthetic_window()
    return sharded_ba_optimize, lambda: sharded_ba_optimize(
        mesh, wnd, calib, cfg, 2)


def _sharded_pose_graph_call(mesh):
    from test_loop import _build_circle_sim3
    from hslam_tpu.parallel.dist_pose_graph import (
        sharded_optimize_pose_graph_pcg)

    pg = _build_circle_sim3(17, scale_drift=1.002, noise=0.005)
    return sharded_optimize_pose_graph_pcg, lambda: (
        sharded_optimize_pose_graph_pcg(mesh, pg, n_iters=2, cg_iters=20))


@pytest.mark.parametrize("make_call", [_sharded_ba_call,
                                       _sharded_pose_graph_call])
def test_sharded_entry_point_compiles_once(make_call):
    """Called outside a jit, a sharded entry point is one compiled program
    reused across calls: an eager shard_map runs op by op and recompiles
    its loop bodies on every call, which took minutes per call on GPUs."""
    mesh = Mesh(np.array(jax.devices()[:8]), ("points",))
    fn, call = make_call(mesh)
    jax.block_until_ready(call())
    n_compiled = fn._cache_size()
    jax.block_until_ready(call())
    assert n_compiled >= 1 and fn._cache_size() == n_compiled
