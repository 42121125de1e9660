"""Windowed BA driver: GN/LM loop, solve, marginalization.

Re-design of System::optimize (Src/FullSystemOptimize.cpp:362-546),
EnergyFunctional::solveSystemF (Src/EnergyFunctional.cpp:705-817),
marginalizeFrame (:456-543) and marginalizePointsF (:545-609) on the
fixed-capacity Window pytree. Key behavioral properties preserved:

  * FEJ: geometric Jacobians at evalPT / calib value_zero; idepth has no
    FEJ (the reference updates idepth_zero together with idepth every
    accepted step, FullSystemOptimize.cpp:208,230).
  * setting_forceAceptStep=true semantics (Settings.cpp:116): every step is
    applied; lambda is fixed at 1e-5 (SOLVER_FIX_LAMBDA).
  * Residual state machine with sticky OOB within one optimize() call.
  * Nullspace orthogonalization of the step from iteration 2 on
    (SOLVER_ORTHOGONALIZE_X_LATER).
  * After the loop the newest keyframe's evalPT is re-set to its current
    pose (FullSystemOptimize.cpp:498-506).
  * Frame marginalization = scaled Schur on HM/bM with the frame's priors
    added first; point marginalization adds margWeightFac * (M - Msc).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..config import CALIB_SCALE, CPARS, FRAME_STATE_SCALE, PATTERN_NUM, Config
from ..models import window as W
from ..models.calib import Calib
from ..ops import ba
from ..utils import lie


class BAResult(NamedTuple):
    window: W.Window
    calib: Calib
    rmse: jnp.ndarray             # sqrt(E / (8 * nres)) after final pass
    # per-point data for the tracker template (residual to newest KF):
    newest_proj_u: jnp.ndarray    # (P,)
    newest_proj_v: jnp.ndarray
    newest_proj_idepth: jnp.ndarray
    newest_res_in: jnp.ndarray    # (P,) bool
    HdiF: jnp.ndarray             # (P,)


def _stitched_delta(frames: W.Frames, calib: Calib) -> jnp.ndarray:
    """getStitchedDeltaF (EnergyFunctional.h): [c_delta; per-frame delta] in
    solver units."""
    c_delta = (calib.value - calib.value_zero) / jnp.asarray(CALIB_SCALE)
    f_delta = (frames.state - frames.state_zero) * frames.valid[:, None]
    return jnp.concatenate([c_delta, f_delta.reshape(-1)])


def _prior_vectors(frames: W.Frames, calib: Calib, cfg: Config):
    """Diagonal priors and their b contributions (stitchDoubleInternal
    usePrior branch, AccumulatedTopHessian.cpp:251-261)."""
    c_prior = jnp.full((CPARS,), cfg.initial_calib_hessian, jnp.float32)
    c_delta = (calib.value - calib.value_zero) / jnp.asarray(CALIB_SCALE)
    f_prior = frames.prior * frames.valid[:, None]
    f_delta_prior = frames.state * frames.valid[:, None]   # priorZero == 0
    prior_diag = jnp.concatenate([c_prior, f_prior.reshape(-1)])
    prior_b = jnp.concatenate(
        [c_prior * c_delta, (f_prior * f_delta_prior).reshape(-1)]
    )
    return prior_diag, prior_b


def _slot_mask(frames: W.Frames) -> jnp.ndarray:
    """(D,) 1.0 for dims belonging to calib or valid frame slots."""
    F = frames.valid.shape[0]
    fm = jnp.repeat(frames.valid.astype(jnp.float32), 8)
    return jnp.concatenate([jnp.ones(CPARS, jnp.float32), fm])


def solve_camera_system(
    H_top: jnp.ndarray,
    b_top: jnp.ndarray,
    H_sc: jnp.ndarray,
    b_sc: jnp.ndarray,
    HM: jnp.ndarray,
    bM: jnp.ndarray,
    delta: jnp.ndarray,
    prior_diag: jnp.ndarray,
    prior_b: jnp.ndarray,
    slot_mask: jnp.ndarray,
    ns_proj: jnp.ndarray,
    lam: jnp.ndarray,
    do_orth_x: jnp.ndarray,
    cfg: Config,
) -> jnp.ndarray:
    """solveSystemF (EnergyFunctional.cpp:705-817), default solver path.
    Returns x (D,) in solver units; steps are -x."""
    bM_top = bM + HM @ delta

    HFinal = H_top + jnp.diag(prior_diag) + HM
    bFinal = b_top + prior_b + bM_top - b_sc

    d = jnp.diag(HFinal)
    HFinal = HFinal + jnp.diag(d * lam)
    HFinal = HFinal - H_sc * (1.0 / (1.0 + lam))

    # deactivate dims of empty frame slots: identity rows/cols, zero rhs
    m = slot_mask
    HFinal = HFinal * m[:, None] * m[None, :] + jnp.diag(1.0 - m)
    bFinal = bFinal * m

    # a VALID frame can still be momentarily unconstrained (every residual
    # OOB/outlier and no prior on that dim) — an exactly-zero diagonal makes
    # the LU produce NaN, and the caller's NaN guard would then zero the
    # WHOLE step, not just the unconstrained dims; pin those dims instead
    dg = jnp.diag(HFinal)
    HFinal = HFinal + jnp.diag(jnp.where(jnp.abs(dg) < 1e-12, 1.0, 0.0))

    # scaled solve (EnergyFunctional.cpp:797-802)
    SVecI = 1.0 / jnp.sqrt(jnp.abs(jnp.diag(HFinal)) + 10.0)
    Hs = HFinal * SVecI[:, None] * SVecI[None, :]
    bs = bFinal * SVecI
    x = SVecI * jnp.linalg.solve(Hs, bs)

    x = jnp.where(do_orth_x, x - ns_proj @ x, x)
    return x


def _apply_step(frames: W.Frames, calib: Calib, points: W.Points,
                x: jnp.ndarray, d_step: jnp.ndarray):
    """doStepFromBackup with stepfac=1 (FullSystemOptimize.cpp:212-233):
    state += -x (solver units); idepth += step (and idepth_zero := idepth)."""
    F = frames.valid.shape[0]
    f_step = -x[CPARS:].reshape(F, 8) * frames.valid[:, None]
    new_state = frames.state + f_step
    frames = frames._replace(state=new_state)

    c_step = -x[:CPARS] * jnp.asarray(CALIB_SCALE)
    calib = calib._replace(value=calib.value + c_step)

    active = points.status == W.PT_ACTIVE
    new_id = jnp.where(active, points.idepth + d_step, points.idepth)
    points = points._replace(idepth=new_id, idepth_zero=new_id)
    return frames, calib, points, f_step


def _residual_grid_mask(frames: W.Frames, points: W.Points) -> jnp.ndarray:
    """(P, F) structurally-possible residuals: active point, valid target
    frame, target != host."""
    F = frames.valid.shape[0]
    pa = (points.status == W.PT_ACTIVE)[:, None]
    fv = frames.valid[None, :]
    not_host = points.host[:, None] != jnp.arange(F)[None, :]
    return pa & fv & not_host


def _update_energy_th(frames: W.Frames, lin: ba.Linearization,
                      grid: jnp.ndarray, newest_slot: jnp.ndarray,
                      cfg: Config, axis: str | None = None) -> W.Frames:
    """setNewFrameEnergyTH (FullSystemOptimize.cpp:60-101): the 0.7-quantile
    of sqrt(energy) over residuals targeting the newest frame, blended with
    a constant, squared. Under point-sharding (`axis`), the per-point values
    are all-gathered first — the quantile is a global order statistic."""
    F = frames.valid.shape[0]
    tgt_new = jnp.arange(F)[None, :] == newest_slot
    mask = grid & tgt_new & (lin.energy_raw >= 0)
    vals = jnp.where(mask, lin.energy_raw, jnp.inf).reshape(-1)
    if axis is not None:
        vals = jax.lax.all_gather(vals, axis, tiled=True)
    flat = jnp.sort(vals)                        # masked-out -> +inf at end
    n = jnp.sum(mask)
    if axis is not None:
        n = jax.lax.psum(n, axis)
    nth = jnp.clip((cfg.frame_energy_th_n * n).astype(jnp.int32), 0,
                   flat.shape[0] - 1)
    nth_val = jnp.sqrt(jnp.maximum(flat[nth], 0.0))
    th = nth_val * cfg.frame_energy_th_fac_median
    th = 26.0 * cfg.frame_energy_th_const_weight + th * (1.0 - cfg.frame_energy_th_const_weight)
    th = th * th * cfg.overall_energy_th_weight**2
    th = jnp.where(n > 0, th, 12.0 * 12.0 * PATTERN_NUM)
    new_th = jnp.where(
        jnp.arange(F) == newest_slot,
        th,
        frames.energy_th,
    )
    return frames._replace(energy_th=new_th)


def ba_optimize(
    wnd: W.Window,
    calib: Calib,
    cfg: Config,
    n_iterations: int,
    frozen: ba.FrozenResiduals | None = None,
    axis: str | None = None,
) -> BAResult:
    """The full GN loop for one keyframe insertion (System::optimize).

    `frozen` optionally supplies mode-1 linearized residuals (fixed J,
    resApprox = res_toZero + J*delta) accumulated alongside the active set
    each iteration (accumulateAF_MT + accumulateLF_MT,
    EnergyFunctional.cpp:155-197). In the reference this set is always empty
    during optimize() — isLinearized is only ever set on residuals of points
    marginalized in the same AddKeyframe pass (Mapping.cpp:287-292) — so the
    default None matches reference behavior; the machinery exists for parity
    tests and FEJ-consistent variants.

    `axis`: when called inside a shard_map over a point-sharded mesh axis,
    the name of that axis. Per-point work (linearize, Schur scalars, idepth
    steps, sticky states) stays local to the shard; the camera system
    (H, b, H_sc, b_sc), convergence statistics, energies, and the
    energy-threshold quantile are reduced with psum/all_gather — the
    device-mesh replacement for the reference's per-thread accumulator
    shards summed at stitch time (AccumulatedTopHessian.h:122-127)."""
    frames, points = wnd.frames, wnd.points
    F = frames.valid.shape[0]

    def _ps(x):
        return jax.lax.psum(x, axis) if axis is not None else x

    # newest slot = valid frame with max kf_id
    newest_slot = jnp.argmax(jnp.where(frames.valid, frames.kf_id, -1))

    grid = _residual_grid_mask(frames, points)
    res_state = jnp.where(grid, W.RES_IN, W.RES_OOB).astype(jnp.int32)

    # nullspace projector is loop-invariant (evalPTs fixed in optimize):
    # hoist the SVD out of the GN iterations
    ns_proj = ba.nullspace_projector(ba.nullspaces(frames), cfg.solver_mode_delta)
    # the window table is loop-invariant too (images never change inside
    # optimize) — build once, close over it in the loop body; it turns the
    # per-tap gathers of every linearize into one row gather per (p, f)
    window_table = ba.build_window_table(frames.images)
    slot_mask = _slot_mask(frames)
    lam = jnp.float32(cfg.fix_lambda)

    def gn_cond(carry):
        i, frames, calib, points, res_state, done = carry
        return (i < n_iterations) & ~done

    def gn_iter(carry):
        i, frames, calib, points, res_state, done = carry
        AH, AT = ba.compute_adjoints(frames)
        lin = ba.linearize(frames, points, calib, cfg, window_table=window_table)
        # sticky OOB (applyRes semantics, OptimizationClasses.cpp:235-256)
        new_rs = jnp.where(res_state == W.RES_OOB, W.RES_OOB, lin.new_state)
        active = (new_rs == W.RES_IN) & grid

        # indirect reprojection factors ride along for points that still
        # have at least one active photometric residual (their idepth is
        # Schur-eliminated, so the factor must only enter together with
        # the point's elimination)
        pt_phot = jnp.sum(active, axis=1) > 0
        ind_active = lin.ind_ok & grid & pt_phot[:, None]
        sys = ba.accumulate(lin, active, points.host, AH, AT, F,
                            ind_active=ind_active)
        if frozen is not None:
            sys = ba.add_systems(
                sys,
                ba.accumulate_frozen(frozen, frames, calib, points.host,
                                     AH, AT, F),
            )
        pt_active = (points.status == W.PT_ACTIVE) & (jnp.sum(active, axis=1) > 0)
        if frozen is not None:
            pt_active = pt_active | (
                (points.status == W.PT_ACTIVE)
                & jnp.any(frozen.is_linearized, axis=1)
            )
        H_sc, b_sc, HdiF = ba.schur_complement(sys, points.prior, pt_active)

        delta = _stitched_delta(frames, calib)
        prior_diag, prior_b = _prior_vectors(frames, calib, cfg)
        do_orth = jnp.asarray(i >= cfg.orthogonalize_x_from_iter)
        x = solve_camera_system(
            _ps(sys.H), _ps(sys.b), _ps(H_sc), _ps(b_sc), wnd.HM, wnd.bM,
            delta, prior_diag, prior_b, slot_mask, ns_proj, lam, do_orth, cfg,
        )
        x = jnp.where(jnp.isfinite(x), x, 0.0)
        d_step = ba.resubstitute(sys, HdiF, x)
        d_step = jnp.where(jnp.isfinite(d_step) & pt_active, d_step, 0.0)

        # skip updates once converged (canbreak, FullSystemOptimize.cpp:257-260)
        x_eff = jnp.where(done, 0.0, x)
        d_eff = jnp.where(done, 0.0, d_step)
        frames, calib, points, f_step = _apply_step(frames, calib, points, x_eff, d_eff)

        nf = jnp.maximum(jnp.sum(frames.valid), 1)
        sumA = jnp.sum(f_step[:, 6] ** 2) / nf
        sumB = jnp.sum(f_step[:, 7] ** 2) / nf
        sumT = jnp.sum(f_step[:, 0:3] ** 2) / nf
        sumR = jnp.sum(f_step[:, 3:6] ** 2) / nf
        npts = jnp.maximum(_ps(jnp.sum(pt_active)), 1)
        sumNID = _ps(jnp.sum(jnp.where(pt_active, jnp.abs(points.idepth), 0.0))) / npts
        th = cfg.th_opt_iterations
        canbreak = (
            (jnp.sqrt(sumA) < 0.0005 * th)
            & (jnp.sqrt(sumB) < 0.00005 * th)
            & (jnp.sqrt(sumR) < 0.00005 * th)
            & (jnp.sqrt(sumT) * sumNID < 0.00005 * th)
        )
        done = done | (canbreak & (i + 1 >= cfg.min_opt_iterations))
        return i + 1, frames, calib, points, new_rs, done

    # while_loop with convergence exit: each GN iteration is a full
    # linearize+accumulate+solve; steady-state windows converge in 2-3
    # iterations so real early exit halves the per-keyframe BA time
    _, frames, calib, points, res_state, _ = jax.lax.while_loop(
        gn_cond, gn_iter,
        (jnp.int32(0), frames, calib, points, res_state, jnp.bool_(False)),
    )

    # re-fix newest frame's linearization point at its current pose
    # (FullSystemOptimize.cpp:498-506)
    nat = frames.state * jnp.asarray(FRAME_STATE_SCALE)
    dR, dt = lie.se3_exp(nat[:, :6])
    R_cur, t_cur = lie.se3_mul(dR, dt, frames.evalpt_R, frames.evalpt_t)
    is_new = jnp.arange(F) == newest_slot
    new_R0 = jnp.where(is_new[:, None, None], R_cur, frames.evalpt_R)
    new_t0 = jnp.where(is_new[:, None], t_cur, frames.evalpt_t)
    zeroed = frames.state.at[:, 0:6].set(0.0)
    new_state = jnp.where(is_new[:, None], zeroed, frames.state)
    new_zero = jnp.where(
        is_new[:, None],
        jnp.concatenate([jnp.zeros((F, 6)), new_state[:, 6:8]], axis=1),
        frames.state_zero,
    )
    frames = frames._replace(
        evalpt_R=new_R0, evalpt_t=new_t0,
        state=new_state.astype(jnp.float32),
        state_zero=new_zero.astype(jnp.float32),
    )

    # final fixing pass: linearizeAll(true) — updates residual states,
    # energy threshold, maxRelBaseline/numGoodRes, tracker projections
    AH, AT = ba.compute_adjoints(frames)
    lin = ba.linearize(frames, points, calib, cfg, window_table=window_table)
    new_rs = jnp.where(res_state == W.RES_OOB, W.RES_OOB, lin.new_state)
    active = (new_rs == W.RES_IN) & grid

    frames = _update_energy_th(frames, lin, grid, newest_slot, cfg, axis=axis)

    # HdiF for the tracker template weights
    pt_phot = jnp.sum(active, axis=1) > 0
    sys = ba.accumulate(lin, active, points.host, AH, AT, F,
                        ind_active=lin.ind_ok & grid & pt_phot[:, None])
    pt_active = (points.status == W.PT_ACTIVE) & (jnp.sum(active, axis=1) > 0)
    _, _, HdiF = ba.schur_complement(sys, points.prior, pt_active)
    idepth_hessian = sys.Hdd + points.prior

    # maxRelBaseline & numGoodResiduals for residuals to the newest frame
    # (linearizeAll_Reductor, FullSystemOptimize.cpp:30-45)
    tgt_new = jnp.arange(F)[None, :] == newest_slot
    new_in = jnp.any(active & tgt_new, axis=1)
    u_new = jnp.sum(jnp.where(tgt_new, lin.center_u, 0.0), axis=1)
    v_new = jnp.sum(jnp.where(tgt_new, lin.center_v, 0.0), axis=1)
    id_new = jnp.sum(jnp.where(tgt_new, lin.center_idepth, 0.0), axis=1)
    relbs_new = jnp.sum(jnp.where(tgt_new, lin.rel_bs, 0.0), axis=1)

    points = points._replace(
        res_state=new_rs,
        num_good_res=points.num_good_res + new_in.astype(jnp.int32),
        idepth_hessian=idepth_hessian,
        max_rel_baseline=jnp.where(
            new_in,
            jnp.maximum(points.max_rel_baseline, relbs_new),
            points.max_rel_baseline,
        ),
    )

    E_total = _ps(jnp.sum(jnp.where(active, lin.energy, 0.0)))
    n_res = jnp.maximum(_ps(jnp.sum(active)), 1)
    rmse = jnp.sqrt(E_total / (PATTERN_NUM * n_res))

    return BAResult(
        window=W.Window(frames=frames, points=points, HM=wnd.HM, bM=wnd.bM),
        calib=calib,
        rmse=rmse,
        newest_proj_u=u_new,
        newest_proj_v=v_new,
        newest_proj_idepth=id_new,
        newest_res_in=new_in,
        HdiF=HdiF,
    )


# ---------------------------------------------------------------------------
# marginalization
# ---------------------------------------------------------------------------


def marginalize_points(
    wnd: W.Window,
    calib: Calib,
    to_marg: jnp.ndarray,     # (P,) bool — points to fold into HM/bM
    to_drop: jnp.ndarray,     # (P,) bool — points to discard outright
    cfg: Config,
    axis: str | None = None,
) -> W.Window:
    """flagPointsForRemoval + marginalizePointsF (Mapping.cpp:249-328,
    EnergyFunctional.cpp:545-609). The caller computes the policy flags;
    here we relinearize at the current state, extrapolate the residuals
    back to the zero-delta point (res_toZero = resF - J * dp,
    fixLinearizationF, OptimizationClasses.cpp:258-284 — bM is stored as
    the gradient at delta == 0 and advanced by HM * delta at solve time),
    accumulate the flagged points' residuals and add
    margWeightFac * (M - Msc) to HM/bM."""
    frames, points = wnd.frames, wnd.points
    F = frames.valid.shape[0]

    AH, AT = ba.compute_adjoints(frames)
    # same gather path as ba_optimize (window tables), so the residual set
    # folded into HM/bM is exactly the set the GN loop optimized over
    window_table = ba.build_window_table(frames.images)
    lin = ba.linearize(frames, points, calib, cfg, window_table=window_table)
    grid = _residual_grid_mask(frames, points)
    active = grid & (lin.new_state == W.RES_IN) & to_marg[:, None]

    # fixLinearizationF: res_toZero = resF - J * delta; mode-2 accumulation
    # then runs at the zero-delta point (bM is advanced by HM @ delta at
    # solve time). idepth delta is 0 by construction (idepth_zero := idepth
    # at every accepted step).
    frozen = ba.fix_linearization(lin, frames, calib, points.host, active,
                                  AH, AT)
    # indirect factors of marginalized points fold in too, extrapolated to
    # the zero-delta point with the same pixel-Jacobian algebra
    dp, c_delta = ba.pair_deltas(frames, calib, AH, AT)
    jx, jy = ba._jp_delta(lin, dp[points.host], c_delta,
                          jnp.zeros(points.u.shape[0], jnp.float32))
    ind_res0 = lin.ind_res - jnp.stack([jx, jy], axis=-1)
    lin = lin._replace(resF=frozen.res_toZero, ind_res=ind_res0)
    ind_active = grid & lin.ind_ok & to_marg[:, None]

    sys = ba.accumulate(lin, active, points.host, AH, AT, F,
                        ind_active=ind_active)
    marg_prior = points.prior * cfg.idepth_fix_prior_marg_fac
    pt_mask = to_marg & (jnp.sum(active, axis=1) > 0)
    # guard: only fold in well-constrained idepths — a tiny Hdd turns the
    # Schur term into a huge rank-1 spike that poisons HM (the policy also
    # gates on idepth_hessian > minIdepthH_marg, Mapping.cpp:296; this is
    # the in-kernel backstop)
    pt_mask = pt_mask & ((sys.Hdd + marg_prior) > cfg.min_idepth_h_marg)
    H_sc, b_sc, _ = ba.schur_complement(sys, marg_prior, pt_mask)

    # drop the residual blocks of points excluded by the guard from the top
    # Hessian too (their H/b must not enter HM unpaired with a Schur term)
    active = active & pt_mask[:, None]
    ind_active = ind_active & pt_mask[:, None]
    sys = ba.accumulate(lin, active, points.host, AH, AT, F,
                        ind_active=ind_active)

    H_top, b_top, H_sc_g, b_sc_g = sys.H, sys.b, H_sc, b_sc
    if axis is not None:   # point-sharded: reduce the folded blocks
        H_top = jax.lax.psum(H_top, axis)
        b_top = jax.lax.psum(b_top, axis)
        H_sc_g = jax.lax.psum(H_sc_g, axis)
        b_sc_g = jax.lax.psum(b_sc_g, axis)

    HM = wnd.HM + cfg.marg_weight_fac * (H_top - H_sc_g)
    bM = wnd.bM + cfg.marg_weight_fac * (b_top - b_sc_g)

    remove = to_marg | to_drop
    new_status = jnp.where(remove, W.PT_EMPTY, points.status)
    points = points._replace(status=new_status.astype(jnp.int32))
    return W.Window(frames=frames, points=points, HM=HM, bM=bM)


def marginalize_frame(
    wnd: W.Window,
    slot: jnp.ndarray,        # () int32 — frame slot to marginalize
    cfg: Config,
) -> W.Window:
    """EnergyFunctional::marginalizeFrame (EnergyFunctional.cpp:456-543):
    add the frame's prior into HM/bM, then Schur-eliminate its 8 dims with
    the reference's diagonal scaling. Fixed slots: no reordering — the
    eliminated dims are simply zeroed and the slot marked free."""
    frames = wnd.frames
    F = frames.valid.shape[0]
    D = CPARS + 8 * F

    sel = jnp.zeros(D, jnp.float32)
    idx8 = CPARS + 8 * slot + jnp.arange(8)
    sel = sel.at[idx8].set(1.0)

    prior = frames.prior[slot]
    delta_prior = frames.state[slot]
    HM = wnd.HM.at[idx8, idx8].add(prior)
    bM = wnd.bM.at[idx8].add(prior * delta_prior)

    SVec = jnp.sqrt(jnp.abs(jnp.diag(HM)) + 10.0)
    SVecI = 1.0 / SVec
    Hs = HM * SVecI[:, None] * SVecI[None, :]
    bs = bM * SVecI

    Hkk = Hs[jnp.ix_(idx8, idx8)] if False else jnp.take(
        jnp.take(Hs, idx8, axis=0), idx8, axis=1
    )
    Hak = jnp.take(Hs, idx8, axis=1)          # (D, 8)
    bk = jnp.take(bs, idx8)
    Hkk = 0.5 * (Hkk + Hkk.T)
    Hkk_inv = jnp.linalg.inv(Hkk)
    Hkk_inv = 0.5 * (Hkk_inv + Hkk_inv.T)

    Hs_new = Hs - Hak @ Hkk_inv @ Hak.T
    bs_new = bs - Hak @ (Hkk_inv @ bk)

    HM_new = Hs_new * SVec[:, None] * SVec[None, :]
    bM_new = bs_new * SVec
    HM_new = 0.5 * (HM_new + HM_new.T)

    keep = 1.0 - sel
    HM_new = HM_new * keep[:, None] * keep[None, :]
    bM_new = bM_new * keep

    new_valid = frames.valid & (jnp.arange(F) != slot)
    frames = frames._replace(valid=new_valid)
    return W.Window(frames=frames, points=wnd.points, HM=HM_new, bM=bM_new)
