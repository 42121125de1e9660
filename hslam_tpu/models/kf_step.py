"""Fused device-side keyframe step: the whole AddKeyframe pipeline in ONE jit.

Re-design of the reference's mapping-thread work
(Src/Mapping.cpp AddKeyframe :12-142) as a single compiled device function.
The reference interleaves C++ policy code with numeric work at function-call
granularity; on an accelerator every host touch of device data costs a
synchronizing round trip, so the per-keyframe pipeline

    traceNewCoarse -> insertFrame -> activatePointsMT -> optimize
    -> removeOutliers -> setCoarseTrackingRef -> flagPointsForRemoval
    -> marginalizePointsF -> makeNewTraces -> marginalizeFrame*

runs as one dispatch here, and everything the host-side policy state machine
needs back (keyframe decision stats, marginalization-policy inputs, shell
poses, connectivity tallies) is returned as ONE small `KFBundle` pulled in a
single async host copy. Host policy (frame flagging, density adaptation,
init-failure gates) operates on mirrors refreshed from the previous bundle —
the device-side equivalent of the reference's shared-memory policy reads.

Candidate (immature) point state is the fixed-capacity `Imm` SoA pytree
(ImmaturePoint lists, Include/ImmaturePoint.h; Frame.h:46-49 containers).
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..config import FRAME_STATE_SCALE, PATTERN, Config
from ..models import window as W
from ..models.calib import Calib, level_intrinsics
from ..models.optimizer import (BAResult, ba_optimize, marginalize_frame,
                                marginalize_points)
from ..ops import activation as act_ops
from ..ops import distmap as dist_ops
from ..ops import epipolar as epi_ops
from ..ops import tracker as trk_ops
from ..utils import lie
from ..utils.compaction import assign_free_slots, scatter_update
from ..utils.interp import bilinear


class Imm(NamedTuple):
    """Device SoA for candidate points (capacity cfg.max_immature)."""

    valid: jnp.ndarray        # (N,) bool
    host: jnp.ndarray         # (N,) int32 window slot
    u: jnp.ndarray            # (N,)
    v: jnp.ndarray
    color: jnp.ndarray        # (N, 8)
    weight: jnp.ndarray       # (N, 8)
    gradH: jnp.ndarray        # (N, 2, 2)
    my_type: jnp.ndarray      # (N,)
    energy_th: jnp.ndarray    # (N,)
    kp_idx: jnp.ndarray       # (N,) int32 host-keyframe keypoint index
                              # (-1 for gradient-selected candidates) —
                              # the hybrid "candidates hosted on detector
                              # keypoints" link (Src/Detector.cpp:56-67)
    trace: epi_ops.TraceState


def empty_imm(cfg: Config) -> Imm:
    n = cfg.max_immature
    return Imm(
        valid=jnp.zeros(n, bool),
        host=jnp.zeros(n, jnp.int32),
        u=jnp.zeros(n, jnp.float32),
        v=jnp.zeros(n, jnp.float32),
        color=jnp.zeros((n, 8), jnp.float32),
        weight=jnp.ones((n, 8), jnp.float32),
        gradH=jnp.zeros((n, 2, 2), jnp.float32),
        my_type=jnp.ones(n, jnp.float32),
        energy_th=jnp.zeros(n, jnp.float32),
        kp_idx=jnp.full(n, -1, jnp.int32),
        trace=epi_ops.init_trace_state(n),
    )


class KFBundle(NamedTuple):
    """Everything the host state machine needs after one keyframe — pulled
    in ONE device->host copy (the policy mirrors)."""

    rmse: jnp.ndarray             # () final BA rmse
    valid: jnp.ndarray            # (F,) post-marginalization slot validity
    kf_id: jnp.ndarray            # (F,)
    Rwc: jnp.ndarray              # (F, 3, 3) worldToCam after BA
    twc: jnp.ndarray              # (F, 3)
    aff: jnp.ndarray              # (F, 2) natural-unit affine after BA
    exposure: jnp.ndarray         # (F,)
    calib_value: jnp.ndarray      # (4,)
    n_active: jnp.ndarray         # () active point count after marg
    n_active_host: jnp.ndarray    # (F,) active points per host slot
    n_imm_host: jnp.ndarray       # (F,) live candidates per host slot
    sel_count: jnp.ndarray        # () selector picks this KF (pot adaptation)
    removed_host: jnp.ndarray     # (F,) points marg'd/dropped this KF by host
    conn_active: jnp.ndarray      # (F, F) active residual counts (snapshot)
    conn_marg: jnp.ndarray        # (F, F) residuals marginalized this KF
    flow_ok: jnp.ndarray          # () bool — all window poses finite
    n_ind: jnp.ndarray            # () indirect observations live after marg
    kp_idepth: jnp.ndarray        # (NF,) keypoint depth lift (loop closure)
    kp_depth_ok: jnp.ndarray      # (NF,) lift within 3 px of a map point


# --------------------------------------------------------------------- trace


def trace_candidates(
    imm: Imm,
    frames: W.Frames,
    calib_value: jnp.ndarray,      # (4,)
    R_new: jnp.ndarray,            # (3, 3) worldToCam of the new frame
    t_new: jnp.ndarray,            # (3,)
    aff_new: jnp.ndarray,          # (2,) natural-unit (a, b) of the new frame
    exp_new: jnp.ndarray,          # ()
    target: jnp.ndarray,           # (H, W, 3) new frame direct image
    cfg: Config,
) -> epi_ops.TraceState:
    """traceNewCoarse (Mapping.cpp:494-538): epipolar-trace every candidate
    into the new frame. Pure device function — relative transforms per host
    slot are computed from the window poses on device."""
    R_f, t_f = W.frame_poses(frames)
    Ri, ti = lie.se3_inverse(R_f, t_f)
    R_rel = R_new[None] @ Ri                               # (F, 3, 3)
    t_rel = jnp.einsum("ij,fj->fi", R_new, ti) + t_new[None]

    fx, fy, cx, cy = (calib_value[0], calib_value[1],
                      calib_value[2], calib_value[3])
    K = jnp.array([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]], jnp.float32)
    K = K.at[0, 0].set(fx).at[1, 1].set(fy).at[0, 2].set(cx).at[1, 2].set(cy)
    Kinv = jnp.array([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]], jnp.float32)
    Kinv = (Kinv.at[0, 0].set(1.0 / fx).at[1, 1].set(1.0 / fy)
            .at[0, 2].set(-cx / fx).at[1, 2].set(-cy / fy))
    KRKi = jnp.einsum("ij,fjk,kl->fil", K, R_rel, Kinv)
    Kt = jnp.einsum("ij,fj->fi", K, t_rel)

    aff_f = W.frame_affine(frames)
    exp_f = jnp.where(frames.exposure == 0, 1.0, frames.exposure)
    exp_n = jnp.where(exp_new == 0, 1.0, exp_new)
    a_rel = jnp.exp(aff_new[0] - aff_f[:, 0]) * exp_n / exp_f
    b_rel = aff_new[1] - a_rel * aff_f[:, 1]

    h = imm.host
    return epi_ops.trace_on(
        imm.trace, imm.u, imm.v, imm.color, imm.weight, imm.gradH,
        imm.energy_th, imm.valid,
        KRKi[h], Kt[h], jnp.stack([a_rel[h], b_rel[h]], -1),
        target, cfg=cfg,
    )


# ---------------------------------------------------------------- activation


def activate_candidates(
    window: W.Window,
    calib: Calib,
    imm: Imm,
    new_slot: jnp.ndarray,         # () int32
    act_dist: jnp.ndarray,         # () float32 currentMinActDist
    cfg: Config,
) -> Tuple[W.Window, Imm]:
    """activatePointsMT (Mapping.cpp:330-492): candidate deletion, distance-
    map spread gating, batched idepth GN, insertion of activated points."""
    frames, pts = window.frames, window.points
    tr = imm.trace
    H0, W0 = frames.images.shape[1], frames.images.shape[2]
    h2, w2 = H0 // 2, W0 // 2

    valid = imm.valid
    # candidate deletion (Mapping.cpp:374-381)
    delete = (~jnp.isfinite(tr.idepth_max)) | (tr.status == epi_ops.IPS_OUTLIER)
    valid = valid & ~delete

    can_activate = (
        valid
        & ((tr.status == epi_ops.IPS_GOOD)
           | (tr.status == epi_ops.IPS_SKIPPED)
           | (tr.status == epi_ops.IPS_BADCONDITION)
           | (tr.status == epi_ops.IPS_OOB))
        & (tr.last_interval < 8.0)
        & (tr.quality > cfg.min_trace_quality)
        & (tr.idepth_max + tr.idepth_min > 0)
    )
    valid = valid & ~(~can_activate & (tr.status == epi_ops.IPS_OOB))

    # distance-map gating at half resolution (Mapping.cpp:405-420)
    R_f, t_f = W.frame_poses(frames)
    half_K = level_intrinsics(calib, 1)
    act_mask = pts.status == W.PT_ACTIVE
    Ph = pts.host
    Ri, ti = lie.se3_inverse(R_f, t_f)
    R_rel = R_f[new_slot][None] @ Ri                        # (F, 3, 3)
    t_rel = jnp.einsum("ij,fj->fi", R_f[new_slot], ti) + t_f[new_slot][None]
    fx, fy, cx, cy = [calib.value[i] for i in range(4)]
    xh = (pts.u - cx) / fx
    yh = (pts.v - cy) / fy
    dirs = jnp.stack([xh, yh, jnp.ones_like(xh)], -1)
    # broadcast form, not einsum: P-batched 3x3 dots
    p3 = (jnp.sum(R_rel[Ph] * dirs[:, None, :], axis=-1)
          + t_rel[Ph] * pts.idepth[:, None])
    z = jnp.where(jnp.abs(p3[:, 2]) < 1e-9, 1e-9, p3[:, 2])
    su = half_K[0] * p3[:, 0] / z + half_K[2]
    sv = half_K[1] * p3[:, 1] / z + half_K[3]
    seed_ok = act_mask & (z > 0) & (su >= 0) & (sv >= 0) & (su < w2) & (sv < h2)
    dmap = dist_ops.distance_map(su, sv, seed_ok, h2, w2)

    # candidate projection into the newest frame
    ih = imm.host
    idm = 0.5 * (tr.idepth_max + tr.idepth_min)
    xh_i = (imm.u - cx) / fx
    yh_i = (imm.v - cy) / fy
    dirs_i = jnp.stack([xh_i, yh_i, jnp.ones_like(xh_i)], -1)
    p3i = (jnp.sum(R_rel[ih] * dirs_i[:, None, :], axis=-1)
           + t_rel[ih] * idm[:, None])
    zi = jnp.where(jnp.abs(p3i[:, 2]) < 1e-9, 1e-9, p3i[:, 2])
    cu = half_K[0] * p3i[:, 0] / zi + half_K[2]
    cv = half_K[1] * p3i[:, 1] / zi + half_K[3]
    inb = (cu > 0) & (cv > 0) & (cu < w2) & (cv < h2) & (zi > 0)
    cui = jnp.clip(jnp.round(cu).astype(jnp.int32), 0, w2 - 1)
    cvi = jnp.clip(jnp.round(cv).astype(jnp.int32), 0, h2 - 1)
    dist_at = dmap[cvi, cui] + (cu - jnp.floor(cu))
    gate = dist_at >= act_dist * imm.my_type
    to_opt = can_activate & inb & gate
    valid = valid & (inb | ~can_activate)

    act = act_ops.activate_points(
        frames, calib, imm.u, imm.v, idm, imm.color, imm.weight,
        imm.host, to_opt, cfg=cfg,
    )

    N = imm.u.shape[0]
    Fn = frames.valid.shape[0]
    slots, write = assign_free_slots(pts.status == W.PT_EMPTY, act.ok)
    newpts = pts._replace(
        status=scatter_update(pts.status, slots, write,
                              jnp.full_like(slots, W.PT_ACTIVE)),
        host=scatter_update(pts.host, slots, write, imm.host),
        u=scatter_update(pts.u, slots, write, imm.u),
        v=scatter_update(pts.v, slots, write, imm.v),
        idepth=scatter_update(pts.idepth, slots, write, act.idepth),
        idepth_zero=scatter_update(pts.idepth_zero, slots, write, act.idepth),
        color=scatter_update(pts.color, slots, write, imm.color),
        weight=scatter_update(pts.weight, slots, write, imm.weight),
        prior=scatter_update(pts.prior, slots, write, jnp.zeros_like(imm.u)),
        num_good_res=scatter_update(pts.num_good_res, slots, write,
                                    jnp.zeros_like(slots)),
        max_rel_baseline=scatter_update(pts.max_rel_baseline, slots, write,
                                        jnp.zeros_like(imm.u)),
        kp_idx=scatter_update(pts.kp_idx, slots, write, imm.kp_idx),
        ind_u=scatter_update(pts.ind_u, slots, write,
                             jnp.zeros((N, Fn), jnp.float32)),
        ind_v=scatter_update(pts.ind_v, slots, write,
                             jnp.zeros((N, Fn), jnp.float32)),
        ind_w=scatter_update(pts.ind_w, slots, write,
                             jnp.zeros((N, Fn), jnp.float32)),
        ind_valid=scatter_update(pts.ind_valid, slots, write,
                                 jnp.zeros((N, Fn), bool)),
    )
    valid = valid & ~to_opt
    return (window._replace(points=newpts), imm._replace(valid=valid))


# ------------------------------------------------------- point flagging/marg


def flag_and_marg_points(
    window: W.Window,
    calib: Calib,
    flag_mask: jnp.ndarray,        # (F,) frames flagged for marginalization
    cfg: Config,
    mesh=None,
) -> Tuple[W.Window, jnp.ndarray, jnp.ndarray]:
    """flagPointsForRemoval + marginalizePointsF (Mapping.cpp:249-328),
    with the isOOB policy of MapPoint.h:133-161. Returns
    (window, removed_per_host (F,), conn_marg (F, F))."""
    pts = window.points
    frames = window.frames
    F = frames.valid.shape[0]

    active = pts.status == W.PT_ACTIVE
    res_in = pts.res_state == W.RES_IN
    n_res = jnp.sum(res_in, axis=1)
    vis_in_marg = jnp.sum(res_in & flag_mask[None, :], axis=1)

    drop_nores = active & ((pts.idepth < 0) | (n_res == 0))
    host_flagged = flag_mask[pts.host]

    # lastResiduals[0/1]: the two newest keyframes (MapPoint.h:89-90,148-154)
    order = jnp.argsort(jnp.where(frames.valid, frames.kf_id, -1))
    newest_slot = order[-1]
    second_slot = jnp.where(jnp.sum(frames.valid) >= 2, order[-2], order[-1])
    last0 = pts.res_state[:, newest_slot]
    last1 = pts.res_state[:, second_slot]
    is_oob = (
        ((n_res >= cfg.min_good_active_res_for_marg)
         & (pts.num_good_res > cfg.min_good_res_for_marg + 10)
         & (n_res - vis_in_marg < cfg.min_good_active_res_for_marg))
        | (last0 == W.RES_OOB)
        | ((n_res >= 2) & (last0 == W.RES_OUT) & (last1 == W.RES_OUT))
    )
    affected = active & ~drop_nores & (is_oob | host_flagged)
    inlier = (n_res >= cfg.min_good_active_res_for_marg) & (
        pts.num_good_res >= cfg.min_good_res_for_marg
    )
    well = pts.idepth_hessian > cfg.min_idepth_h_marg
    to_marg = affected & inlier & well
    to_drop = (affected & (~inlier | ~well)) | drop_nores

    removed = to_marg | to_drop
    removed_host = (jnp.zeros(F, jnp.int32)
                    .at[pts.host].add(removed.astype(jnp.int32)))

    # residuals folded into HM this step, per (host, target) pair
    # (EnergyFunctional::marginalizePointsF connectivity, :566)
    res_marg = (res_in & to_marg[:, None]).astype(jnp.float32)
    onehot = jax.nn.one_hot(pts.host, F, dtype=jnp.float32)
    conn_marg = (onehot.T @ res_marg).astype(jnp.int32)

    if mesh is None:
        wnd = marginalize_points(window, calib, to_marg, to_drop, cfg)
    else:
        from ..parallel.dist_ba import sharded_marginalize_points
        wnd = sharded_marginalize_points(mesh, window, calib, to_marg,
                                         to_drop, cfg)
    return wnd, removed_host, conn_marg


# ------------------------------------------------------------- trace insert


def insert_new_traces(
    imm: Imm,
    slot: jnp.ndarray,             # () int32 host slot of the new KF
    sel_u: jnp.ndarray,            # (C,) selector picks
    sel_v: jnp.ndarray,
    sel_type: jnp.ndarray,         # (C,) int32
    sel_valid: jnp.ndarray,        # (C,) bool
    dir0: jnp.ndarray,             # (H, W, 3) level-0 direct image of the KF
    cfg: Config,
    sel_kp: jnp.ndarray | None = None,   # (C,) int32 keypoint index or -1
) -> Imm:
    """makeNewTraces (Mapping.cpp:226-247): sample pattern colors/weights of
    selector picks and insert fresh immature points. `sel_kp` links
    keypoint-hosted candidates to the keyframe's feature table (hybrid
    layer; -1 for gradient-selected candidates)."""
    pat = jnp.asarray(PATTERN, jnp.float32)
    up = sel_u[:, None] + pat[None, :, 0]
    vp = sel_v[:, None] + pat[None, :, 1]
    col = bilinear(dir0[..., 0], up, vp)
    gx = bilinear(dir0[..., 1], up, vp)
    gy = bilinear(dir0[..., 2], up, vp)
    c = cfg.outlier_th_sum_component
    wgt = jnp.sqrt(c / (c + gx ** 2 + gy ** 2))
    gH = jnp.stack(
        [jnp.stack([jnp.sum(gx * gx, -1), jnp.sum(gx * gy, -1)], -1),
         jnp.stack([jnp.sum(gx * gy, -1), jnp.sum(gy * gy, -1)], -1)], -2)
    finite = jnp.all(jnp.isfinite(col), axis=-1)
    cand = sel_valid & finite
    if sel_kp is None:
        sel_kp = jnp.full(sel_u.shape[0], -1, jnp.int32)

    slots, write = assign_free_slots(~imm.valid, cand)
    tr = imm.trace
    u = sel_u
    new_trace = epi_ops.TraceState(
        idepth_min=scatter_update(tr.idepth_min, slots, write,
                                  jnp.zeros_like(u)),
        idepth_max=scatter_update(tr.idepth_max, slots, write,
                                  jnp.full_like(u, jnp.inf)),
        status=scatter_update(tr.status, slots, write,
                              jnp.full_like(slots, epi_ops.IPS_UNINITIALIZED)),
        quality=scatter_update(tr.quality, slots, write,
                               jnp.full_like(u, 10000.0)),
        last_u=scatter_update(tr.last_u, slots, write, jnp.full_like(u, -1.0)),
        last_v=scatter_update(tr.last_v, slots, write, jnp.full_like(u, -1.0)),
        last_interval=scatter_update(tr.last_interval, slots, write,
                                     jnp.zeros_like(u)),
    )
    return Imm(
        valid=scatter_update(imm.valid, slots, write,
                             jnp.ones_like(slots, dtype=bool)),
        host=scatter_update(imm.host, slots, write,
                            jnp.full_like(slots, slot)),
        u=scatter_update(imm.u, slots, write, sel_u),
        v=scatter_update(imm.v, slots, write, sel_v),
        color=scatter_update(imm.color, slots, write, col),
        weight=scatter_update(imm.weight, slots, write, wgt),
        gradH=scatter_update(imm.gradH, slots, write, gH),
        my_type=scatter_update(imm.my_type, slots, write,
                               sel_type.astype(jnp.float32)),
        energy_th=scatter_update(
            imm.energy_th, slots, write,
            jnp.full_like(sel_u,
                          8 * cfg.outlier_th * cfg.overall_energy_th_weight ** 2)),
        kp_idx=scatter_update(imm.kp_idx, slots, write, sel_kp),
        trace=new_trace,
    )


# ------------------------------------------------------ indirect association


def indirect_associate(
    window: W.Window,
    feats,                         # features.Feats — per-slot keypoint store
    slot: jnp.ndarray,             # () int32 — the newly inserted KF slot
    cfg: Config,
    ind_w_scale: jnp.ndarray | None = None,   # () tracking-health schedule
) -> W.Window:
    """Hybrid indirect matching: match every window keyframe's keypoints
    against the new keyframe's, and give each keypoint-hosted active point
    its detected location in the new frame as a reprojection observation
    (enters the window BA through Linearization.ind_*; the capability the
    reference declares with its per-frame descriptor layer,
    Src/Detector.cpp:70-131 + Include/MapPoint.h).

    `ind_w_scale` schedules the indirect information weight by tracking
    health: when the photometric tracker degrades against its own
    per-reference baseline (appearance stress — exposure flicker, low
    texture), the geometric reprojection terms take more of the load; in
    the steady state the scale is 1 and nothing changes. Traced scalar —
    no recompile across values."""
    from ..ops import features as ft

    pts = window.points
    frames = window.frames
    F = frames.valid.shape[0]
    NF = feats.u.shape[1]

    new_desc = feats.desc[slot]
    new_valid = feats.valid[slot]

    def m1(d, v):
        return ft.match_pair(d, v, new_desc, new_valid,
                             max_dist=cfg.indirect_match_max_dist,
                             ratio=cfg.indirect_match_ratio)

    midx, mok = jax.vmap(m1)(feats.desc, feats.valid)       # (F, NF)

    kp = jnp.clip(pts.kp_idx, 0, NF - 1)
    j = midx[pts.host, kp]                                   # (P,)
    ok = (
        mok[pts.host, kp]
        & (pts.kp_idx >= 0)
        & (pts.status == W.PT_ACTIVE)
        & frames.valid[pts.host]
        & (pts.host != slot)
    )
    lvl = feats.level[slot, j].astype(jnp.float32)
    w = cfg.indirect_weight / (cfg.ind_pyr_scale ** (2.0 * lvl))
    if ind_w_scale is not None:
        w = w * ind_w_scale
    pts = pts._replace(
        ind_u=pts.ind_u.at[:, slot].set(feats.u[slot, j]),
        ind_v=pts.ind_v.at[:, slot].set(feats.v[slot, j]),
        ind_w=pts.ind_w.at[:, slot].set(w.astype(jnp.float32)),
        ind_valid=pts.ind_valid.at[:, slot].set(ok),
    )
    return window._replace(points=pts)


# ------------------------------------------------------------------ kf_step


def kf_step(
    window: W.Window,
    calib: Calib,
    imm: Imm,
    feats,                         # features.Feats per-slot keypoint store
    pyr: List[jnp.ndarray],        # new-KF direct pyramid [(Hl, Wl, 3)]
    R_new: jnp.ndarray,            # (3, 3) worldToCam of the new KF
    t_new: jnp.ndarray,            # (3,)
    aff_new: jnp.ndarray,          # (2,) natural units
    exp_new: jnp.ndarray,          # ()
    slot: jnp.ndarray,             # () int32 insertion slot
    kf_id: jnp.ndarray,            # () int32
    ref_slot: jnp.ndarray,         # () int32 energy-th seed slot (-1: default)
    flag_mask: jnp.ndarray,        # (F,) bool frames to marginalize after BA
    act_dist: jnp.ndarray,         # () float32 currentMinActDist
    n_iter: jnp.ndarray,           # () int32 GN iterations
    sel_u: jnp.ndarray,            # selector picks for makeNewTraces
    sel_v: jnp.ndarray,
    sel_type: jnp.ndarray,
    sel_valid: jnp.ndarray,
    cfg: Config,
    mesh=None,
    ind_w_scale: jnp.ndarray | None = None,  # () indirect-weight schedule
):
    """One whole keyframe insertion on device (AddKeyframe,
    Mapping.cpp:12-142). See module docstring for the stage list.

    `mesh` (optional jax.sharding.Mesh with a "points" axis): runs the
    windowed BA and the point-marginalization fold as point-sharded
    shard_maps with psum-reduced camera systems (parallel/dist_ba.py) —
    the multi-chip scaling path, enabled per-system via
    SLAMSystem(dist_mesh=...)."""
    F = cfg.max_frames
    frames = window.frames

    # 1. trace candidates into this frame (no-op before any candidates exist)
    new_trace = trace_candidates(
        imm, frames, calib.value, R_new, t_new, aff_new, exp_new, pyr[0], cfg)
    imm = imm._replace(trace=new_trace)

    # 2. indirect frontend: multi-scale keypoints + descriptors of the new
    # keyframe (Frame::CreateIndPyrs + FeatureDetector::ExtractFeatures)
    kp_u = kp_v = kp_kpidx = None
    kp_type = kp_valid = None
    if cfg.enable_indirect:
        from ..ops import features as ft
        f_u, f_v, f_lvl, f_sc, f_desc, f_val = ft.extract_multiscale(
            pyr[0][..., 0], cfg.ind_pyr_levels, cfg.max_kf_features,
            float(cfg.min_th_fast), scale=cfg.ind_pyr_scale,
            do_subpix=cfg.do_subpix, use_fast_only=cfg.use_fast,
            min_grad=float(cfg.min_grad_hist_add))
        feats = feats._replace(
            u=feats.u.at[slot].set(f_u),
            v=feats.v.at[slot].set(f_v),
            level=feats.level.at[slot].set(f_lvl),
            score=feats.score.at[slot].set(f_sc),
            desc=feats.desc.at[slot].set(f_desc),
            valid=feats.valid.at[slot].set(f_val),
        )
        # keypoints also enter the candidate stream (keypoint-hosted
        # candidates — the reference's hybrid point source)
        kp_u, kp_v = f_u, f_v
        kp_kpidx = jnp.arange(f_u.shape[0], dtype=jnp.int32)
        kp_type = jnp.ones_like(kp_kpidx)
        kp_valid = f_val

    # 3. insert the new frame into `slot`
    st = jnp.zeros(8, jnp.float32)
    scale = jnp.asarray(FRAME_STATE_SCALE)
    st = st.at[6].set(aff_new[0] / scale[6]).at[7].set(aff_new[1] / scale[7])
    eth_ref = frames.energy_th[jnp.clip(ref_slot, 0, F - 1)]
    eth = jnp.where(ref_slot >= 0, eth_ref, 12.0 * 12.0 * 8.0)
    frames = frames._replace(
        valid=frames.valid.at[slot].set(True),
        evalpt_R=frames.evalpt_R.at[slot].set(R_new),
        evalpt_t=frames.evalpt_t.at[slot].set(t_new),
        state=frames.state.at[slot].set(st),
        state_zero=frames.state_zero.at[slot].set(st),
        exposure=frames.exposure.at[slot].set(exp_new),
        prior=frames.prior.at[slot].set(jnp.asarray(W.later_frame_prior(cfg))),
        kf_id=frames.kf_id.at[slot].set(kf_id),
        images=frames.images.at[slot].set(pyr[0]),
        energy_th=frames.energy_th.at[slot].set(eth),
    )
    window = window._replace(frames=frames)

    # 4. activate candidate points
    window, imm = activate_candidates(window, calib, imm, slot, act_dist, cfg)

    # 4b. indirect association: matched-keypoint reprojection observations
    # of keypoint-hosted points in the new frame (hybrid layer)
    if cfg.enable_indirect:
        window = indirect_associate(window, feats, slot, cfg,
                                    ind_w_scale=ind_w_scale)

    # 5. optimize (point-sharded over the mesh when given)
    if mesh is None:
        result: BAResult = ba_optimize(window, calib, cfg, n_iter)
    else:
        from ..parallel.dist_ba import sharded_ba_optimize
        result = sharded_ba_optimize(mesh, window, calib, cfg, n_iter)
    window, calib = result.window, result.calib

    # 6. remove outliers (active points with no active residuals)
    pts = window.points
    has_res = jnp.sum(pts.res_state == W.RES_IN, axis=1) > 0
    new_status = jnp.where((pts.status == W.PT_ACTIVE) & ~has_res,
                           W.PT_EMPTY, pts.status)
    pts = pts._replace(status=new_status.astype(jnp.int32))
    window = window._replace(points=pts)

    # 6b. connectivity snapshot (EnergyFunctional.h:83, active counts)
    res_in_f = ((pts.res_state == W.RES_IN)
                & (pts.status == W.PT_ACTIVE)[:, None]).astype(jnp.float32)
    onehot = jax.nn.one_hot(pts.host, F, dtype=jnp.float32)
    conn_active = (onehot.T @ res_in_f).astype(jnp.int32)

    # 7. tracker template on the new reference (setCoarseTrackingRef +
    # makeCoarseDepthL0, CoarseTracker.cpp:492-504,105-263)
    weight = jnp.sqrt(1e-3 / (result.HdiF + 1e-12))
    tpl_valid = result.newest_res_in & (pts.status == W.PT_ACTIVE)
    template = trk_ops.build_template(
        result.newest_proj_u, result.newest_proj_v,
        result.newest_proj_idepth, weight, tpl_valid, pyr,
    )

    # 7b. keypoint depth lift for the loop-closure worker: nearest valid
    # level-0 template point within 3 px. Riding this dispatch means the
    # depths arrive in the SAME bundle pull — the round-3 design did a
    # separate device round-trip (+ host O(K*T) scan before that) on the
    # keyframe latency path. Indirect-off configs never consume it, so
    # skip the (NF x C0) distance matrix there.
    if cfg.enable_indirect:
        kp_id_lift, kp_d2 = trk_ops.nearest_template_depth(
            feats.u[slot], feats.v[slot],
            template.u[0], template.v[0],
            template.idepth[0], template.valid[0])
        kp_idepth = kp_id_lift
        kp_depth_ok = kp_d2 <= 9.0
    else:
        NF_ = feats.u.shape[1]
        kp_idepth = jnp.zeros(NF_, jnp.float32)
        kp_depth_ok = jnp.zeros(NF_, bool)

    # 8. flag + marginalize points
    window, removed_host, conn_marg = flag_and_marg_points(
        window, calib, flag_mask, cfg, mesh=mesh)

    # 9. new candidate traces from this keyframe; keypoint-hosted candidates
    # first (they carry the hybrid descriptor link), selector picks after
    if cfg.enable_indirect:
        all_u = jnp.concatenate([kp_u, sel_u])
        all_v = jnp.concatenate([kp_v, sel_v])
        all_type = jnp.concatenate([kp_type, sel_type])
        all_valid = jnp.concatenate([kp_valid, sel_valid])
        all_kp = jnp.concatenate(
            [kp_kpidx, jnp.full(sel_u.shape[0], -1, jnp.int32)])
        imm = insert_new_traces(imm, slot, all_u, all_v, all_type, all_valid,
                                pyr[0], cfg, sel_kp=all_kp)
    else:
        imm = insert_new_traces(imm, slot, sel_u, sel_v, sel_type, sel_valid,
                                pyr[0], cfg)

    # 10. marginalize flagged frames (+ drop their hosted candidates and
    # the indirect observations targeting them — the slot will be reused)
    for s in range(F):
        window = jax.lax.cond(
            flag_mask[s],
            lambda w: marginalize_frame(w, jnp.int32(s), cfg),
            lambda w: w,
            window,
        )
    imm = imm._replace(valid=imm.valid & ~flag_mask[imm.host])
    window = window._replace(points=window.points._replace(
        ind_valid=window.points.ind_valid & ~flag_mask[None, :]))

    # ------- policy bundle (ONE host pull)
    frames = window.frames
    pts = window.points
    R_f, t_f = W.frame_poses(frames)
    aff_f = W.frame_affine(frames)
    pt_active = pts.status == W.PT_ACTIVE
    n_active_host = (jnp.zeros(F, jnp.int32)
                     .at[pts.host].add(pt_active.astype(jnp.int32)))
    n_imm_host = (jnp.zeros(F, jnp.int32)
                  .at[imm.host].add(imm.valid.astype(jnp.int32)))
    bundle = KFBundle(
        rmse=result.rmse,
        valid=frames.valid,
        kf_id=frames.kf_id,
        Rwc=R_f,
        twc=t_f,
        aff=aff_f,
        exposure=frames.exposure,
        calib_value=calib.value,
        n_active=jnp.sum(pt_active),
        n_active_host=n_active_host,
        n_imm_host=n_imm_host,
        sel_count=jnp.sum(sel_valid),
        removed_host=removed_host,
        conn_active=conn_active,
        conn_marg=conn_marg,
        flow_ok=jnp.all(jnp.where(frames.valid[:, None],
                                  jnp.isfinite(t_f), True)),
        n_ind=jnp.sum(pts.ind_valid & pt_active[:, None]
                      & frames.valid[None, :]),
        kp_idepth=kp_idepth,
        kp_depth_ok=kp_depth_ok,
    )
    return window, calib, imm, feats, template, result, bundle
