"""Windowed photometric bundle adjustment — device kernels.

The numeric heart of the framework: a batched device re-design of the reference's
EnergyFunctional machinery:

  * residual linearization  (Src/OptimizationClasses.cpp:43-233)
  * pair-block Hessian accumulation + adjoint stitch
    (Src/AccumulatedTopHessian.cpp, Src/EnergyFunctional.cpp:22-82)
  * Schur complement over inverse depths (Src/AccumulatedSCHessian.cpp)
  * camera-system solve + nullspace orthogonalization
    (Src/EnergyFunctional.cpp:648-817)
  * back-substitution of idepth steps (Src/EnergyFunctional.cpp:222-274)

Design: instead of the reference's per-(host,target) 13x13 AccumulatorApprox
arrays stitched through adjoint maps, each residual gets a 4-row
*basis* in the absolute state space:

    rows = [pixel-x, pixel-y, a_rel, b_rel],  U in R^{4 x D}, D = 4 + 8 F

with per-pattern coefficients C in R^{8 x 4} = [JIdx | JabF]. The full
Gauss-Newton system is then

    H = sum_r U_r^T (C_r^T C_r) U_r ,   b = sum_r U_r^T C_r^T res_r

— one large matmul over all residuals, mathematically identical to the
reference's update/stitchDouble path (the 13x13 'AccumulatorApprox' is
exactly C^T C in a factored basis). Idepth columns factor the same way,
giving the per-point scalars Hdd, bd, Hcd and the cross vector g_p used by
the Schur complement: H_sc = sum_p g_p g_p^T / (Hdd_p + prior_p).

All quantities are kept in the reference's SOLVER units (state scaling
folded into Jacobians / adjoints) so priors, lambda handling and
marginalization match numerically.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import (
    CALIB_SCALE,
    CPARS,
    FRAME_STATE_SCALE,
    PATTERN,
    PATTERN_NUM,
    SCALE_C,
    SCALE_F,
    Config,
)
from ..models import window as W
from ..models.calib import Calib
from ..utils import lie


# ---------------------------------------------------------------------------
# adjoints: relative (host->target) 8-dof tangent -> absolute frame states
# (reference: EnergyFunctional::setAdjointsF, EnergyFunctional.cpp:22-82)
# ---------------------------------------------------------------------------


def compute_adjoints(frames: W.Frames) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Returns (AH, AT): (F, F, 8, 8) with AH[h, t] = adHost, AT[h, t] =
    adTarget, rows scaled by the solver preconditioner exactly as the
    reference (EnergyFunctional.cpp:51-58)."""
    F = frames.valid.shape[0]
    R0, t0 = frames.evalpt_R, frames.evalpt_t

    # hostToTarget[h, t] = evalPT_t * evalPT_h^-1
    Rh_inv, th_inv = lie.se3_inverse(R0, t0)
    R_ht = R0[None, :, :, :] @ Rh_inv[:, None, :, :]
    t_ht = jnp.einsum("tij,hj->hti", R0, th_inv) + t0[None, :, :]

    Adj = lie.se3_adjoint(R_ht, t_ht)  # (F, F, 6, 6)

    aff0 = (frames.state_zero * jnp.asarray(FRAME_STATE_SCALE))[:, 6:8]
    exp_ = jnp.where(frames.exposure == 0, 1.0, frames.exposure)
    # a_rel[h, t] = exp(a0_t - a0_h) * exp_t / exp_h  (GlobalTypes.h:334-346)
    a_rel = jnp.exp(aff0[None, :, 0] - aff0[:, None, 0]) * (exp_[None, :] / exp_[:, None])

    AH = jnp.zeros((F, F, 8, 8), jnp.float32)
    AT = jnp.zeros((F, F, 8, 8), jnp.float32)
    AH = AH.at[:, :, :6, :6].set(-jnp.swapaxes(Adj, -1, -2))
    AT = AT.at[:, :, :6, :6].set(jnp.eye(6))
    AH = AH.at[:, :, 6, 6].set(a_rel)
    AH = AH.at[:, :, 7, 7].set(a_rel)
    AT = AT.at[:, :, 6, 6].set(-a_rel)
    AT = AT.at[:, :, 7, 7].set(-1.0)

    row_scale = jnp.asarray(FRAME_STATE_SCALE)[:, None]
    return AH * row_scale, AT * row_scale


# ---------------------------------------------------------------------------
# linearization
# ---------------------------------------------------------------------------


class Linearization(NamedTuple):
    """Per-residual (P, F) factored Jacobians, reference RawResidualJacobian
    (Include/OptimizationClasses.h:48-77)."""

    Jpdc: jnp.ndarray      # (P, F, 2, 4) pixel wrt calib (SCALE_F/C folded in)
    Jpdxi: jnp.ndarray     # (P, F, 2, 6) pixel wrt relative pose (natural)
    Jpdd: jnp.ndarray      # (P, F, 2)   pixel wrt idepth
    JIdx: jnp.ndarray      # (P, F, 8, 2) weighted image gradient at pattern px
    JabF: jnp.ndarray      # (P, F, 8, 2) weighted affine jacobian
    resF: jnp.ndarray      # (P, F, 8)   weighted residuals
    energy: jnp.ndarray    # (P, F) robust energy (capped for OUT)
    energy_raw: jnp.ndarray  # (P, F) state_NewEnergyWithOutlier (-1 if OOB)
    new_state: jnp.ndarray   # (P, F) proposed residual state (IN/OOB/OUT)
    center_u: jnp.ndarray    # (P, F) center projection (current state)
    center_v: jnp.ndarray
    center_idepth: jnp.ndarray
    rel_bs: jnp.ndarray      # (P, F) relative baseline indicator: 0.01 * px
                             # distance between the idepth and the
                             # infinite-depth center projections
                             # (linearizeAll_Reductor, FullSystemOptimize.cpp:30-38)
    win_miss: jnp.ndarray    # (P, F) bool: residual OOB'd only because a
                             # pattern tap left its gather window (window-
                             # table path only; all-False on the packed path)
    # --- indirect (reprojection) factors: matched-keypoint observations of
    # the point in target frames (hybrid layer). Residual = current-state
    # center projection minus the detected keypoint; the FEJ pixel Jacobians
    # Jpdc/Jpdxi/Jpdd above apply to these rows directly.
    ind_res: jnp.ndarray     # (P, F, 2) pixel residual (x, y)
    ind_wgt: jnp.ndarray     # (P, F) huber-damped information weight
    ind_ok: jnp.ndarray      # (P, F) bool — usable this linearization
    ind_energy: jnp.ndarray  # (P, F) robust reprojection energy


# ---------------------------------------------------------------------------
# window tables: one gather row per (point, frame) instead of per pattern tap
# ---------------------------------------------------------------------------
#
# Gathers cost per row fetched more than per byte. linearize() needs I, dx,
# dy at 8 pattern taps for every (point, target) residual = P*F*8
# rows/GN-iteration the naive way — the single hottest op in the whole
# system. Instead we pre-slice the intensity
# image into 12x12 windows anchored at even pixel origins (stride 2), gather
# ONE window row per (point, frame) around the projected pattern center, and
# reconstruct all 8 bilinear taps AND their central-difference gradients from
# the window with separable weight vectors. Exact-equal to sampling the
# precomputed (I, dx, dy) pyramid for every in-window tap (gradients are
# central differences of I, zero only on the outermost image border, which
# proj_ok already excludes). Taps that fall outside their window (relative
# pattern warp beyond ~±3.5px, i.e. host->target scale change beyond ~1.4x)
# are flagged OOB — the reference would keep such residuals, but at that
# distortion the 8-tap pattern is no longer comparable anyway.

WIN = 12          # window side in pixels
WIN_STRIDE = 2    # window origin stride (even origins)


def build_window_table(images: jnp.ndarray) -> jnp.ndarray:
    """(F, H, W, 3) [I, dx, dy] frames -> (F * (H//2) * (W//2), WIN*WIN)
    intensity windows: row r = I[y0:y0+12, x0:x0+12] flattened, where
    r = f * (H//2) * (W//2) + (y0//2) * (W//2) + (x0//2)."""
    I = images[..., 0]
    F, H, W = I.shape
    Ip = jnp.pad(I, ((0, 0), (0, WIN), (0, WIN)))
    # two-stage separable construction: a single 144-slice stack on the minor
    # axis lowers to 4-byte strided scatter writes; two 12-slice stages with
    # one final transpose stay contiguous
    V = jnp.stack(
        [Ip[:, dy : dy + H : WIN_STRIDE, :] for dy in range(WIN)], axis=0
    )  # (12, F, H//2, W + WIN)
    T = jnp.stack(
        [V[:, :, :, dx : dx + W : WIN_STRIDE] for dx in range(WIN)], axis=0
    )  # (12dx, 12dy, F, H//2, W//2)
    tbl = jnp.transpose(T, (2, 3, 4, 1, 0))  # (F, H//2, W//2, dy, dx)
    return tbl.reshape(F * (H // 2) * (W // 2), WIN * WIN)


def _window_taps(window_table, Ku, Kv, Hh, Ww):
    """Gather one 12x12 intensity window per (p, f) and reconstruct the
    8 bilinear taps of I plus their central-difference image gradients.

    Ku, Kv: (P, F, 8) tap projections. Returns (hit_I, hit_dx, hit_dy,
    in_win) each (P, F, 8); in_win marks taps whose bilinear + gradient
    stencil is fully inside the window (callers OOB-mask the rest)."""
    P, F, K = Ku.shape
    W2 = Ww // 2
    # window origin from the warped taps' bounding-box center (NOT the center
    # tap): splits the usable interior evenly around the whole pattern, so
    # asymmetric warps (forward motion stretches taps away from the center)
    # and host->target scale changes up to ~2.2x stay inside the window,
    # vs ~1.4x when anchoring on tap 4
    bbx = 0.5 * (jnp.max(Ku, axis=-1) + jnp.min(Ku, axis=-1))
    bby = 0.5 * (jnp.max(Kv, axis=-1) + jnp.min(Kv, axis=-1))
    gx = jnp.floor(bbx).astype(jnp.int32)
    gy = jnp.floor(bby).astype(jnp.int32)
    x0 = jnp.clip(2 * ((gx - 5) // 2), 0, Ww - WIN)
    y0 = jnp.clip(2 * ((gy - 5) // 2), 0, Hh - WIN)
    widx = (jnp.arange(F, dtype=jnp.int32)[None, :] * ((Hh // 2) * W2)
            + (y0 // 2) * W2 + (x0 // 2))                       # (P, F)
    win = window_table[widx].reshape(P, F, WIN, WIN)            # y, x

    # local tap coordinates inside the window
    lx = Ku - x0[..., None].astype(jnp.float32)                 # (P, F, 8)
    ly = Kv - y0[..., None].astype(jnp.float32)
    ix = jnp.floor(lx).astype(jnp.int32)
    iy = jnp.floor(ly).astype(jnp.int32)
    in_win = (ix >= 1) & (ix <= WIN - 3) & (iy >= 1) & (iy <= WIN - 3)
    ixc = jnp.clip(ix, 1, WIN - 3)
    iyc = jnp.clip(iy, 1, WIN - 3)
    fx = jnp.clip(lx - ixc, 0.0, 1.0)
    fy = jnp.clip(ly - iyc, 0.0, 1.0)

    iota = jnp.arange(WIN, dtype=jnp.int32)
    def hat(i, f):
        # (P, F, 8, WIN) bilinear hat: (1-f) at i, f at i+1
        oh0 = (iota == i[..., None]).astype(jnp.float32)
        oh1 = (iota == (i[..., None] + 1)).astype(jnp.float32)
        return oh0 * (1.0 - f[..., None]) + oh1 * f[..., None]

    def cdiff(i, f):
        # central-difference-of-I sampled bilinearly:
        # 0.5*[(1-f)*(e_{i+1}-e_{i-1}) + f*(e_{i+2}-e_i)]
        ohm = (iota == (i[..., None] - 1)).astype(jnp.float32)
        oh0 = (iota == i[..., None]).astype(jnp.float32)
        oh1 = (iota == (i[..., None] + 1)).astype(jnp.float32)
        oh2 = (iota == (i[..., None] + 2)).astype(jnp.float32)
        return 0.5 * ((oh1 - ohm) * (1.0 - f[..., None]) + (oh2 - oh0) * f[..., None])

    wx = hat(ixc, fx)
    wy = hat(iyc, fy)
    cx = cdiff(ixc, fx)
    cy = cdiff(iyc, fy)

    # broadcast-multiply-sums, NOT einsum/dot: these tiny batched matmuls
    # are kept as elementwise reductions over (P,F,8,12,12) intermediates
    # (whether einsum is faster on the GPU is open)
    winb = win[:, :, None, :, :]                  # (P, F, 1, y, x)
    tx_w = jnp.sum(wy[..., :, None] * winb, axis=-2)   # (P, F, 8, x)
    tx_c = jnp.sum(cy[..., :, None] * winb, axis=-2)
    hit_I = jnp.sum(tx_w * wx, axis=-1)
    hit_dx = jnp.sum(tx_w * cx, axis=-1)
    hit_dy = jnp.sum(tx_c * wx, axis=-1)
    return hit_I, hit_dx, hit_dy, in_win


def pack_image_stack(images: jnp.ndarray) -> jnp.ndarray:
    """Pre-pack every frame's (H, W, 3) [I, dx, dy] into per-pixel 2x2
    interpolation cells -> (F, H, W, 3, 4). Loop-invariant during one
    optimize() call: XLA cannot hoist it out of the GN while_loop because
    the frame pytree is loop-carried, so callers pack once and close over
    the result (saves ~F*H*W*48B of HBM churn per GN iteration)."""
    from ..utils.interp import pack_cells

    return jax.vmap(
        lambda img: jnp.stack([pack_cells(img[..., c]) for c in range(3)], axis=2)
    )(images)


def linearize(
    frames: W.Frames,
    points: W.Points,
    calib: Calib,
    cfg: Config,
    packed_images: jnp.ndarray | None = None,
    window_table: jnp.ndarray | None = None,
) -> Linearization:
    """Relinearize every (point, target-frame) residual at the current state
    with first-estimate (FEJ) geometric Jacobians.

    Mirrors PointFrameResidual::linearize (OptimizationClasses.cpp:43-233):
    geometric Jacobians at (evalPT poses, idepth_zero); intensity residuals
    at (current poses, current idepth, current affine).
    """
    F = frames.valid.shape[0]
    P = points.u.shape[0]
    Hh, Ww = frames.images.shape[1], frames.images.shape[2]

    fx, fy, cx, cy = calib.value[0], calib.value[1], calib.value[2], calib.value[3]

    # --- per-(h,t) precalc (FrameFramePrecalc::set, OptimizationClasses.cpp:13-39)
    R_cur, t_cur = W.frame_poses(frames)             # current worldToCam
    R0, t0 = frames.evalpt_R, frames.evalpt_t        # FEJ worldToCam
    aff = W.frame_affine(frames)
    aff0 = W.frame_affine_zero(frames)
    exp_ = jnp.where(frames.exposure == 0, 1.0, frames.exposure)

    def rel(Ra, ta, Rb, tb):
        # T_ab[h, t] = T_b[t] * T_a[h]^-1  (host h -> target t)
        Ri, ti = lie.se3_inverse(Ra, ta)
        Rr = Rb[None] @ Ri[:, None]
        tr = jnp.einsum("tij,hj->hti", Rb, ti) + tb[None]
        return Rr, tr

    PRE_R0, PRE_t0 = rel(R0, t0, R0, t0)             # (F,F,3,3),(F,F,3) FEJ
    PRE_R, PRE_t = rel(R_cur, t_cur, R_cur, t_cur)   # current

    a_rel = jnp.exp(aff[None, :, 0] - aff[:, None, 0]) * (exp_[None, :] / exp_[:, None])
    b_rel = aff[None, :, 1] - a_rel * aff[:, None, 1]
    b0_host = aff0[:, 1]                              # PRE_b0_mode per host

    # gather per-point host quantities
    h_idx = points.host
    Rr0 = PRE_R0[h_idx]       # (P, F, 3, 3)
    tr0 = PRE_t0[h_idx]       # (P, F, 3)
    Rr = PRE_R[h_idx]
    tr = PRE_t[h_idx]
    a_pf = a_rel[h_idx]       # (P, F)
    b_pf = b_rel[h_idx]
    b0_p = b0_host[h_idx]     # (P,)

    # --- FEJ center projection (OptimizationClasses.cpp:70-122)
    KliP = jnp.stack(
        [(points.u - cx) / fx, (points.v - cy) / fy, jnp.ones_like(points.u)],
        axis=-1,
    )  # (P, 3)
    # broadcast form, not einsum: (P,F)-batched 3x3 matvecs
    ptp0 = (jnp.sum(Rr0 * KliP[:, None, None, :], axis=-1)
            + tr0 * points.idepth_zero[:, None, None])
    drescale = 1.0 / jnp.where(jnp.abs(ptp0[..., 2]) < 1e-12, 1e-12, ptp0[..., 2])
    new_idepth0 = points.idepth_zero[:, None] * drescale
    u_n = ptp0[..., 0] * drescale
    v_n = ptp0[..., 1] * drescale
    Ku0 = u_n * fx + cx
    Kv0 = v_n * fy + cy
    fej_ok = (
        (drescale > 0)
        & (Ku0 > 1.1) & (Kv0 > 1.1) & (Ku0 < Ww - 3) & (Kv0 < Hh - 3)
    )

    # idepth jacobian (OptimizationClasses.cpp:85-86)
    d_d_x = drescale * (tr0[..., 0] - tr0[..., 2] * u_n) * fx
    d_d_y = drescale * (tr0[..., 1] - tr0[..., 2] * v_n) * fy
    Jpdd = jnp.stack([d_d_x, d_d_y], axis=-1)  # (P, F, 2)

    # calib jacobian (OptimizationClasses.cpp:88-107), SCALE_F/SCALE_C folded
    R00, R01 = Rr0[..., 0, 0], Rr0[..., 0, 1]
    R10, R11 = Rr0[..., 1, 0], Rr0[..., 1, 1]
    R20, R21 = Rr0[..., 2, 0], Rr0[..., 2, 1]
    dCx2 = drescale * (R20 * u_n - R00)
    dCx3 = fx * drescale * (R21 * u_n - R01) / fy
    dCx0 = KliP[:, None, 0] * dCx2
    dCx1 = KliP[:, None, 1] * dCx3
    dCy2 = fy * drescale * (R20 * v_n - R10) / fx
    dCy3 = drescale * (R21 * v_n - R11)
    dCy0 = KliP[:, None, 0] * dCy2
    dCy1 = KliP[:, None, 1] * dCy3
    Jpdc = jnp.stack(
        [
            jnp.stack([(dCx0 + u_n) * SCALE_F, dCx1 * SCALE_F,
                       (dCx2 + 1.0) * SCALE_C, dCx3 * SCALE_C], axis=-1),
            jnp.stack([dCy0 * SCALE_F, (dCy1 + v_n) * SCALE_F,
                       dCy2 * SCALE_C, (dCy3 + 1.0) * SCALE_C], axis=-1),
        ],
        axis=-2,
    )  # (P, F, 2, 4)

    # pose jacobian (OptimizationClasses.cpp:109-121), natural units
    zero = jnp.zeros_like(u_n)
    Jpdxi = jnp.stack(
        [
            jnp.stack([new_idepth0 * fx, zero, -new_idepth0 * u_n * fx,
                       -u_n * v_n * fx, (1.0 + u_n * u_n) * fx, -v_n * fx], axis=-1),
            jnp.stack([zero, new_idepth0 * fy, -new_idepth0 * v_n * fy,
                       -(1.0 + v_n * v_n) * fy, u_n * v_n * fy, u_n * fy], axis=-1),
        ],
        axis=-2,
    )  # (P, F, 2, 6)

    # --- current-state pattern projection + residuals
    # (OptimizationClasses.cpp:141-204)
    # project all 8 pattern pixels: pt = R K^-1 (u+dx, v+dy, 1) + t * id
    pat = jnp.asarray(PATTERN, jnp.float32)  # (8, 2)
    up = points.u[:, None] + pat[None, :, 0]   # (P, 8)
    vp = points.v[:, None] + pat[None, :, 1]
    # K^-1 (u, v, 1)
    xh = (up - cx) / fx
    yh = (vp - cy) / fy
    # R Kinv p  -> (P, F, 8, 3)
    dirs = jnp.stack([xh, yh, jnp.ones_like(xh)], axis=-1)       # (P, 8, 3)
    # rot[p,f,k,i] = sum_j Rr[p,f,i,j] dirs[p,k,j] — broadcast, not einsum
    rot = jnp.sum(Rr[:, :, None, :, :] * dirs[:, None, :, None, :], axis=-1)
    ptp = rot + tr[:, :, None, :] * points.idepth[:, None, None, None]
    z = jnp.where(jnp.abs(ptp[..., 2]) < 1e-12, 1e-12, ptp[..., 2])
    Ku = fx * ptp[..., 0] / z + cx     # (P, F, 8)
    Kv = fy * ptp[..., 1] / z + cy
    proj_ok = (Ku > 1.1) & (Kv > 1.1) & (Ku < Ww - 3) & (Kv < Hh - 3)

    # center projection at current state (pattern index 4 is (0,0))
    center_u = Ku[..., 4]
    center_v = Kv[..., 4]
    center_idepth = points.idepth[:, None] / z[..., 4]

    # relative-baseline indicator: px distance between the real-depth and the
    # infinite-depth projections of the center pixel, scaled by 0.01
    # (linearizeAll_Reductor, FullSystemOptimize.cpp:30-38)
    rot_c = rot[..., 4, :]                       # (P, F, 3) = R K^-1 (u,v,1)
    z_inf = jnp.where(jnp.abs(rot_c[..., 2]) < 1e-12, 1e-12, rot_c[..., 2])
    u_inf = fx * rot_c[..., 0] / z_inf + cx
    v_inf = fy * rot_c[..., 1] / z_inf + cy
    rel_bs = 0.01 * jnp.sqrt(
        (u_inf - center_u) ** 2 + (v_inf - center_v) ** 2
    )

    # gather target intensities + gradients: preferred path is ONE window row
    # per (point, frame) (see build_window_table); fallback is a packed-cell
    # row gather per tap (utils.interp)
    win_ok = None
    if window_table is not None:
        hit_I, hit_dx, hit_dy, in_win = _window_taps(window_table, Ku, Kv, Hh, Ww)
        win_ok = jnp.all(in_win, axis=-1)
    else:
        if packed_images is None:
            packed_images = pack_image_stack(frames.images)

        def gather_frame(packed, KuF, KvF):
            # packed (H, W, 3, 4); KuF/KvF (P, 8)
            Kuc = jnp.clip(KuF, 0.0, Ww - 1.001)
            Kvc = jnp.clip(KvF, 0.0, Hh - 1.001)
            ix = jnp.clip(jnp.floor(Kuc).astype(jnp.int32), 0, Ww - 2)
            iy = jnp.clip(jnp.floor(Kvc).astype(jnp.int32), 0, Hh - 2)
            dxf = Kuc - ix
            dyf = Kvc - iy
            cells = packed.reshape(Hh * Ww, 3, 4)[iy * Ww + ix]   # (P, 8, 3, 4)
            wx = dxf[..., None]
            wy = dyf[..., None]
            top = cells[..., 0] * (1 - wx) + cells[..., 1] * wx
            bot = cells[..., 2] * (1 - wx) + cells[..., 3] * wx
            return top * (1 - wy) + bot * wy

        hit = jax.vmap(gather_frame, in_axes=(0, 1, 1), out_axes=1)(
            packed_images, Ku, Kv
        )  # (P, F, 8, 3)
        hit_I, hit_dx, hit_dy = hit[..., 0], hit[..., 1], hit[..., 2]

    residual = hit_I - (a_pf[..., None] * points.color[:, None, :] + b_pf[..., None])
    drdA = points.color[:, None, :] - b0_p[:, None, None]       # (P, F, 8)

    # weights (OptimizationClasses.cpp:163-164)
    c_w = cfg.outlier_th_sum_component
    w_grad = jnp.sqrt(c_w / (c_w + hit_dx**2 + hit_dy**2))
    w = 0.5 * (w_grad + points.weight[:, None, :])

    abs_r = jnp.abs(residual)
    hw = jnp.where(abs_r < cfg.huber_th, 1.0, cfg.huber_th / jnp.maximum(abs_r, 1e-12))
    energy_terms = w * w * hw * residual * residual * (2.0 - hw)

    hw_j = jnp.where(hw < 1.0, jnp.sqrt(hw), hw) * w

    JIdx = jnp.stack([hit_dx * hw_j, hit_dy * hw_j], axis=-1)    # (P, F, 8, 2)
    JabF = jnp.stack([drdA * hw_j, hw_j], axis=-1)               # (P, F, 8, 2)
    resF = residual * hw_j

    wJI2 = jnp.sum((hw_j * hit_dx) ** 2 + (hw_j * hit_dy) ** 2, axis=-1)

    # --- state machine (OptimizationClasses.cpp:219-231)
    oob = (
        ~fej_ok
        | ~jnp.all(proj_ok, axis=-1)
        | ~jnp.all(jnp.isfinite(hit_I), axis=-1)
    )
    if win_ok is not None:
        # taps beyond the gather window are OOB'd only on the window path —
        # expose the extra-masked set so callers can monitor the divergence
        # from the reference (which keeps such residuals)
        win_miss = ~oob & ~win_ok
        oob = oob | ~win_ok
    else:
        win_miss = jnp.zeros_like(oob)
    energy_raw = jnp.sum(energy_terms, axis=-1)
    th = jnp.maximum(frames.energy_th[h_idx][:, None], frames.energy_th[None, :])
    out = (energy_raw > th) | (wJI2 < 2.0)
    energy = jnp.where(out, th, energy_raw)
    new_state = jnp.where(
        oob, W.RES_OOB, jnp.where(out, W.RES_OUT, W.RES_IN)
    ).astype(jnp.int32)
    energy_raw = jnp.where(oob, -1.0, energy_raw)

    # --- indirect reprojection factors (hybrid layer): residual between the
    # current-state center projection and the matched detector keypoint.
    # Same FEJ pixel Jacobians as the photometric rows; Huber in pixels.
    center_ok = (
        (z[..., 4] > 0) & fej_ok
        & (center_u > 1.1) & (center_v > 1.1)
        & (center_u < Ww - 3) & (center_v < Hh - 3)
    )
    ind_rx = center_u - points.ind_u
    ind_ry = center_v - points.ind_v
    ind_e2 = ind_rx * ind_rx + ind_ry * ind_ry
    ind_r = jnp.sqrt(jnp.maximum(ind_e2, 1e-20))
    ihw = jnp.where(ind_r < cfg.indirect_huber_px, 1.0,
                    cfg.indirect_huber_px / ind_r)
    ind_wgt = points.ind_w * ihw
    ind_ok = (points.ind_valid & center_ok
              & (ind_r < cfg.indirect_gate_px))
    ind_energy = points.ind_w * ihw * ind_e2 * (2.0 - ihw)

    return Linearization(
        Jpdc=Jpdc, Jpdxi=Jpdxi, Jpdd=Jpdd,
        JIdx=JIdx, JabF=JabF, resF=resF,
        energy=energy, energy_raw=energy_raw, new_state=new_state,
        center_u=center_u, center_v=center_v, center_idepth=center_idepth,
        rel_bs=rel_bs, win_miss=win_miss,
        ind_res=jnp.stack([ind_rx, ind_ry], axis=-1),
        ind_wgt=ind_wgt, ind_ok=ind_ok, ind_energy=ind_energy,
    )


# ---------------------------------------------------------------------------
# accumulation
# ---------------------------------------------------------------------------


class GNSystem(NamedTuple):
    H: jnp.ndarray        # (D, D) absolute top Hessian (no priors/HM/SC)
    b: jnp.ndarray        # (D,)
    Hdd: jnp.ndarray      # (P,)
    bd: jnp.ndarray       # (P,)
    g: jnp.ndarray        # (P, D) idepth cross rows (calib part == Hcd)
    num_res: jnp.ndarray  # () number of active residuals


def accumulate(
    lin: Linearization,
    active: jnp.ndarray,      # (P, F) bool — residuals to accumulate
    host: jnp.ndarray,        # (P,) host slot
    AH: jnp.ndarray,          # (F, F, 8, 8)
    AT: jnp.ndarray,
    n_frames: int,
    ind_active: jnp.ndarray | None = None,   # (P, F) bool — indirect factors
) -> GNSystem:
    """Assemble the absolute GN system from factored Jacobians.

    Two-stage, like the reference: per-(host, target) pair blocks in the
    *relative* 12-dim basis [4 calib | 6 se3 | a | b] (the reference's 13x13
    AccumulatorApprox minus the residual column), grouped by host slot with
    a one-hot contraction, then a tiny (F, F)-batched adjoint stitch into
    the (D, D) absolute system (stitchDoubleInternal,
    AccumulatedTopHessian.cpp:148-280). This avoids materializing any
    (P, F, 4, D) absolute basis — the largest intermediate is (P, F, 12, 12).

    `ind_active` enables the hybrid reprojection factors of `lin.ind_res`:
    they live on the pixel rows (0, 1) of the same 4-row basis (their
    Jacobian IS the pixel Jacobian), so they enter as diagonal additions to
    the per-residual normal-matrix M and gradient mvec — everything
    downstream (pair blocks, adjoint stitch, Schur scalars, idepth cross
    rows) handles them with no further changes.
    """
    P, F = active.shape
    D = CPARS + 8 * F

    m = active.astype(jnp.float32)

    # NOTE on the contraction style throughout this function: every
    # per-residual contraction is written as broadcast-multiply + sum, NOT
    # einsum/dot, so a (P*F)-batched product of 4/8/12-sized operands never
    # becomes a batch of tiny padded matmuls. The only real matmuls (the
    # one-hot host contraction, the Schur g^T g) keep einsum/dot. Whether
    # einsum is as fast on the GPU has not been measured.

    # basis coefficients C (P, F, 8, 4) and products
    C = jnp.concatenate([lin.JIdx, lin.JabF], axis=-1)          # (P, F, 8, 4)
    M = jnp.sum(C[..., :, :, None] * C[..., :, None, :], axis=2)  # (P, F, 4, 4)
    mvec = jnp.sum(C * lin.resF[..., None], axis=2)             # (P, F, 4)

    # relative basis rows B (P, F, 4, 12): cols [0:4] calib, [4:12] rel 8-dof
    #   rows 0, 1: [Jpdc | Jpdxi, 0, 0]; row 2: e_a; row 3: e_b
    B = jnp.zeros((P, F, 4, 12), jnp.float32)
    B = B.at[:, :, 0:2, 0:4].set(lin.Jpdc)
    B = B.at[:, :, 0:2, 4:10].set(lin.Jpdxi)
    B = B.at[:, :, 2, 10].set(1.0)
    B = B.at[:, :, 3, 11].set(1.0)

    # mask inactive residuals
    Mw = M * m[..., None, None]
    mw = mvec * m[..., None]

    # indirect reprojection factors: w on the pixel-row diagonal, w*res in
    # the pixel rows of the gradient
    if ind_active is not None:
        iw = lin.ind_wgt * ind_active.astype(jnp.float32)
        Mw = Mw.at[..., 0, 0].add(iw).at[..., 1, 1].add(iw)
        mw = (mw.at[..., 0].add(iw * lin.ind_res[..., 0])
                .at[..., 1].add(iw * lin.ind_res[..., 1]))

    # per-residual relative blocks, then group by host slot
    MB = jnp.sum(Mw[..., :, :, None] * B[..., None, :, :], axis=3)   # (P, F, 4, 12)
    G = jnp.sum(B[..., :, :, None] * MB[..., :, None, :], axis=2)    # (P, F, 12, 12)
    host_onehot = jax.nn.one_hot(host, F, dtype=jnp.float32)    # (P, F)
    Hrel = jnp.einsum("ph,pfij->hfij", host_onehot, G)          # (F, F, 12, 12)
    brel_r = jnp.sum(B * mw[..., :, None], axis=2)              # (P, F, 12)
    brel = jnp.einsum("ph,pfj->hfj", host_onehot, brel_r)       # (F, F, 12)

    # --- adjoint stitch (relative pair blocks -> absolute (D, D))
    # row basis maps as U_h = B_rel @ AH^T, U_t = B_rel @ AT^T, so
    # H_abs(h, h) = AH Hrr AH^T etc. (64 pairs of 8x8 matmuls — trivial)
    Hcc = jnp.sum(Hrel[:, :, 0:4, 0:4], axis=(0, 1))            # (4, 4)
    Hcr = Hrel[:, :, 0:4, 4:12]                                 # (F, F, 4, 8)
    Hrr = Hrel[:, :, 4:12, 4:12]                                # (F, F, 8, 8)

    def _abT(X, Y):
        # (..., c, r), (..., s, r) -> (..., c, s): X @ Y^T rowwise
        return jnp.sum(X[..., :, None, :] * Y[..., None, :, :], axis=-1)

    def _ab(X, Y):
        # (..., i, r), (..., r, s) -> (..., i, s)
        return jnp.sum(X[..., :, :, None] * Y[..., None, :, :], axis=-2)

    Hch = _abT(Hcr, AH)                                         # (F, F, 4, 8)
    Hct = _abT(Hcr, AT)
    HrrAHt = _abT(Hrr, AH)                                      # Hrr @ AH^T
    HrrATt = _abT(Hrr, AT)
    Hhh = _ab(AH, HrrAHt)                                       # AH Hrr AH^T
    Htt = _ab(AT, HrrATt)
    Hht = _ab(AH, HrrATt)                                       # AH Hrr AT^T

    # frame-block matrix (F, F, 8, 8): off-diagonal from ordered pairs
    # (both (g1,g2) and (g2,g1) pair groups contribute), diagonal from the
    # host-host and target-target sums
    Hframes = Hht + jnp.swapaxes(jnp.swapaxes(Hht, 0, 1), 2, 3)
    diag_blocks = jnp.sum(Hhh, axis=1) + jnp.sum(Htt, axis=0)   # (F, 8, 8)
    eyeF = jnp.eye(F, dtype=jnp.float32)
    Hframes = Hframes + eyeF[:, :, None, None] * diag_blocks[:, None, :, :]

    Hcf = jnp.sum(Hch, axis=1) + jnp.sum(Hct, axis=0)           # (F, 4, 8)

    H = jnp.zeros((D, D), jnp.float32)
    H = H.at[:CPARS, :CPARS].set(Hcc)
    Hcf_flat = jnp.swapaxes(Hcf, 0, 1).reshape(CPARS, 8 * F)
    H = H.at[:CPARS, CPARS:].set(Hcf_flat)
    H = H.at[CPARS:, :CPARS].set(Hcf_flat.T)
    H = H.at[CPARS:, CPARS:].set(
        jnp.swapaxes(Hframes, 1, 2).reshape(8 * F, 8 * F)
    )

    def _mv(X, y):
        # (..., s, r), (..., r) -> (..., s)
        return jnp.sum(X * y[..., None, :], axis=-1)

    b_c = jnp.sum(brel[:, :, 0:4], axis=(0, 1))                 # (4,)
    br = brel[:, :, 4:12]                                       # (F, F, 8)
    b_frames = (
        jnp.sum(_mv(AH, br), axis=1)                            # host rows
        + jnp.sum(_mv(AT, br), axis=0)                          # target rows
    )  # (F, 8)
    b = jnp.concatenate([b_c, b_frames.reshape(-1)])

    # idepth basis coefficients -> per-point Schur scalars + cross rows
    V_d = jnp.concatenate(
        [lin.Jpdd, jnp.zeros((P, F, 2), jnp.float32)], axis=-1
    )  # (P, F, 4)
    MV = _mv(Mw, V_d)                                           # (P, F, 4)
    Hdd = jnp.sum(V_d * MV, axis=(1, 2))
    bd = jnp.sum(V_d * mw, axis=(1, 2))

    grel = jnp.sum(B * MV[..., :, None], axis=2)                # (P, F, 12)
    g_c = jnp.sum(grel[:, :, 0:4], axis=1)                      # (P, 4)
    gr = grel[:, :, 4:12]                                       # (P, F, 8)
    AH_pf = AH[host]                                            # (P, F, 8, 8)
    AT_pf = AT[host]
    g_t = _mv(AT_pf, gr)                                        # (P, F, 8)
    g_h = jnp.sum(_mv(AH_pf, gr), axis=1)                       # (P, 8)
    g_frames = g_t + host_onehot[:, :, None] * g_h[:, None, :]
    g = jnp.concatenate([g_c, g_frames.reshape(P, 8 * F)], axis=-1)

    return GNSystem(
        H=H, b=b, Hdd=Hdd, bd=bd, g=g,
        num_res=jnp.sum(m),
    )


def schur_complement(sys: GNSystem, point_prior: jnp.ndarray,
                     point_active: jnp.ndarray):
    """H_sc, b_sc, HdiF (AccumulatedSCHessian.cpp:10-52, stitch :54-195)."""
    Hdd_total = sys.Hdd + point_prior
    HdiF = jnp.where(point_active, 1.0 / jnp.maximum(Hdd_total, 1e-10), 0.0)
    gw = sys.g * HdiF[:, None]
    H_sc = sys.g.T @ gw
    b_sc = gw.T @ sys.bd
    return H_sc, b_sc, HdiF


def resubstitute(sys: GNSystem, HdiF: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Per-point idepth steps: step_p = -HdiF_p (bd_p - g_p . x)
    (EnergyFunctional::resubstituteFPt, EnergyFunctional.cpp:249-274;
    note frame steps are -x so g.x enters with a minus)."""
    return -HdiF * (sys.bd - sys.g @ x)


# ---------------------------------------------------------------------------
# nullspaces + orthogonalization (FullSystemOptimize.cpp:616-670,
# EnergyFunctional.cpp:648-702)
# ---------------------------------------------------------------------------


def nullspaces(frames: W.Frames) -> jnp.ndarray:
    """(D, 7) stacked gauge directions: 6 rigid + 1 scale, in solver units.

    Per frame: nullspaces_pose = Adj(worldToCam_evalPT) (the reference
    computes this by central differences, Frame.h:151-166 — analytically it
    is the adjoint), nullspaces_scale = [t_evalPT, 0]."""
    F = frames.valid.shape[0]
    D = CPARS + 8 * F
    Adj = lie.se3_adjoint(frames.evalpt_R, frames.evalpt_t)   # (F, 6, 6)
    inv_scale = 1.0 / jnp.asarray(FRAME_STATE_SCALE[:6])

    ns = jnp.zeros((D, 7), jnp.float32)
    valid = frames.valid.astype(jnp.float32)
    for i in range(6):
        col = Adj[:, :, i] * inv_scale[None, :] * valid[:, None]   # (F, 6)
        pad = jnp.zeros((F, 2), jnp.float32)
        vec = jnp.concatenate([col, pad], axis=-1).reshape(-1)
        ns = ns.at[CPARS:, i].set(vec)
    scale_dir = jnp.concatenate(
        [frames.evalpt_t * inv_scale[None, :3] * valid[:, None],
         jnp.zeros((F, 5), jnp.float32)],
        axis=-1,
    ).reshape(-1)
    ns = ns.at[CPARS:, 6].set(scale_dir)
    return ns


def nullspace_projector(N: jnp.ndarray, svd_eps: float = 1e-5) -> jnp.ndarray:
    """(D, D) orthogonal projector onto span(N) via SVD pseudo-inverse
    (EnergyFunctional::orthogonalize, EnergyFunctional.cpp:648-702).
    Loop-invariant during one optimize() call — compute once, apply often
    (small-matrix SVDs are expensive on an accelerator)."""
    norms = jnp.linalg.norm(N, axis=0, keepdims=True)
    Nn = N / jnp.maximum(norms, 1e-12)
    U_, S, Vt = jnp.linalg.svd(Nn, full_matrices=False)
    S_max = jnp.max(S)
    S_inv = jnp.where(S > svd_eps * S_max, 1.0 / jnp.maximum(S, 1e-20), 0.0)
    proj = U_ @ ((S_inv * S)[:, None] * U_.T)
    return 0.5 * (proj + proj.T)


def orthogonalize(vec: jnp.ndarray, N: jnp.ndarray, svd_eps: float = 1e-5):
    """Project `vec` off the span of nullspace columns N."""
    return vec - nullspace_projector(N, svd_eps) @ vec


# ---------------------------------------------------------------------------
# linearized (mode-1) residuals: frozen Jacobians + res_toZero
# ---------------------------------------------------------------------------
#
# Reference semantics (verified against the control flow, not just the class
# definitions): `isLinearized = true` is set in exactly ONE place —
# System::flagPointsForRemoval (Src/Mapping.cpp:287-292), on the residuals of
# points that are flagged toMarg/toDrop and removed from the active set by
# ef->marginalizePointsF in the SAME AddKeyframe pass. System::optimize builds
# activeResiduals from !isLinearized residuals (FullSystemOptimize.cpp:375-390)
# — so by the time the next optimize() runs, no linearized residual exists and
# `numLRes` is always 0. The mode-1 accumulation path
# (AccumulatedTopHessian.cpp:39-141 mode 1, EnergyFunctional::calcLEnergyPt
# :289-347) is therefore exercised by the reference ONLY through mode 2
# (marginalization, resApprox = res_toZeroF at delta == 0). Relinearizing
# every surviving residual each optimize() — what ba_optimize does — is the
# reference's actual behavior.
#
# The machinery below implements the full mode-1 path anyway (frozen J,
# resApprox = res_toZero + J * delta, linearized energy) so the capability is
# available and parity-testable: ba_optimize accepts an optional frozen set.


class FrozenResiduals(NamedTuple):
    """Residuals with fixed linearization (EFResidual with isLinearized,
    Include/OptimizationClasses.h:145-153): Jacobian blocks frozen at the
    moment of fixing, plus res_toZero (the residual extrapolated back to the
    zero-delta point)."""

    Jpdc: jnp.ndarray         # (P, F, 2, 4)
    Jpdxi: jnp.ndarray        # (P, F, 2, 6)
    Jpdd: jnp.ndarray         # (P, F, 2)
    JIdx: jnp.ndarray         # (P, F, 8, 2)
    JabF: jnp.ndarray         # (P, F, 8, 2)
    res_toZero: jnp.ndarray   # (P, F, 8)
    is_linearized: jnp.ndarray  # (P, F) bool


def pair_deltas(frames: W.Frames, calib: Calib, AH: jnp.ndarray,
                AT: jnp.ndarray):
    """Per-(host, target) relative state deltas in solver units
    (EnergyFunctional::setDeltaF adHTdeltaF, EnergyFunctional.cpp:128-152)
    plus the calib delta. Returns (dp (F, F, 8), c_delta (4,))."""
    f_delta = (frames.state - frames.state_zero) * frames.valid[:, None]
    dp = (
        jnp.einsum("hfij,hi->hfj", AH, f_delta)
        + jnp.einsum("hfij,fi->hfj", AT, f_delta)
    )
    c_delta = (calib.value - calib.value_zero) / jnp.asarray(CALIB_SCALE)
    return dp, c_delta


def _jp_delta(lin_or_frozen, dp_pf: jnp.ndarray, c_delta: jnp.ndarray,
              d_delta: jnp.ndarray):
    """Jp * delta for both pixel rows: (P, F) each. d_delta (P,) is the
    idepth delta (deltaF) — identically zero under the repo's invariant
    idepth_zero := idepth at every accepted step, but kept for parity with
    the reference algebra (OptimizationClasses.cpp:261-268)."""
    jx = (
        jnp.sum(lin_or_frozen.Jpdxi[:, :, 0] * dp_pf[..., :6], axis=-1)
        + lin_or_frozen.Jpdc[:, :, 0] @ c_delta
        + lin_or_frozen.Jpdd[..., 0] * d_delta[:, None]
    )
    jy = (
        jnp.sum(lin_or_frozen.Jpdxi[:, :, 1] * dp_pf[..., :6], axis=-1)
        + lin_or_frozen.Jpdc[:, :, 1] @ c_delta
        + lin_or_frozen.Jpdd[..., 1] * d_delta[:, None]
    )
    return jx, jy


def fix_linearization(
    lin: Linearization,
    frames: W.Frames,
    calib: Calib,
    host: jnp.ndarray,        # (P,)
    is_linearized: jnp.ndarray,  # (P, F) bool
    AH: jnp.ndarray,
    AT: jnp.ndarray,
    d_delta: jnp.ndarray | None = None,
) -> FrozenResiduals:
    """fixLinearizationF (OptimizationClasses.cpp:258-284):
    res_toZero = resF - [JI*Jp | Jab] * delta, J frozen as-is."""
    P = lin.resF.shape[0]
    dp, c_delta = pair_deltas(frames, calib, AH, AT)
    dp_pf = dp[host]
    if d_delta is None:
        d_delta = jnp.zeros(P, jnp.float32)
    jx, jy = _jp_delta(lin, dp_pf, c_delta, d_delta)
    res_to_zero = (
        lin.resF
        - lin.JIdx[..., 0] * jx[..., None]
        - lin.JIdx[..., 1] * jy[..., None]
        - lin.JabF[..., 0] * dp_pf[..., None, 6]
        - lin.JabF[..., 1] * dp_pf[..., None, 7]
    )
    return FrozenResiduals(
        Jpdc=lin.Jpdc, Jpdxi=lin.Jpdxi, Jpdd=lin.Jpdd,
        JIdx=lin.JIdx, JabF=lin.JabF, res_toZero=res_to_zero,
        is_linearized=is_linearized,
    )


def frozen_resapprox(
    frozen: FrozenResiduals,
    frames: W.Frames,
    calib: Calib,
    host: jnp.ndarray,
    AH: jnp.ndarray,
    AT: jnp.ndarray,
    d_delta: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Mode-1 resApprox = res_toZero + [JI*Jp | Jab] * delta at the CURRENT
    state (AccumulatedTopHessian.cpp:62-81)."""
    P = frozen.res_toZero.shape[0]
    dp, c_delta = pair_deltas(frames, calib, AH, AT)
    dp_pf = dp[host]
    if d_delta is None:
        d_delta = jnp.zeros(P, jnp.float32)
    jx, jy = _jp_delta(frozen, dp_pf, c_delta, d_delta)
    return (
        frozen.res_toZero
        + frozen.JIdx[..., 0] * jx[..., None]
        + frozen.JIdx[..., 1] * jy[..., None]
        + frozen.JabF[..., 0] * dp_pf[..., None, 6]
        + frozen.JabF[..., 1] * dp_pf[..., None, 7]
    )


def accumulate_frozen(
    frozen: FrozenResiduals,
    frames: W.Frames,
    calib: Calib,
    host: jnp.ndarray,
    AH: jnp.ndarray,
    AT: jnp.ndarray,
    n_frames: int,
    d_delta: jnp.ndarray | None = None,
) -> GNSystem:
    """Mode-1 accumulation (accumulateLF_MT, EnergyFunctional.cpp:177-197 +
    AccumulatedTopHessian.cpp mode 1): frozen Jacobians with
    resApprox = res_toZero + J * delta. Returns a GNSystem to be ADDED to the
    active (mode-0) system before the Schur complement — the reference sums
    Hdd_accAF + Hdd_accLF etc. per point (EnergyFunctional.cpp:225-247)."""
    resapprox = frozen_resapprox(frozen, frames, calib, host, AH, AT, d_delta)
    P, F = frozen.is_linearized.shape
    zeros_pf = jnp.zeros((P, F), jnp.float32)
    lin = Linearization(
        Jpdc=frozen.Jpdc, Jpdxi=frozen.Jpdxi, Jpdd=frozen.Jpdd,
        JIdx=frozen.JIdx, JabF=frozen.JabF, resF=resapprox,
        energy=zeros_pf, energy_raw=zeros_pf,
        new_state=jnp.zeros((P, F), jnp.int32),
        center_u=zeros_pf, center_v=zeros_pf, center_idepth=zeros_pf,
        rel_bs=zeros_pf, win_miss=frozen.is_linearized & False,
        ind_res=jnp.zeros((P, F, 2), jnp.float32), ind_wgt=zeros_pf,
        ind_ok=frozen.is_linearized & False, ind_energy=zeros_pf,
    )
    return accumulate(lin, frozen.is_linearized, host, AH, AT, n_frames)


def add_systems(a: GNSystem, b: GNSystem) -> GNSystem:
    """Sum two GN systems over the same state layout (active + linearized)."""
    return GNSystem(
        H=a.H + b.H, b=a.b + b.b, Hdd=a.Hdd + b.Hdd, bd=a.bd + b.bd,
        g=a.g + b.g, num_res=a.num_res + b.num_res,
    )


def calc_l_energy(
    frozen: FrozenResiduals,
    frames: W.Frames,
    calib: Calib,
    host: jnp.ndarray,
    AH: jnp.ndarray,
    AT: jnp.ndarray,
    point_prior: jnp.ndarray,     # (P,)
    d_delta: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Linearized-residual energy (EnergyFunctional::calcLEnergyPt,
    EnergyFunctional.cpp:289-347): sum of Jdelta * (Jdelta + 2 res_toZero)
    over linearized residuals, plus the per-point idepth prior energy
    deltaF^2 * priorF."""
    P = frozen.res_toZero.shape[0]
    if d_delta is None:
        d_delta = jnp.zeros(P, jnp.float32)
    dp, c_delta = pair_deltas(frames, calib, AH, AT)
    dp_pf = dp[host]
    jx, jy = _jp_delta(frozen, dp_pf, c_delta, d_delta)
    jdelta = (
        frozen.JIdx[..., 0] * jx[..., None]
        + frozen.JIdx[..., 1] * jy[..., None]
        + frozen.JabF[..., 0] * dp_pf[..., None, 6]
        + frozen.JabF[..., 1] * dp_pf[..., None, 7]
    )
    terms = jdelta * (jdelta + 2.0 * frozen.res_toZero)
    e_res = jnp.sum(
        jnp.where(frozen.is_linearized[..., None], terms, 0.0)
    )
    e_prior = jnp.sum(d_delta * d_delta * point_prior)
    return e_res + e_prior


def calc_m_energy(HM: jnp.ndarray, bM: jnp.ndarray,
                  delta: jnp.ndarray) -> jnp.ndarray:
    """Marginalization-prior energy (EnergyFunctional::calcMEnergyF,
    EnergyFunctional.cpp:277-286): delta . (2 bM + HM delta)."""
    return delta @ (2.0 * bM + HM @ delta)
