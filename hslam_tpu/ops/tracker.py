"""Coarse frame-to-keyframe direct image alignment (the per-frame tracker).

Batched device re-design of the reference CoarseTracker
(reference: Src/CoarseTracker.cpp:29-683, Include/CoarseTracker.h:14-95):

  * The semi-dense inverse-depth template (`makeCoarseDepthL0`,
    CoarseTracker.cpp:105-263) is built as dense per-level maps
    (scatter-add + 2x2 sum pooling + one masked dilation pass), then
    compacted to fixed-capacity point lists per level — the reference's
    pc_* lists — so each LM iteration touches only the ~2k live template
    points instead of the full pixel grid.
  * `calcRes` + `calcGSSSE` (CoarseTracker.cpp:329-485, 267-324) fuse into a
    single pass `_residual_pass` producing (E, n, nSat, flow, H, b) in one
    sweep — one warp+gather per LM iteration instead of two.
  * The per-level LM loop (CoarseTracker.cpp:559-646) is a lax.while_loop
    with convergence exit and branchless accept/reject via jnp.where; the
    adaptive cutoff-doubling repeat (CoarseTracker.cpp:532-539) is a small
    lax.while_loop on the cutoff scalar.

State conventions match the reference: pose is refToNew (SE3 as (R, t)),
affine is the new frame's (a, b) global-to-local; the relative affine
(a_rel, b_rel) comes from AffLight::fromToVecExposure
(GlobalTypes.h:334-346). The GN state ordering and diagonal preconditioner
replicate calcGSSSE (including the reference's rot/trans scale swap in the
tracker, CoarseTracker.cpp:312-323 vs. 596-600 — net effect: translation
columns scaled by SCALE_XI_ROT=1, rotation by SCALE_XI_TRANS=0.5).
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..config import Config, SCALE_A, SCALE_B, SCALE_XI_ROT, SCALE_XI_TRANS
from ..utils import lie

# tracker state preconditioner, applied as inc_actual = PRECOND * inc_scaled
# ordering: [trans(3), rot(3), a, b] — see module docstring on the swap.
_PRECOND = jnp.array(
    [SCALE_XI_ROT] * 3 + [SCALE_XI_TRANS] * 3 + [SCALE_A, SCALE_B],
    dtype=jnp.float32,
)


TEMPLATE_CAP = 8192   # max compacted template points per level


class Template(NamedTuple):
    """Per-level compacted tracking template (lists indexed by level).

    Like the reference's pc_u/pc_v/pc_idepth/pc_color point lists
    (CoarseTracker.h:60-63): only valid template pixels, packed to a fixed
    capacity — at level 0 that is ~2k of 307k pixels, so compaction cuts
    the per-LM-iteration gather traffic by ~100x vs. dense masking."""

    u: List[jnp.ndarray]        # (C_l,) pixel x
    v: List[jnp.ndarray]        # (C_l,) pixel y
    idepth: List[jnp.ndarray]   # (C_l,)
    color: List[jnp.ndarray]    # (C_l,) reference intensity
    valid: List[jnp.ndarray]    # (C_l,) bool


def nearest_template_depth(ku, kv, tu, tv, tid, tval):
    """Nearest valid template point per keypoint — the depth-lift used by
    loop closure and relocalization (PnP needs 3D for the keyframe's
    keypoints). Returns (idepth (K,), squared distance (K,)); callers gate
    on the distance (typically <= 9 px^2)."""
    d2 = ((ku[:, None] - tu[None, :]) ** 2
          + (kv[:, None] - tv[None, :]) ** 2)
    d2 = jnp.where(tval[None, :], d2, 1e12)
    nn = jnp.argmin(d2, axis=1)
    return tid[nn], jnp.min(d2, axis=1)


def rel_affine(exp_ref: jnp.ndarray, exp_new: jnp.ndarray,
               aff_ref: jnp.ndarray, aff_new: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """AffLight::fromToVecExposure (GlobalTypes.h:334-346):
    a = exp(a_new - a_ref) * t_new / t_ref ; b = b_new - a * b_ref.
    Exposures of 0 are treated as 1."""
    t_ref = jnp.where(exp_ref == 0, 1.0, exp_ref)
    t_new = jnp.where(exp_new == 0, 1.0, exp_new)
    a = jnp.exp(aff_new[0] - aff_ref[0]) * t_new / t_ref
    b = aff_new[1] - a * aff_ref[1]
    return a, b


def build_template(
    u: jnp.ndarray,
    v: jnp.ndarray,
    idepth: jnp.ndarray,
    weight: jnp.ndarray,
    point_valid: jnp.ndarray,
    ref_pyr: List[jnp.ndarray],
) -> Template:
    """Build the per-level template from active points projected into the
    reference keyframe (reference makeCoarseDepthL0, CoarseTracker.cpp:105-263).

    Args:
      u, v: (P,) level-0 projected pixel coordinates (centerProjectedTo).
      idepth: (P,) projected inverse depth in the reference frame.
      weight: (P,) scatter weights sqrt(1e-3 / (HdiF + 1e-12)).
      point_valid: (P,) bool — point active and last residual IN.
      ref_pyr: reference frame direct pyramid [(Hl, Wl, 3)] for colors.
    """
    H0, W0 = ref_pyr[0].shape[:2]
    n_levels = len(ref_pyr)

    ui = jnp.clip((u + 0.5).astype(jnp.int32), 0, W0 - 1)
    vi = jnp.clip((v + 0.5).astype(jnp.int32), 0, H0 - 1)
    w_eff = jnp.where(point_valid, weight, 0.0)

    flat_idx = vi * W0 + ui
    id_map = jnp.zeros(H0 * W0, jnp.float32).at[flat_idx].add(w_eff * idepth)
    w_map = jnp.zeros(H0 * W0, jnp.float32).at[flat_idx].add(w_eff)
    id_map = id_map.reshape(H0, W0)
    w_map = w_map.reshape(H0, W0)

    us, vs, idepths, colors, valids = [], [], [], [], []
    for lvl in range(n_levels):
        if lvl > 0:
            # 2x2 SUM pooling of the *raw* scatter maps level by level
            # (CoarseTracker.cpp:132-157 pools before any dilation)
            Hc, Wc = id_map.shape
            H2, W2 = Hc // 2, Wc // 2
            id_map = id_map[: H2 * 2, : W2 * 2].reshape(H2, 2, W2, 2).sum(axis=(1, 3))
            w_map = w_map[: H2 * 2, : W2 * 2].reshape(H2, 2, W2, 2).sum(axis=(1, 3))

        # one dilation pass into per-level copies: diagonal neighbors at
        # lvl<2, 4-neighborhood above (CoarseTracker.cpp:160-213)
        if lvl < 2:
            shifts = [(1, 1), (-1, -1), (1, -1), (-1, 1)]
        else:
            shifts = [(0, 1), (0, -1), (1, 0), (-1, 0)]
        has = w_map > 0
        sum_id = jnp.zeros_like(id_map)
        sum_w = jnp.zeros_like(w_map)
        cnt = jnp.zeros_like(w_map)
        for dy, dx in shifts:
            sh_w = jnp.roll(w_map, (-dy, -dx), axis=(0, 1))
            sh_id = jnp.roll(id_map, (-dy, -dx), axis=(0, 1))
            ok = sh_w > 0
            sum_id = sum_id + jnp.where(ok, sh_id, 0.0)
            sum_w = sum_w + jnp.where(ok, sh_w, 0.0)
            cnt = cnt + ok.astype(jnp.float32)
        fill = (~has) & (cnt > 0)
        safe_cnt = jnp.maximum(cnt, 1.0)
        id_lvl = jnp.where(fill, sum_id / safe_cnt, id_map)
        w_lvl = jnp.where(fill, sum_w / safe_cnt, w_map)

        # normalize (CoarseTracker.cpp:216-261)
        Hl, Wl = id_lvl.shape
        ys = jnp.arange(Hl)[:, None]
        xs = jnp.arange(Wl)[None, :]
        border_ok = (ys >= 2) & (ys < Hl - 2) & (xs >= 2) & (xs < Wl - 2)
        idl = jnp.where(w_lvl > 0, id_lvl / jnp.maximum(w_lvl, 1e-12), -1.0)
        color = ref_pyr[lvl][..., 0]
        ok = (w_lvl > 0) & (idl > 0) & border_ok & jnp.isfinite(color)

        # compact to a fixed-capacity point list (pc_* lists in the
        # reference, CoarseTracker.cpp:225-261)
        cap = min(Hl * Wl, TEMPLATE_CAP)
        score = ok.reshape(-1).astype(jnp.float32)
        top_score, top_idx = jax.lax.top_k(score, cap)
        pv = top_score > 0.0
        pu = (top_idx % Wl).astype(jnp.float32)
        pvy = (top_idx // Wl).astype(jnp.float32)
        us.append(pu)
        vs.append(pvy)
        idepths.append(idl.reshape(-1)[top_idx])
        colors.append(color.reshape(-1)[top_idx])
        valids.append(pv)
    return Template(u=us, v=vs, idepth=idepths, color=colors, valid=valids)


class TrackResult(NamedTuple):
    R: jnp.ndarray                  # (3,3) refToNew rotation
    t: jnp.ndarray                  # (3,)
    aff: jnp.ndarray                # (2,) new-frame (a, b)
    ok: jnp.ndarray                 # () bool
    residuals: jnp.ndarray          # (L,) per-level final RMSE
    flow: jnp.ndarray               # (3,) flow indicators [T, 0, RT]


def _residual_pass(tmpl_u, tmpl_v, tmpl_id, tmpl_color, tmpl_valid,
                   target_img, K_lvl, R, t, a_rel, b_rel, b0, cutoff,
                   huber_th, compute_flow: bool):
    """One fused sweep over a level: warp the compacted template points,
    gather target intensity+gradient, form robust residuals and the 8x8 GN
    system.

    Replaces calcRes + calcGSSSE (CoarseTracker.cpp:329-485, 267-324).
    Returns (E, n_terms, n_sat, H (8,8), b (8,), flowT, flowRT).
    """
    Hl, Wl = target_img.shape[0], target_img.shape[1]
    fx, fy, cx, cy = K_lvl[0], K_lvl[1], K_lvl[2], K_lvl[3]

    xs = tmpl_u                  # (C,)
    ys = tmpl_v
    idp = tmpl_id
    # back-project with K^-1, rotate, translate (RKi * (x,y,1) + t*id)
    px = (xs - cx) / fx
    py = (ys - cy) / fy
    X = R[0, 0] * px + R[0, 1] * py + R[0, 2] + t[0] * idp
    Y = R[1, 0] * px + R[1, 1] * py + R[1, 2] + t[1] * idp
    Z = R[2, 0] * px + R[2, 1] * py + R[2, 2] + t[2] * idp

    Zs = jnp.where(jnp.abs(Z) < 1e-12, 1e-12, Z)
    u = X / Zs
    v = Y / Zs
    Ku = fx * u + cx
    Kv = fy * v + cy
    new_idepth = idp / Zs

    in_bounds = (Ku > 2) & (Kv > 2) & (Ku < Wl - 3) & (Kv < Hl - 3) & (new_idepth > 0)
    mask = tmpl_valid & in_bounds

    # gather target [I, dx, dy] with ONE packed-cell row gather per sample
    # (target_img is pre-packed (H, W, 3, 4) by track_coarse)
    Kuc = jnp.clip(Ku, 0.0, Wl - 1.001)
    Kvc = jnp.clip(Kv, 0.0, Hl - 1.001)
    ix = jnp.clip(jnp.floor(Kuc).astype(jnp.int32), 0, Wl - 2)
    iy = jnp.clip(jnp.floor(Kvc).astype(jnp.int32), 0, Hl - 2)
    dx_f = Kuc - ix.astype(jnp.float32)
    dy_f = Kvc - iy.astype(jnp.float32)
    cells = target_img.reshape(Hl * Wl, 3, 4)[iy * Wl + ix]   # (C, 3, 4)
    wx = dx_f[..., None]
    wy = dy_f[..., None]
    top = cells[..., 0] * (1 - wx) + cells[..., 1] * wx
    bot = cells[..., 2] * (1 - wx) + cells[..., 3] * wx
    hit = top * (1 - wy) + bot * wy                            # (C, 3)

    hit_I, hit_dx, hit_dy = hit[..., 0], hit[..., 1], hit[..., 2]
    mask = mask & jnp.isfinite(hit_I)

    refc = tmpl_color
    residual = hit_I - (a_rel * refc + b_rel)
    abs_r = jnp.abs(residual)
    hw = jnp.where(abs_r < huber_th, 1.0, huber_th / jnp.maximum(abs_r, 1e-12))

    saturated = (abs_r > cutoff) & mask
    inlier = mask & ~saturated

    max_energy = 2.0 * huber_th * cutoff - huber_th * huber_th
    E = jnp.sum(
        jnp.where(inlier, hw * residual * residual * (2.0 - hw), 0.0)
        + jnp.where(saturated, max_energy, 0.0)
    )
    n_terms = jnp.sum(mask.astype(jnp.float32))
    n_sat = jnp.sum(saturated.astype(jnp.float32))

    # GN system over inliers: J rows (CoarseTracker.cpp:284-305)
    m = inlier.astype(jnp.float32)
    gdx = hit_dx * fx
    gdy = hit_dy * fy
    J = jnp.stack(
        [
            new_idepth * gdx,
            new_idepth * gdy,
            -new_idepth * (u * gdx + v * gdy),
            -(u * v * gdx + (1.0 + v * v) * gdy),
            u * v * gdy + (1.0 + u * u) * gdx,
            u * gdy - v * gdx,
            a_rel * (b0 - refc),
            -jnp.ones_like(refc),
        ],
        axis=-1,
    )  # (C, 8)
    wt = (hw * m)[..., None]
    Jw = J * wt
    Hmat = J.T @ Jw                                    # (8, 8)
    bvec = J.T @ (residual * hw * m)                   # J^T W r

    if compute_flow:
        # flow indicators over every valid template pixel (reference samples
        # every 32nd at level 0, CoarseTracker.cpp:384-415; dense here)
        tx = px + t[0] * idp
        ty = py + t[1] * idp
        tz = 1.0 + t[2] * idp
        tzs = jnp.where(jnp.abs(tz) < 1e-12, 1e-12, tz)
        KuT = fx * tx / tzs + cx
        KvT = fy * ty / tzs + cy
        tx2 = px - t[0] * idp
        ty2 = py - t[1] * idp
        tz2 = 1.0 - t[2] * idp
        tz2s = jnp.where(jnp.abs(tz2) < 1e-12, 1e-12, tz2)
        KuT2 = fx * tx2 / tz2s + cx
        KvT2 = fy * ty2 / tz2s + cy
        X3 = X - 2.0 * t[0] * idp
        Y3 = Y - 2.0 * t[1] * idp
        Z3 = Z - 2.0 * t[2] * idp
        Z3s = jnp.where(jnp.abs(Z3) < 1e-12, 1e-12, Z3)
        Ku3 = fx * X3 / Z3s + cx
        Kv3 = fy * Y3 / Z3s + cy
        fm = tmpl_valid.astype(jnp.float32)
        fn = jnp.sum(fm)
        shiftT = jnp.sum(fm * ((KuT - xs) ** 2 + (KvT - ys) ** 2
                               + (KuT2 - xs) ** 2 + (KvT2 - ys) ** 2))
        shiftRT = jnp.sum(fm * ((Ku - xs) ** 2 + (Kv - ys) ** 2
                                + (Ku3 - xs) ** 2 + (Kv3 - ys) ** 2))
        flowT = shiftT / (2.0 * fn + 0.1)
        flowRT = shiftRT / (2.0 * fn + 0.1)
    else:
        flowT = jnp.float32(0.0)
        flowRT = jnp.float32(0.0)

    return E, n_terms, n_sat, Hmat, bvec, flowT, flowRT


def track_coarse(
    template: Template,
    target_pyr: List[jnp.ndarray],
    K_pyr: jnp.ndarray,             # (L, 4) [fx, fy, cx, cy] per level
    R0: jnp.ndarray,
    t0: jnp.ndarray,
    aff0: jnp.ndarray,              # (2,) initial new-frame (a, b)
    exp_ref: jnp.ndarray,
    exp_new: jnp.ndarray,
    aff_ref: jnp.ndarray,           # (2,) reference keyframe (a, b)
    cfg: Config,
    coarsest_lvl: int | None = None,
    min_res_for_abort: jnp.ndarray | None = None,
) -> TrackResult:
    """Full coarse-to-fine LM alignment, one motion hypothesis.

    Mirrors trackNewestCoarse (CoarseTracker.cpp:506-683) including the
    cutoff-doubling repeat, per-level iteration caps, lambda schedule,
    extrapolation factor, early-abort vs. min_res_for_abort, and the affine
    sanity rejection at the end.
    """
    n_levels = len(target_pyr)
    if coarsest_lvl is None:
        coarsest_lvl = n_levels - 1
    if min_res_for_abort is None:
        min_res_for_abort = jnp.full((n_levels,), jnp.inf, jnp.float32)

    huber = jnp.float32(cfg.huber_th)
    b0_ref = aff_ref[1]
    max_iters = cfg.tracker_iters_per_level

    # pre-pack every level's [I, dx, dy] into per-pixel 2x2 cells so each
    # bilinear sample in the LM loops is ONE row gather (utils.interp)
    from ..utils.interp import pack_cells

    packed_pyr = [
        jnp.stack([pack_cells(t[..., c]) for c in range(3)], axis=2)
        for t in target_pyr
    ]  # [(H, W, 3, 4)]

    R, t, aff = R0, t0, aff0
    ok = jnp.bool_(True)
    level_res = [jnp.float32(jnp.nan)] * n_levels
    flow = jnp.array([1000.0, 0.0, 1000.0], jnp.float32)
    have_repeated = jnp.bool_(False)

    def run_level(lvl, R, t, aff, active):
        """One level of LM. `active` masks out the whole level (early abort)."""
        tmpl_u = template.u[lvl]
        tmpl_vv = template.v[lvl]
        tmpl_id = template.idepth[lvl]
        tmpl_c = template.color[lvl]
        tmpl_v = template.valid[lvl]
        timg = packed_pyr[lvl]
        K_lvl = K_pyr[lvl]

        def res_at(R_, t_, aff_, cutoff, with_flow=False):
            a_rel, b_rel = rel_affine(exp_ref, exp_new, aff_ref, aff_)
            return _residual_pass(
                tmpl_u, tmpl_vv, tmpl_id, tmpl_c, tmpl_v, timg, K_lvl, R_, t_,
                a_rel, b_rel, b0_ref, cutoff, huber, with_flow,
            )

        # adaptive cutoff doubling (CoarseTracker.cpp:530-539)
        base_cut = jnp.float32(cfg.coarse_cutoff_th)

        def cut_cond(carry):
            cut_rep, E, n, nsat, _, _ = carry
            sat_ratio = nsat / jnp.maximum(n, 1.0)
            return (sat_ratio > 0.6) & (cut_rep < 50.0)

        def cut_body(carry):
            cut_rep, *_ = carry
            cut_rep = cut_rep * 2.0
            E, n, nsat, Hm, bv, *_ = res_at(R, t, aff, base_cut * cut_rep)
            return (cut_rep, E, n, nsat, Hm, bv)

        E0, n0, nsat0, H0m, b0v, *_ = res_at(R, t, aff, base_cut)
        cut_rep, E, n, nsat, Hm, bv = jax.lax.while_loop(
            cut_cond, cut_body, (jnp.float32(1.0), E0, n0, nsat0, H0m, b0v)
        )
        cutoff = base_cut * cut_rep

        def lm_cond(carry):
            it, R_c, t_c, aff_c, Hc, bc, Ec, nc, lam, done = carry
            return (it < max_iters[min(lvl, len(max_iters) - 1)]) & ~done

        def lm_body(carry):
            it, R_c, t_c, aff_c, Hc, bc, Ec, nc, lam, done = carry
            # NOTE: the reference scales H/b by the SCALE_* diagonal, solves,
            # then multiplies the step by the same diagonal
            # (CoarseTracker.cpp:312-323, 596-600) — that round-trip is the
            # identity, so we solve directly in natural units.
            Hl_ = Hc + jnp.diag(jnp.diag(Hc)) * lam
            inc = jnp.linalg.solve(Hl_, -bc)
            extrap = jnp.where(
                lam < 0.001, jnp.sqrt(jnp.sqrt(0.001 / jnp.maximum(lam, 1e-12))), 1.0
            )
            inc_scaled = inc * extrap
            inc_scaled = jnp.where(jnp.isfinite(jnp.sum(inc_scaled)), inc_scaled, 0.0)

            dR, dt = lie.se3_exp(inc_scaled[:6])
            R_new, t_new = lie.se3_mul(dR, dt, R_c, t_c)
            aff_new = aff_c + inc_scaled[6:8]

            E_new, n_new, _, H_new, b_new, *_ = res_at(R_new, t_new, aff_new, cutoff)
            accept = (E_new / jnp.maximum(n_new, 1.0)) < (Ec / jnp.maximum(nc, 1.0))
            step = accept & ~done

            R_c = jnp.where(step, R_new, R_c)
            t_c = jnp.where(step, t_new, t_c)
            aff_c = jnp.where(step, aff_new, aff_c)
            Hc = jnp.where(step, H_new, Hc)
            bc = jnp.where(step, b_new, bc)
            Ec = jnp.where(step, E_new, Ec)
            nc = jnp.where(step, n_new, nc)
            lam = jnp.where(done, lam,
                            jnp.where(accept, lam * 0.5,
                                      jnp.maximum(lam * 4.0, 0.001)))
            # convergence test in the reference's scaled units
            # (CoarseTracker.cpp:640: inc.norm() on the preconditioned step)
            done = done | (jnp.linalg.norm(inc_scaled / _PRECOND) <= 1e-3)
            return (it + 1, R_c, t_c, aff_c, Hc, bc, Ec, nc, lam, done)

        # while_loop (not fori): each LM iteration is a full dense pass and
        # the loop is latency-bound — stopping at convergence is the
        # difference between ~230 and ~30 sequential dispatches per track
        init = (jnp.int32(0), R, t, aff, Hm, bv, E, n, jnp.float32(0.01),
                ~active)
        _, R_f, t_f, aff_f, _, _, E_f, n_f, _, _ = jax.lax.while_loop(
            lm_cond, lm_body, init
        )

        # final stats with flow indicators
        E_fin, n_fin, _, _, _, flowT, flowRT = res_at(R_f, t_f, aff_f, cutoff, True)
        rmse = jnp.sqrt(E_fin / jnp.maximum(n_fin, 1.0))
        return R_f, t_f, aff_f, rmse, jnp.stack([flowT, jnp.float32(0.0), flowRT]), cut_rep

    for lvl in range(coarsest_lvl, -1, -1):
        R_n, t_n, aff_n, rmse, flow_n, cut_rep = run_level(lvl, R, t, aff, ok)
        R = jnp.where(ok, R_n, R)
        t = jnp.where(ok, t_n, t)
        aff = jnp.where(ok, aff_n, aff)
        level_res[lvl] = jnp.where(ok, rmse, level_res[lvl])
        flow = jnp.where(ok, flow_n, flow)
        abort_lvl = min(lvl, min_res_for_abort.shape[0] - 1)
        ok = ok & ~(rmse > 1.5 * min_res_for_abort[abort_lvl])

        # repeat-level-once (CoarseTracker.cpp:654-659): if the cutoff was
        # raised, rerun the same level once with the converged state.
        repeat = ok & (cut_rep > 1.0) & ~have_repeated
        have_repeated = have_repeated | repeat
        R_r, t_r, aff_r, rmse_r, flow_r, _ = run_level(lvl, R, t, aff, repeat)
        R = jnp.where(repeat, R_r, R)
        t = jnp.where(repeat, t_r, t)
        aff = jnp.where(repeat, aff_r, aff)
        level_res[lvl] = jnp.where(repeat, rmse_r, level_res[lvl])
        flow = jnp.where(repeat, flow_r, flow)

    # affine sanity rejection (CoarseTracker.cpp:667-675)
    a_rel, b_rel = rel_affine(exp_ref, exp_new, aff_ref, aff)
    ok = ok & (jnp.abs(aff[0]) <= 1.2) & (jnp.abs(aff[1]) <= 200.0)

    return TrackResult(
        R=R, t=t, aff=aff, ok=ok,
        residuals=jnp.stack(level_res), flow=flow,
    )


def score_hypotheses(
    template: Template,
    coarse_img: jnp.ndarray,        # coarsest-level (H, W, 3) [I, dx, dy]
    K_lvl: jnp.ndarray,             # (4,) coarsest-level intrinsics
    lvl: int,                       # coarsest level index (template select)
    R_b: jnp.ndarray,               # (N, 3, 3) hypothesis rotations
    t_b: jnp.ndarray,               # (N, 3)
    aff0: jnp.ndarray,
    exp_ref: jnp.ndarray,
    exp_new: jnp.ndarray,
    aff_ref: jnp.ndarray,
    cfg: Config,
    n_iters: int = 10,
) -> jnp.ndarray:
    """Score all N motion hypotheses with a fixed-iteration GN at the
    coarsest pyramid level in ONE batched pass (SURVEY §7.2 step 4).

    The reference tries its ~27 hypotheses serially with an early-out
    (System.cpp:367-405); on a device each serial try costs a dispatch and
    a host round trip, so we evaluate them all at once and let the caller refine
    only the argmin. Returns per-hypothesis mean energy (E/n), inf-filled
    for diverged hypotheses.
    """
    from ..utils.interp import pack_cells

    packed = jnp.stack([pack_cells(coarse_img[..., c]) for c in range(3)], axis=2)
    tmpl_u = template.u[lvl]
    tmpl_v = template.v[lvl]
    tmpl_id = template.idepth[lvl]
    tmpl_c = template.color[lvl]
    tmpl_valid = template.valid[lvl]
    huber = jnp.float32(cfg.huber_th)
    cutoff = jnp.float32(cfg.coarse_cutoff_th)
    b0_ref = aff_ref[1]

    def score_one(R0, t0):
        a_rel, b_rel = rel_affine(exp_ref, exp_new, aff_ref, aff0)

        def res_at(R_, t_, aff_):
            a_r, b_r = rel_affine(exp_ref, exp_new, aff_ref, aff_)
            return _residual_pass(
                tmpl_u, tmpl_v, tmpl_id, tmpl_c, tmpl_valid, packed, K_lvl,
                R_, t_, a_r, b_r, b0_ref, cutoff, huber, False,
            )

        E0, n0, _, H0, b0v, *_ = res_at(R0, t0, aff0)

        def body(_, carry):
            R_c, t_c, aff_c, Hc, bc, Ec, nc, lam = carry
            Hl_ = Hc + jnp.diag(jnp.diag(Hc)) * lam
            inc = jnp.linalg.solve(Hl_, -bc)
            inc = jnp.where(jnp.isfinite(jnp.sum(inc)), inc, 0.0)
            dR, dt = lie.se3_exp(inc[:6])
            R_n, t_n = lie.se3_mul(dR, dt, R_c, t_c)
            aff_n = aff_c + inc[6:8]
            E_n, n_n, _, H_n, b_n, *_ = res_at(R_n, t_n, aff_n)
            accept = (E_n / jnp.maximum(n_n, 1.0)) < (Ec / jnp.maximum(nc, 1.0))
            sel = lambda a, b: jnp.where(accept, a, b)
            return (sel(R_n, R_c), sel(t_n, t_c), sel(aff_n, aff_c),
                    sel(H_n, Hc), sel(b_n, bc), sel(E_n, Ec), sel(n_n, nc),
                    jnp.where(accept, lam * 0.5, jnp.maximum(lam * 4.0, 0.001)))

        carry = jax.lax.fori_loop(
            0, n_iters, body,
            (R0, t0, aff0, H0, b0v, E0, n0, jnp.float32(0.01)))
        E_f, n_f = carry[5], carry[6]
        mean_e = E_f / jnp.maximum(n_f, 1.0)
        bad = ~jnp.isfinite(mean_e) | (n_f < 4.0)
        return jnp.where(bad, jnp.inf, mean_e)

    return jax.vmap(score_one)(R_b, t_b)


def track_coarse_multi(
    template: Template,
    target_pyr: List[jnp.ndarray],
    K_pyr: jnp.ndarray,
    R_b: jnp.ndarray,               # (N, 3, 3)
    t_b: jnp.ndarray,               # (N, 3)
    aff0: jnp.ndarray,
    exp_ref: jnp.ndarray,
    exp_new: jnp.ndarray,
    aff_ref: jnp.ndarray,
    cfg: Config,
    coarsest_lvl: int | None = None,
    min_res_for_abort: jnp.ndarray | None = None,
) -> Tuple[TrackResult, jnp.ndarray]:
    """Batched-hypothesis tracking: score all hypotheses at the coarsest
    level, then run the full coarse-to-fine LM once on the winner — the
    whole per-frame tracker in ONE device dispatch (vs. up to 31 serial
    calls replicating System.cpp:428-481 exactly).

    Behavioral note vs. the reference: the reference accepts the FIRST
    hypothesis that beats its early-out threshold; we refine the argmin of
    the coarsest-level energies. On every sequence we generate these agree
    except when two hypotheses tie within noise. Returns (result, best_idx).
    """
    n_levels = len(target_pyr)
    if coarsest_lvl is None:
        coarsest_lvl = n_levels - 1
    scores = score_hypotheses(
        template, target_pyr[coarsest_lvl], K_pyr[coarsest_lvl], coarsest_lvl,
        R_b, t_b, aff0, exp_ref, exp_new, aff_ref, cfg,
    )
    best = jnp.argmin(scores)
    res = track_coarse(
        template, target_pyr, K_pyr, R_b[best], t_b[best], aff0,
        exp_ref, exp_new, aff_ref, cfg,
        coarsest_lvl=coarsest_lvl, min_res_for_abort=min_res_for_abort,
    )
    ok = res.ok & jnp.isfinite(scores[best])
    return res._replace(ok=ok), best


def _rigid_inv(T: jnp.ndarray) -> jnp.ndarray:
    R = T[:3, :3]
    t = T[:3, 3]
    Ti = jnp.eye(4, dtype=T.dtype)
    Ti = Ti.at[:3, :3].set(R.T)
    Ti = Ti.at[:3, 3].set(-R.T @ t)
    return Ti


# the reference's 26 small-rotation perturbations (System.cpp:374-405)
_ROT_AXES = jnp.array(
    [(1, 0, 0), (0, 1, 0), (0, 0, 1),
     (-1, 0, 0), (0, -1, 0), (0, 0, -1),
     (1, 1, 0), (0, 1, 1), (1, 0, 1),
     (-1, 1, 0), (0, -1, 1), (-1, 0, 1),
     (1, -1, 0), (0, 1, -1), (1, 0, -1),
     (-1, -1, 0), (0, -1, -1), (-1, 0, -1),
     (-1, -1, -1), (-1, -1, 1), (-1, 1, -1),
     (-1, 1, 1), (1, -1, -1), (1, -1, 1),
     (1, 1, -1), (1, 1, 1)], jnp.float32)


def motion_hypotheses_device(
    ref_c2w: jnp.ndarray,        # (4,4) tracking-reference camToWorld
    prev_c2w: jnp.ndarray,       # (4,4) last frame camToWorld
    prevprev_c2w: jnp.ndarray,   # (4,4)
    have_motion: jnp.ndarray,    # () bool — prev/prevprev valid
    rot: float = 0.02,
    dt_ratio: jnp.ndarray | None = None,   # () dt_new / dt_prev
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """The reference's 31-entry motion-hypothesis list (System.cpp:347-405)
    built entirely on device from the last two camera poses, so the
    pipelined tracker needs NO host round-trip between frames.

    `dt_ratio` scales the constant-motion twist by the timestamp gap:
    when the driver skips input frames (realtime policy, Main.cpp:91-106)
    the motion between consecutive PROCESSED frames is dt_ratio x the
    per-frame motion — the reference never needed this because it never
    skips many frames at once, but an unscaled hypothesis set under heavy
    skipping rejects the true pose and triggers the failure path on every
    frame. Returns refToNew hypotheses as (32, 3, 3), (32, 3)
    (identity-padded)."""
    fh2slast = _rigid_inv(prevprev_c2w) @ prev_c2w
    T_ls = _rigid_inv(prev_c2w) @ ref_c2w
    r = jnp.float32(1.0) if dt_ratio is None else dt_ratio

    xi = lie.se3_log(fh2slast[:3, :3], fh2slast[:3, 3])

    def fwd(f):
        """exp(f * xi) as a 4x4 (f<0 gives the inverse — same twist)."""
        Rf, tf = lie.se3_exp(f * xi)
        return jnp.eye(4).at[:3, :3].set(Rf).at[:3, 3].set(tf)

    base = fwd(-r) @ T_ls           # constant motion over dt_new
    quats = jnp.concatenate(
        [jnp.ones((26, 1), jnp.float32), rot * _ROT_AXES], axis=1)
    quats = quats / jnp.linalg.norm(quats, axis=1, keepdims=True)
    # quat_to_rot takes [x, y, z, w]
    R_pert = jax.vmap(lambda q: lie.quat_to_rot(
        jnp.stack([q[1], q[2], q[3], q[0]])))(quats)
    pert = jnp.tile(jnp.eye(4)[None], (26, 1, 1)).at[:, :3, :3].set(R_pert)
    perturbed = jnp.einsum("ij,njk->nik", base, pert)

    head = jnp.stack([
        base,                       # constant motion
        fwd(-2.0 * r) @ T_ls,       # double motion
        fwd(-0.5 * r) @ T_ls,       # half motion
        T_ls,                       # zero motion from last
        jnp.eye(4),                 # zero motion from ref
        base,                       # pad to 32
    ])
    T_all = jnp.concatenate([head[:5], perturbed, head[5:]], axis=0)  # (32,4,4)
    eye = jnp.tile(jnp.eye(4)[None], (32, 1, 1))
    T_all = jnp.where(have_motion, T_all, eye)
    return T_all[:, :3, :3], T_all[:, :3, 3]


class TrackStepOut(NamedTuple):
    pyr: List[jnp.ndarray]
    grads: Tuple[jnp.ndarray, ...]
    R: jnp.ndarray                  # (3,3) refToNew
    t: jnp.ndarray
    aff: jnp.ndarray
    ok: jnp.ndarray
    residuals: jnp.ndarray
    flow: jnp.ndarray
    c2w: jnp.ndarray                # (4,4) new camToWorld


def track_step(
    template: Template,
    img: jnp.ndarray,               # (H, W) grayscale (uint8 or float32)
    calib_value: jnp.ndarray,       # (4,) level-0 [fx, fy, cx, cy]
    ref_c2w: jnp.ndarray,
    prev_c2w: jnp.ndarray,
    prevprev_c2w: jnp.ndarray,
    have_motion: jnp.ndarray,
    aff0: jnp.ndarray,
    exp_ref: jnp.ndarray,
    exp_new: jnp.ndarray,
    aff_ref: jnp.ndarray,
    cfg: Config,
    n_levels: int,
    gamma_grad_weight: jnp.ndarray | None = None,
    dt_ratio: jnp.ndarray | None = None,
) -> TrackStepOut:
    """One fully-fused per-frame tracking step: pyramid build + device-side
    motion hypotheses + batched coarsest-level scoring + coarse-to-fine LM,
    all in ONE dispatch. The host never has to touch the result to keep the
    pipeline moving — c2w feeds the next frame's hypotheses directly, so a
    lag-1 host pull overlaps the next frame's device compute (the device
    answer to the reference's tracking/mapping thread overlap +
    per-hypothesis early-outs, System.cpp:127-133, 428-481).

    `img` may be uint8 — frames cross the host->device link in their native
    8-bit form (4x fewer bytes than float32) and are converted on
    device; the per-level intrinsics are likewise derived on device from the
    (4,) optimized calib vector, so the host never materializes K_pyr."""
    from ..models.calib import k_pyr_from_value
    from .pyramid import build_direct_pyramid

    K_pyr = k_pyr_from_value(calib_value, n_levels)
    # gamma_grad_weight: the photometric response derivative re-weights the
    # gradient-magnitude maps (Frame.cpp:158-164) — threaded through so the
    # pipelined path is photometrically identical to the sequential one
    pyr, grads = build_direct_pyramid(img.astype(jnp.float32), n_levels,
                                      gamma_grad_weight=gamma_grad_weight)
    R_b, t_b = motion_hypotheses_device(
        ref_c2w, prev_c2w, prevprev_c2w, have_motion, dt_ratio=dt_ratio)
    res, _ = track_coarse_multi(
        template, pyr, K_pyr, R_b, t_b, aff0,
        exp_ref, exp_new, aff_ref, cfg, coarsest_lvl=n_levels - 1,
    )
    T_rn = jnp.eye(4).at[:3, :3].set(res.R).at[:3, 3].set(res.t)
    c2w = ref_c2w @ _rigid_inv(T_rn)
    return TrackStepOut(
        pyr=pyr, grads=grads, R=res.R, t=res.t, aff=res.aff, ok=res.ok,
        residuals=res.residuals, flow=res.flow, c2w=c2w,
    )
