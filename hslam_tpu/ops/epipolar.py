"""Batched epipolar depth tracing for candidate (immature) points.

Batched device re-design of ImmaturePoint::traceOn
(reference: Src/ImmaturePoint.cpp:40-360): every candidate point is traced
against the new frame in parallel — the data-dependent discrete search
(<= 100 steps along the epipolar line) becomes a fixed (P, 100, 8)
gather + SSD with step masking, followed by `setting_trace_GNIterations`
masked Gauss-Newton refinements along the line, and the inverse-depth
interval update from the matched coordinate +- errorInPixel.

Status machine (ImmaturePoint.h:24-30):
  GOOD / OOB / OUTLIER / SKIPPED / BADCONDITION / UNINITIALIZED.
OOB is sticky (traceOn returns immediately for OOB points); OUTLIER
escalates to OOB on the second consecutive outlier verdict.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import PATTERN, PATTERN_NUM, Config

IPS_GOOD = 0
IPS_OOB = 1
IPS_OUTLIER = 2
IPS_SKIPPED = 3
IPS_BADCONDITION = 4
IPS_UNINITIALIZED = 5


class TraceState(NamedTuple):
    """Per-candidate trace state (SoA)."""

    idepth_min: jnp.ndarray   # (P,)
    idepth_max: jnp.ndarray   # (P,) — +inf when uninitialized
    status: jnp.ndarray       # (P,) int32
    quality: jnp.ndarray      # (P,)
    last_u: jnp.ndarray       # (P,) last matched coordinate
    last_v: jnp.ndarray
    last_interval: jnp.ndarray  # (P,) pixel interval of last trace


def init_trace_state(n: int) -> TraceState:
    return TraceState(
        idepth_min=jnp.zeros(n, jnp.float32),
        idepth_max=jnp.full(n, jnp.inf, jnp.float32),
        status=jnp.full(n, IPS_UNINITIALIZED, jnp.int32),
        quality=jnp.full(n, 10000.0, jnp.float32),
        last_u=jnp.full(n, -1.0, jnp.float32),
        last_v=jnp.full(n, -1.0, jnp.float32),
        last_interval=jnp.zeros(n, jnp.float32),
    )


def trace_on(
    state: TraceState,
    u: jnp.ndarray,            # (P,) host pixel coords
    v: jnp.ndarray,
    color: jnp.ndarray,        # (P, 8) host pattern colors
    weights: jnp.ndarray,      # (P, 8)
    gradH: jnp.ndarray,        # (P, 2, 2) pattern gradient outer-product sum
    energy_th: jnp.ndarray,    # (P,)
    point_valid: jnp.ndarray,  # (P,) bool
    KRKi: jnp.ndarray,         # (P, 3, 3) host->new plane warp (per point)
    Kt: jnp.ndarray,           # (P, 3)
    affine: jnp.ndarray,       # (P, 2) host->new (a, b)
    target: jnp.ndarray,       # (H, W, 3) new frame direct image
    cfg: Config,
) -> TraceState:
    """One trace pass of all candidates against a new frame."""
    Himg, Wimg = target.shape[0], target.shape[1]
    P = u.shape[0]
    max_pix_search = (Wimg + Himg) * cfg.max_pix_search

    skip = (state.status == IPS_OOB) | ~point_valid

    # broadcast form, not einsum: P-batched 3x3 dots
    uv1 = jnp.stack([u, v, jnp.ones_like(u)], -1)
    pr = jnp.sum(KRKi * uv1[:, None, :], axis=-1)
    ptp_min = pr + Kt * state.idepth_min[:, None]
    u_min = ptp_min[:, 0] / ptp_min[:, 2]
    v_min = ptp_min[:, 1] / ptp_min[:, 2]

    def inb(x, y):
        return (x > 4) & (y > 4) & (x < Wimg - 5) & (y < Himg - 5)

    oob = ~inb(u_min, v_min)

    has_max = jnp.isfinite(state.idepth_max)
    id_max_eff = jnp.where(has_max, state.idepth_max, 0.01)
    ptp_max = pr + Kt * id_max_eff[:, None]
    u_max = ptp_max[:, 0] / ptp_max[:, 2]
    v_max = ptp_max[:, 1] / ptp_max[:, 2]

    dist_known = jnp.sqrt((u_min - u_max) ** 2 + (v_min - v_max) ** 2)
    # uninitialized: direction from the 0.01-depth projection, range capped
    dxy_n = 1.0 / jnp.maximum(dist_known, 1e-12)
    u_max_uninit = u_min + max_pix_search * (u_max - u_min) * dxy_n
    v_max_uninit = v_min + max_pix_search * (v_max - v_min) * dxy_n
    u_max = jnp.where(has_max, u_max, u_max_uninit)
    v_max = jnp.where(has_max, v_max, v_max_uninit)
    dist = jnp.where(has_max, dist_known, max_pix_search)

    oob = oob | ~inb(u_max, v_max)
    # scale-change gate (ImmaturePoint.cpp:135)
    oob = oob | ~(
        (state.idepth_min < 0) | ((ptp_min[:, 2] > 0.75) & (ptp_min[:, 2] < 1.5))
    )

    skipped = has_max & (dist < cfg.trace_slack_interval)

    # error bound from pattern gradient vs. epipolar direction
    # (ImmaturePoint.cpp:144-161)
    dx = cfg.trace_step_size * (u_max - u_min)
    dy = cfg.trace_step_size * (v_max - v_min)
    e = jnp.stack([dx, dy], -1)
    e_perp = jnp.stack([dy, -dx], -1)
    a = jnp.sum(e[:, :, None] * gradH * e[:, None, :], axis=(1, 2))
    b = jnp.sum(e_perp[:, :, None] * gradH * e_perp[:, None, :], axis=(1, 2))
    error_in_pixel = 0.2 + 0.2 * (a + b) / jnp.maximum(a, 1e-12)
    badcond = (error_in_pixel * cfg.trace_min_improvement_factor > dist) & has_max
    error_in_pixel = jnp.minimum(error_in_pixel, 10.0)

    # normalize direction; cap search length
    dxn = dx / jnp.maximum(dist, 1e-12)
    dyn = dy / jnp.maximum(dist, 1e-12)
    oob = oob | ~jnp.isfinite(dxn) | ~jnp.isfinite(dyn)
    over = dist > max_pix_search
    u_max = jnp.where(over, u_min + max_pix_search * dxn, u_max)
    v_max = jnp.where(over, v_min + max_pix_search * dyn, v_max)
    dist = jnp.minimum(dist, max_pix_search)

    n_steps = jnp.minimum(
        (1.9999 + dist / cfg.trace_step_size).astype(jnp.int32), cfg.trace_max_steps - 1
    )

    # deterministic sub-pixel shift (ImmaturePoint.cpp:183)
    rand_shift = u_min * 1000.0 - jnp.floor(u_min * 1000.0)
    ptx0 = u_min - rand_shift * dxn
    pty0 = v_min - rand_shift * dyn

    # rotated pattern (ImmaturePoint.cpp:181,188-190)
    pat = jnp.asarray(PATTERN, jnp.float32)                    # (8, 2)
    Rp = KRKi[:, :2, :2]                                       # (P, 2, 2)
    # rot_pat[p,k,i] = sum_j Rp[p,i,j] pat[k,j] — broadcast, not einsum
    rot_pat = jnp.sum(Rp[:, None, :, :] * pat[None, :, None, :], axis=-1)

    # --- discrete search: (P, S, 8) sample grid at stride 2
    S = (cfg.trace_max_steps + 1) // 2
    steps = jnp.arange(S, dtype=jnp.float32)
    # stride-2 sample positions along the line (pixel offsets 0,2,4,...)
    px = ptx0[:, None] + (steps[None, :] * 2.0) * dxn[:, None]   # (P, S)
    py = pty0[:, None] + (steps[None, :] * 2.0) * dyn[:, None]

    # packed-cell image: one gather per bilinear sample (see
    # utils.interp.pack_cells) — the discrete search is gather-bound
    from ..utils.interp import bilinear_packed, pack_cells

    packed = pack_cells(target[:, :, 0])

    def sample(x, y):
        return bilinear_packed(packed, x, y)

    def ssd_at(px_, py_):
        sx_ = px_[..., None] + rot_pat[:, None, :, 0]
        sy_ = py_[..., None] + rot_pat[:, None, :, 1]
        hit_ = sample(sx_, sy_)
        r_ = hit_ - (affine[:, None, None, 0] * color[:, None, :]
                     + affine[:, None, None, 1])
        a_ = jnp.abs(r_)
        hw_ = jnp.where(a_ < cfg.huber_th, 1.0,
                        cfg.huber_th / jnp.maximum(a_, 1e-12))
        return jnp.sum(hw_ * r_ * r_ * (2.0 - hw_), axis=-1)

    # two-phase search: stride-2 sweep, then +-1 refinement around the
    # winner — halves the gather traffic of the reference's unit-stride
    # sweep; the SSD over the smoothed 8-pattern is ~1px smooth so the
    # refinement recovers the unit-stride winner (GN then goes sub-pixel)
    energies = ssd_at(px, py)                                  # (P, S) stride 2
    steps_px = steps * 2.0
    step_valid = steps_px[None, :] < n_steps[:, None].astype(jnp.float32)
    energies = jnp.where(step_valid, energies, 1e10)

    best_i2 = jnp.argmin(energies, axis=-1)
    best_energy = jnp.min(energies, axis=-1)
    best_step = best_i2.astype(jnp.float32) * 2.0              # pixel units

    # refine: evaluate best_step - 1 and + 1
    ref_steps = jnp.stack([best_step - 1.0, best_step + 1.0], -1)  # (P, 2)
    ref_valid = (ref_steps >= 0) & (ref_steps < n_steps[:, None].astype(jnp.float32))
    rx = ptx0[:, None] + ref_steps * dxn[:, None]
    ry = pty0[:, None] + ref_steps * dyn[:, None]
    ref_E = jnp.where(ref_valid, ssd_at(rx, ry), 1e10)         # (P, 2)
    all_E = jnp.concatenate([best_energy[:, None], ref_E], axis=-1)
    all_steps = jnp.concatenate([best_step[:, None], ref_steps], axis=-1)
    pick = jnp.argmin(all_E, axis=-1)
    best_energy = jnp.take_along_axis(all_E, pick[:, None], 1)[:, 0]
    best_step = jnp.take_along_axis(all_steps, pick[:, None], 1)[:, 0]
    best_u = ptx0 + best_step * dxn
    best_v = pty0 + best_step * dyn

    # second best outside +-2 px radius (ImmaturePoint.cpp:234-242)
    idxs = steps_px[None, :]
    outside = (idxs < best_step[:, None] - 2.0) | (idxs > best_step[:, None] + 2.0)
    second = jnp.min(jnp.where(outside & step_valid, energies, 1e10), axis=-1)
    new_quality = second / jnp.maximum(best_energy, 1e-12)
    quality = jnp.where(
        (new_quality < state.quality) | (n_steps > 10), new_quality, state.quality
    )

    # --- GN refinement along the line (ImmaturePoint.cpp:245-305)
    def gn_body(it, carry):
        bu, bv, bE, ubak, vbak, step_back, done = carry
        gx = bu[:, None] + rot_pat[:, :, 0]
        gy = bv[:, None] + rot_pat[:, :, 1]
        # need gradients: gather the 3-channel image
        xc = jnp.clip(gx, 0.0, Wimg - 1.0)
        yc = jnp.clip(gy, 0.0, Himg - 1.0)
        ix = jnp.clip(jnp.floor(xc).astype(jnp.int32), 0, Wimg - 2)
        iy = jnp.clip(jnp.floor(yc).astype(jnp.int32), 0, Himg - 2)
        fx_ = (xc - ix)[..., None]
        fy_ = (yc - iy)[..., None]
        flat3 = target.reshape(-1, 3)
        base = iy * Wimg + ix
        h00 = flat3[base]
        h01 = flat3[base + 1]
        h10 = flat3[base + Wimg]
        h11 = flat3[base + Wimg + 1]
        hit3 = (h00 * (1 - fx_) + h01 * fx_) * (1 - fy_) + (h10 * (1 - fx_) + h11 * fx_) * fy_

        res = hit3[..., 0] - (affine[:, None, 0] * color + affine[:, None, 1])
        dres = dxn[:, None] * hit3[..., 1] + dyn[:, None] * hit3[..., 2]
        ar = jnp.abs(res)
        hw_ = jnp.where(ar < cfg.huber_th, 1.0, cfg.huber_th / jnp.maximum(ar, 1e-12))
        Hgn = 1.0 + jnp.sum(hw_ * dres * dres, axis=-1)
        bgn = jnp.sum(hw_ * res * dres, axis=-1)
        energy = jnp.sum(weights * weights * hw_ * res * res * (2.0 - hw_), axis=-1)

        worse = energy > bE
        # worse: halve the previous step from the backup point
        sb_worse = step_back * 0.5
        bu_worse = ubak + sb_worse * dxn
        bv_worse = vbak + sb_worse * dyn
        # better: take a clipped GN step
        step = jnp.clip(-bgn / Hgn, -0.5, 0.5)
        step = jnp.where(jnp.isfinite(step), step, 0.0)
        bu_better = bu + step * dxn
        bv_better = bv + step * dyn

        upd = ~done
        new_ubak = jnp.where(worse | ~upd, ubak, bu)
        new_vbak = jnp.where(worse | ~upd, vbak, bv)
        new_sb = jnp.where(upd, jnp.where(worse, sb_worse, step), step_back)
        new_bu = jnp.where(upd, jnp.where(worse, bu_worse, bu_better), bu)
        new_bv = jnp.where(upd, jnp.where(worse, bv_worse, bv_better), bv)
        new_bE = jnp.where(upd & ~worse, energy, bE)
        new_done = done | (jnp.abs(new_sb) < cfg.trace_gn_threshold)
        return new_bu, new_bv, new_bE, new_ubak, new_vbak, new_sb, new_done

    gn_init_E = jnp.full(P, 1e5, jnp.float32)
    best_u, best_v, best_energy, *_ = jax.lax.fori_loop(
        0, cfg.trace_gn_iterations, gn_body,
        (best_u, best_v, gn_init_E, best_u, best_v,
         jnp.zeros(P, jnp.float32), jnp.zeros(P, bool)),
    )

    # --- outlier / interval update (ImmaturePoint.cpp:308-360)
    outlier = ~(best_energy < energy_th * cfg.trace_extra_slack_on_th)

    horiz = dxn * dxn > dyn * dyn
    def interval(coord_lo, coord_hi, axis):
        prc = jnp.where(axis, pr[:, 0], pr[:, 1])
        ktc = jnp.where(axis, Kt[:, 0], Kt[:, 1])
        lo = (pr[:, 2] * coord_lo - prc) / (ktc - Kt[:, 2] * coord_lo)
        hi = (pr[:, 2] * coord_hi - prc) / (ktc - Kt[:, 2] * coord_hi)
        return lo, hi

    lo_h, hi_h = interval(best_u - error_in_pixel * dxn, best_u + error_in_pixel * dxn, True)
    lo_v, hi_v = interval(best_v - error_in_pixel * dyn, best_v + error_in_pixel * dyn, False)
    id_lo = jnp.where(horiz, lo_h, lo_v)
    id_hi = jnp.where(horiz, hi_h, hi_v)
    id_min_new = jnp.minimum(id_lo, id_hi)
    id_max_new = jnp.maximum(id_lo, id_hi)
    bad_interval = (
        ~jnp.isfinite(id_min_new) | ~jnp.isfinite(id_max_new) | (id_max_new < 0)
    )

    # --- combine verdicts in priority order
    was_outlier = state.status == IPS_OUTLIER
    new_status = jnp.full(P, IPS_GOOD, jnp.int32)
    new_status = jnp.where(outlier | bad_interval,
                           jnp.where(was_outlier, IPS_OOB, IPS_OUTLIER), new_status)
    new_status = jnp.where(badcond, IPS_BADCONDITION, new_status)
    new_status = jnp.where(skipped, IPS_SKIPPED, new_status)
    new_status = jnp.where(oob, IPS_OOB, new_status)
    new_status = jnp.where(skip, state.status, new_status)

    good = (new_status == IPS_GOOD) & ~skip
    id_min_out = jnp.where(good, id_min_new, state.idepth_min)
    id_max_out = jnp.where(good, id_max_new, state.idepth_max)

    last_u = jnp.where(good, best_u,
                       jnp.where(skipped | badcond, 0.5 * (u_min + u_max), -1.0))
    last_v = jnp.where(good, best_v,
                       jnp.where(skipped | badcond, 0.5 * (v_min + v_max), -1.0))
    interval_out = jnp.where(
        good, 2.0 * error_in_pixel, jnp.where(skipped | badcond, dist, 0.0)
    )
    last_u = jnp.where(skip, state.last_u, last_u)
    last_v = jnp.where(skip, state.last_v, last_v)
    interval_out = jnp.where(skip, state.last_interval, interval_out)
    quality = jnp.where(skip | ~good, state.quality, quality)

    return TraceState(
        idepth_min=id_min_out,
        idepth_max=id_max_out,
        status=new_status,
        quality=quality,
        last_u=last_u,
        last_v=last_v,
        last_interval=interval_out,
    )
