"""Batched candidate-point activation: idepth-only LM against the window.

Batched device re-design of System::optimizeImmaturePoint
(reference: Src/FullSystemOptPoint.cpp:24-175) and
ImmaturePoint::linearizeResidual (Src/ImmaturePoint.cpp:389-455): all
candidates run the `setting_GNItsOnPointActivation` LM iterations in
parallel with branchless accept/reject; per-candidate output is the
refined inverse depth, the per-target-residual IN mask, and the
activation verdict (Hdd >= setting_minIdepthH_act, >= minObs good
residuals, finite idepth).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import PATTERN, PATTERN_NUM, Config
from ..models import window as W
from ..models.calib import Calib
from ..utils import lie


class ActivationResult(NamedTuple):
    idepth: jnp.ndarray     # (P,) refined inverse depth
    ok: jnp.ndarray         # (P,) bool activation verdict
    res_in: jnp.ndarray     # (P, F) residual IN mask at the solution


def _linearize_idepth(u, v, idepth, color, weights, host,
                      R_rel, t_rel, a_rel, b_rel, images,
                      energy_th, slack, intr, cfg: Config,
                      window_table=None):
    """One evaluation of all (candidate, target) residuals.

    Returns (energy (P,F), Hdd (P,), bd (P,), state_in (P,F), oob (P,F)).
    R_rel/t_rel: (F_host, F_target) relative current poses; indexed by host.

    `window_table` (from ba.build_window_table on the same images): sample
    the 8 taps + gradients from ONE gathered 12x12 window per (cand,
    target) instead of 32 bilinear gather rows — gathers cost per row, and
    this LM runs `gn_iters_on_activation` sweeps per keyframe.
    """
    P = u.shape[0]
    F = images.shape[0]
    Hh, Ww = images.shape[1], images.shape[2]

    Rr = R_rel[host]          # (P, F, 3, 3)
    tr = t_rel[host]          # (P, F, 3)
    a_pf = a_rel[host]
    b_pf = b_rel[host]

    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]

    pat = jnp.asarray(PATTERN, jnp.float32)
    up = u[:, None] + pat[None, :, 0]       # (P, 8)
    vp = v[:, None] + pat[None, :, 1]
    xh = (up - cx) / fx
    yh = (vp - cy) / fy
    dirs = jnp.stack([xh, yh, jnp.ones_like(xh)], -1)    # (P, 8, 3)
    # broadcast form, not einsum: (P,F)-batched 3x3 dots
    rot = jnp.sum(Rr[:, :, None, :, :] * dirs[:, None, :, None, :], axis=-1)
    ptp = rot + tr[:, :, None, :] * idepth[:, None, None, None]
    drescale = 1.0 / jnp.where(jnp.abs(ptp[..., 2]) < 1e-12, 1e-12, ptp[..., 2])
    un = ptp[..., 0] * drescale
    vn = ptp[..., 1] * drescale
    Ku = un * fx + cx
    Kv = vn * fy + cy
    ok_proj = (
        (drescale > 0) & (Ku > 1.1) & (Kv > 1.1) & (Ku < Ww - 3) & (Kv < Hh - 3)
    )
    oob = ~jnp.all(ok_proj, axis=-1)                      # (P, F)

    if window_table is not None:
        from .ba import _window_taps
        hit_I, hit_dxr, hit_dyr, in_win = _window_taps(
            window_table, Ku, Kv, Hh, Ww)
        oob = oob | ~jnp.all(in_win, axis=-1)
        hit = jnp.stack([hit_I, hit_dxr, hit_dyr], axis=-1)
    else:
        def gather_frame(img, KuF, KvF):
            Kuc = jnp.clip(KuF, 0.0, Ww - 1.0)
            Kvc = jnp.clip(KvF, 0.0, Hh - 1.0)
            ix = jnp.clip(jnp.floor(Kuc).astype(jnp.int32), 0, Ww - 2)
            iy = jnp.clip(jnp.floor(Kvc).astype(jnp.int32), 0, Hh - 2)
            dxf = (Kuc - ix)[..., None]
            dyf = (Kvc - iy)[..., None]
            flat = img.reshape(-1, 3)
            base = iy * Ww + ix
            return ((flat[base] * (1 - dxf) + flat[base + 1] * dxf) * (1 - dyf)
                    + (flat[base + Ww] * (1 - dxf) + flat[base + Ww + 1] * dxf) * dyf)

        hit = jax.vmap(gather_frame, in_axes=(0, 1, 1), out_axes=1)(images, Ku, Kv)
    residual = hit[..., 0] - (a_pf[..., None] * color[:, None, :] + b_pf[..., None])
    abs_r = jnp.abs(residual)
    hw = jnp.where(abs_r < cfg.huber_th, 1.0, cfg.huber_th / jnp.maximum(abs_r, 1e-12))
    w2 = weights[:, None, :] ** 2
    energy = jnp.sum(w2 * hw * residual**2 * (2.0 - hw), axis=-1)  # (P, F)

    # idepth jacobian (derive_idepth, Include/DirectProjection.h:7-10)
    dxi = hit[..., 1] * fx
    dyi = hit[..., 2] * fy
    d_id = (dxi * drescale * (tr[:, :, None, 0] - tr[:, :, None, 2] * un)
            + dyi * drescale * (tr[:, :, None, 1] - tr[:, :, None, 2] * vn))

    out = energy > energy_th[:, None] * slack
    energy = jnp.where(out, energy_th[:, None] * slack, energy)
    state_in = ~out & ~oob

    hww = hw * w2
    mask = state_in[..., None].astype(jnp.float32)
    Hdd = jnp.sum(hww * d_id * d_id * mask, axis=(1, 2))
    bd = jnp.sum(hww * residual * d_id * mask, axis=(1, 2))
    energy = jnp.where(oob, 0.0, energy)
    return energy, Hdd, bd, state_in, oob


def activate_points(
    frames: W.Frames,
    calib: Calib,
    u: jnp.ndarray,          # (P,) candidate coords (host frame)
    v: jnp.ndarray,
    idepth0: jnp.ndarray,    # (P,) initial idepth (interval midpoint)
    color: jnp.ndarray,      # (P, 8)
    weights: jnp.ndarray,    # (P, 8)
    host: jnp.ndarray,       # (P,)
    cand_valid: jnp.ndarray,  # (P,)
    cfg: Config,
    min_obs: int = 1,
    window_table=None,
) -> ActivationResult:
    F = frames.valid.shape[0]
    intr = calib.value
    if window_table is None:
        # one gathered window row per (cand, target) instead of 32 bilinear
        # gather rows per LM sweep; inside a fused kf_step XLA CSEs this
        # with the BA's identical table
        from .ba import build_window_table
        window_table = build_window_table(frames.images)

    R_cur, t_cur = W.frame_poses(frames)
    Ri, ti = lie.se3_inverse(R_cur, t_cur)
    R_rel = R_cur[None] @ Ri[:, None]                   # (F_h, F_t, 3, 3)
    t_rel = jnp.einsum("tij,hj->hti", R_cur, ti) + t_cur[None]

    aff = W.frame_affine(frames)
    exp_ = jnp.where(frames.exposure == 0, 1.0, frames.exposure)
    a_rel = jnp.exp(aff[None, :, 0] - aff[:, None, 0]) * (exp_[None, :] / exp_[:, None])
    b_rel = aff[None, :, 1] - a_rel * aff[:, None, 1]

    # residual grid mask: valid target, not host
    grid = (
        cand_valid[:, None]
        & frames.valid[None, :]
        & (host[:, None] != jnp.arange(F)[None, :])
    )

    energy_th = jnp.full_like(u, PATTERN_NUM * cfg.outlier_th
                              * cfg.overall_energy_th_weight**2)

    def lin(idep, slack):
        e, Hdd, bd, s_in, oob = _linearize_idepth(
            u, v, idep, color, weights, host, R_rel, t_rel, a_rel, b_rel,
            frames.images, energy_th, slack, intr, cfg,
            window_table=window_table,
        )
        s_in = s_in & grid
        e = jnp.where(grid, e, 0.0)
        return e.sum(-1), Hdd, bd, s_in

    E0, Hdd0, bd0, in0 = lin(idepth0, 1000.0)
    well = jnp.isfinite(E0) & (Hdd0 >= cfg.min_idepth_h_act)

    def gn_body(it, carry):
        idep, E, Hdd, bd, s_in, lam, ok = carry
        step = bd / (Hdd * (1.0 + lam) + 1e-12)
        new_id = idep - step
        E_n, Hdd_n, bd_n, in_n = lin(new_id, 1.0)
        still_ok = jnp.isfinite(E) & (Hdd_n >= cfg.min_idepth_h_act)
        accept = (E_n < E) & ok
        idep = jnp.where(accept, new_id, idep)
        E = jnp.where(accept, E_n, E)
        Hdd = jnp.where(accept, Hdd_n, Hdd)
        bd = jnp.where(accept, bd_n, bd)
        s_in = jnp.where(accept[:, None], in_n, s_in)
        lam = jnp.where(accept, lam * 0.5, lam * 5.0)
        ok = ok & still_ok
        return idep, E, Hdd, bd, s_in, lam, ok

    idep, E, Hdd, bd, s_in, _, ok = jax.lax.fori_loop(
        0, cfg.gn_its_on_point_activation, gn_body,
        (idepth0, E0, Hdd0, bd0, in0, jnp.full_like(u, 0.1), well),
    )

    n_good = jnp.sum(s_in, axis=-1)
    ok = ok & jnp.isfinite(idep) & (n_good >= min_obs) & cand_valid
    return ActivationResult(idepth=idep, ok=ok, res_in=s_in)
