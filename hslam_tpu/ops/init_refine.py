"""Direct photometric refinement of the two-view bootstrap.

Batched device re-design of the reference's DirectRefinement
(Src/Initializer.cpp:1330-2314): after the indirect two-view reconstruction
(H/F RANSAC + triangulation), jointly refine the relative pose, affine
brightness, and per-feature inverse depths with a level-0 photometric LM —
including the three regularizers that make low-parallax bootstraps robust:

  * translation/alpha prior (Initializer.cpp:2097-2108,2143-2150): while the
    solution has not "snapped" (alphaEnergy = alphaW*(sum (idepth-1)^2 +
    ||t||^2 * npts) <= alphaK*npts), every idepth is pulled toward 1 and the
    translation toward 0 with weight alphaW — preventing the depth/scale
    collapse of a near-pure-rotation start;
  * iR coupling (couplingWeight, :2123-2127, calcEC :2207-2227): once
    snapped, idepths are coupled to their running regularization target iR
    (triangulated seeds before the snap, the accepted idepth after);
  * untriangulated down-weighting (:2006-2007): features without a
    triangulated depth participate at 0.1x Huber weight — density helps the
    pose, bad seeds don't.

The per-point structure is SoA: one fused residual pass produces the 8x8
pose+affine system, the per-point Schur scalars, and the energies; the LM
loop is a lax.while_loop with branchless accept/reject. Per-point idepth
steps are clamped by the reference's maxstep rule (:2027-2028,2170-2186).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import PATTERN, PATTERN_NUM, Config
from ..utils import lie
from ..utils.interp import bilinear


class RefineResult(NamedTuple):
    R: jnp.ndarray          # (3, 3) firstToNew rotation
    t: jnp.ndarray          # (3,)
    aff: jnp.ndarray        # (2,) relative (a, b)
    idepth: jnp.ndarray     # (P,) refined inverse depths (first frame)
    good: jnp.ndarray       # (P,) bool
    snapped: jnp.ndarray    # () bool — alpha prior released (enough parallax)
    energy: jnp.ndarray     # () mean photometric energy per good point


def _residual_pass(colors, u, v, idepth, good, tri, R, t, aff,
                   target, K4, cfg: Config):
    """One evaluation at (R, t, aff, idepth): per-point energies, the 8x8
    pose+affine accumulators, and the per-point Schur scalars
    (calcResAndGS, Initializer.cpp:1899-2155)."""
    H_img, W_img = target.shape[0], target.shape[1]
    fx, fy, cx, cy = K4[0], K4[1], K4[2], K4[3]
    pat = jnp.asarray(PATTERN, jnp.float32)

    up = u[:, None] + pat[None, :, 0]               # (P, 8)
    vp = v[:, None] + pat[None, :, 1]
    xh = (up - cx) / fx
    yh = (vp - cy) / fy
    # pt = R * (xh, yh, 1) + t * idepth  (per pattern tap)
    ptx = R[0, 0] * xh + R[0, 1] * yh + R[0, 2] + t[0] * idepth[:, None]
    pty = R[1, 0] * xh + R[1, 1] * yh + R[1, 2] + t[1] * idepth[:, None]
    ptz = R[2, 0] * xh + R[2, 1] * yh + R[2, 2] + t[2] * idepth[:, None]
    ptzs = jnp.where(jnp.abs(ptz) < 1e-12, 1e-12, ptz)
    un = ptx / ptzs
    vn = pty / ptzs
    Ku = fx * un + cx
    Kv = fy * vn + cy
    new_idepth = idepth[:, None] / ptzs

    inb = (Ku > 1) & (Kv > 1) & (Ku < W_img - 2) & (Kv < H_img - 2) & (new_idepth > 0)

    hit = bilinear(target, Ku, Kv)                  # (P, 8, 3)
    hit_I, hit_dx, hit_dy = hit[..., 0], hit[..., 1], hit[..., 2]

    a_rel = jnp.exp(aff[0])
    residual = hit_I - a_rel * colors - aff[1]
    abs_r = jnp.abs(residual)
    hw = jnp.where(abs_r < cfg.huber_th, 1.0,
                   cfg.huber_th / jnp.maximum(abs_r, 1e-12))
    # untriangulated features: 0.1x weight (Initializer.cpp:2006-2007)
    hw = jnp.where(tri[:, None], hw, hw * 0.1)

    tap_ok = inb & jnp.isfinite(hit_I) & jnp.isfinite(colors)
    energy_tap = hw * residual * residual * (2.0 - hw)
    energy = jnp.sum(jnp.where(tap_ok, energy_tap, 0.0), axis=-1)   # (P,)
    all_ok = jnp.all(tap_ok, axis=-1)
    out_th = PATTERN_NUM * cfg.outlier_th
    is_good_new = good & all_ok & (energy <= out_th * 20.0)

    # Jacobian rows (Initializer.cpp:2009-2040); sqrt-Huber on J like the
    # reference (hw<1 -> sqrt(hw) folded into the gradient terms)
    hws = jnp.where(hw < 1.0, jnp.sqrt(hw), hw)
    dxdd = (t[0] - t[2] * un) / ptzs
    dydd = (t[1] - t[2] * vn) / ptzs
    dxi = hws * hit_dx * fx
    dyi = hws * hit_dy * fy
    dd = dxdd * dxi + dydd * dyi                    # (P, 8) d r / d idepth
    J = jnp.stack(
        [
            new_idepth * dxi,
            new_idepth * dyi,
            -new_idepth * (un * dxi + vn * dyi),
            -un * vn * dxi - (1.0 + vn * vn) * dyi,
            (1.0 + un * un) * dxi + un * vn * dyi,
            un * dyi - vn * dxi,
            hws * (-a_rel) * colors,
            hws * (-jnp.ones_like(colors)),
        ],
        axis=-1,
    )  # (P, 8taps, 8dof)
    r_w = hws * residual

    m = (is_good_new[:, None] & tap_ok).astype(jnp.float32)[..., None]
    Jm = J * m
    # per-point accumulators
    Jb = jnp.einsum("ptk,pt->pk", Jm, dd)           # (P, 8)  pose x idepth
    Hdd = jnp.sum(dd * dd * m[..., 0], axis=-1)     # (P,)
    bd = jnp.sum(dd * r_w * m[..., 0], axis=-1)     # (P,)
    # pose system
    H8 = jnp.einsum("pti,ptj->ij", Jm, Jm)
    b8 = jnp.einsum("pti,pt->i", Jm, r_w * m[..., 0])

    # maxstep: min over taps of 1/|(dxdd*fx, dydd*fy)| (:2027-2028)
    step_den = jnp.sqrt((dxdd * fx) ** 2 + (dydd * fy) ** 2)
    maxstep = jnp.min(
        jnp.where(tap_ok, 1.0 / jnp.maximum(step_den, 1e-10), 1e10), axis=-1)

    return (energy, is_good_new, J, Jb, Hdd, bd, H8, b8, maxstep)


def direct_refine(
    first_dir0: jnp.ndarray,     # (H, W, 3) first-frame level-0 [I, dx, dy]
    second_dir0: jnp.ndarray,    # (H, W, 3) second frame
    u: jnp.ndarray,              # (P,) feature coords in the first frame
    v: jnp.ndarray,
    valid: jnp.ndarray,          # (P,) bool candidate mask
    idepth0: jnp.ndarray,        # (P,) triangulated seeds (any value if ~tri)
    triangulated: jnp.ndarray,   # (P,) bool
    R0: jnp.ndarray,             # (3, 3) firstToNew initial rotation
    t0: jnp.ndarray,             # (3,)
    K4: jnp.ndarray,             # (4,) [fx, fy, cx, cy]
    cfg: Config,
    max_iterations: int = 60,
    aff0: jnp.ndarray | None = None,
) -> RefineResult:
    """DirectRefinement::Refine (Initializer.cpp:1412-1564) at level 0."""
    P = u.shape[0]
    pat = jnp.asarray(PATTERN, jnp.float32)
    colors = bilinear(first_dir0[..., 0],
                      u[:, None] + pat[None, :, 0],
                      v[:, None] + pat[None, :, 1])          # (P, 8)
    finite = jnp.all(jnp.isfinite(colors), axis=-1) & valid

    idepth = jnp.where(triangulated, jnp.maximum(idepth0, 1e-3), 1.0)
    iR = idepth
    aff = jnp.zeros(2, jnp.float32) if aff0 is None else aff0

    alphaK = 2.5 * 2.5
    alphaW = 150.0 * 150.0
    coupling = 1.0

    def total_energy(energy, is_good, idepth_c, iR_c, t_c, snapped):
        npts = jnp.maximum(jnp.sum(finite.astype(jnp.float32)), 1.0)
        E_photo = jnp.sum(jnp.where(is_good, energy, 0.0))
        e_alpha = jnp.sum(jnp.where(is_good, (idepth_c - 1.0) ** 2, 0.0))
        alphaE = alphaW * (e_alpha + jnp.sum(t_c * t_c) * npts)
        capped = alphaE > alphaK * npts
        alphaE = jnp.minimum(alphaE, alphaK * npts)
        E_coup = jnp.where(
            snapped,
            coupling * jnp.sum(jnp.where(is_good, (idepth_c - iR_c) ** 2, 0.0)),
            0.0,
        )
        return E_photo + alphaE + E_coup, capped

    def solve_step(J_unused, Jb, Hdd, bd, H8, b8, idepth_c, iR_c, t_c,
                   is_good, snapped, lam):
        npts = jnp.maximum(jnp.sum(finite.astype(jnp.float32)), 1.0)
        # alpha vs coupling mode (Initializer.cpp:2100-2127)
        e_alpha = jnp.sum(jnp.where(is_good, (idepth_c - 1.0) ** 2, 0.0))
        alphaE = alphaW * (e_alpha + jnp.sum(t_c * t_c) * npts)
        alpha_opt = jnp.where(alphaE > alphaK * npts, 0.0, alphaW)

        bd_r = bd + alpha_opt * (idepth_c - 1.0)
        Hdd_r = Hdd + alpha_opt
        bd_r = bd_r + jnp.where(alpha_opt == 0.0,
                                coupling * (idepth_c - iR_c), 0.0)
        Hdd_r = Hdd_r + jnp.where(alpha_opt == 0.0, coupling, 0.0)
        w = jnp.where(is_good, 1.0 / (1.0 + Hdd_r), 0.0)       # (P,)

        # Schur terms (acc9SC, :2129-2141)
        Hsc = jnp.einsum("pi,pj,p->ij", Jb, Jb, w)
        bsc = jnp.einsum("pi,p,p->i", Jb, bd_r, w)

        # translation prior block (:2143-2150; the reference uses the SE3
        # log's translation component — t itself for these small motions)
        Hl = H8.at[jnp.arange(3), jnp.arange(3)].add(alpha_opt * npts)
        bl = b8.at[:3].add(alpha_opt * npts * t_c)

        Hl = Hl + jnp.diag(jnp.diag(Hl)) * lam
        Hl = Hl - Hsc * (1.0 / (1.0 + lam))
        bl2 = bl - bsc * (1.0 / (1.0 + lam))
        inc = -jnp.linalg.solve(Hl, bl2)
        inc = jnp.where(jnp.isfinite(inc), inc, 0.0)
        return inc, w, bd_r, alpha_opt

    def lm_cond(carry):
        (it, R, t, aff_c, idepth_c, iR_c, good_c, energy_c, Jb, Hdd, bd,
         H8, b8, maxstep, lam, fails, snapped, done) = carry
        return (it < max_iterations) & ~done

    def lm_body(carry):
        (it, R, t, aff_c, idepth_c, iR_c, good_c, energy_c, Jb, Hdd, bd,
         H8, b8, maxstep, lam, fails, snapped, done) = carry

        inc, w, bd_r, alpha_opt = solve_step(
            None, Jb, Hdd, bd, H8, b8, idepth_c, iR_c, t, good_c, snapped, lam)

        dR, dt = lie.se3_exp(inc[:6])
        R_n, t_n = lie.se3_mul(dR, dt, R, t)
        aff_n = aff_c + inc[6:8]

        # per-point idepth step with maxstep clamp (doStep, :2156-2186)
        b_pt = bd_r + Jb @ inc
        step = -b_pt * w / (1.0 + lam)
        ms = 0.25 * maxstep
        step = jnp.clip(step, -ms, ms)
        idepth_n = jnp.clip(idepth_c + step, 1e-3, 50.0)
        idepth_n = jnp.where(good_c, idepth_n, iR_c)

        (energy_n, good_n, _, Jb_n, Hdd_n, bd_n, H8_n, b8_n, maxstep_n) = \
            _residual_pass(colors, u, v, idepth_n, finite, triangulated,
                           R_n, t_n, aff_n, second_dir0, K4, cfg)

        E_old, _ = total_energy(energy_c, good_c, idepth_c, iR_c, t, snapped)
        E_new, capped_n = total_energy(energy_n, good_n, idepth_n, iR_c,
                                       t_n, snapped)
        accept = (E_new < E_old) & ~done

        snapped = snapped | (accept & capped_n)
        R = jnp.where(accept, R_n, R)
        t = jnp.where(accept, t_n, t)
        aff_c = jnp.where(accept, aff_n, aff_c)
        idepth_c = jnp.where(accept, idepth_n, idepth_c)
        good_c = jnp.where(accept, good_n, good_c)
        energy_c = jnp.where(accept, energy_n, energy_c)
        Jb = jnp.where(accept, Jb_n, Jb)
        Hdd = jnp.where(accept, Hdd_n, Hdd)
        bd = jnp.where(accept, bd_n, bd)
        H8 = jnp.where(accept, H8_n, H8)
        b8 = jnp.where(accept, b8_n, b8)
        maxstep = jnp.where(accept, maxstep_n, maxstep)
        # optReg after acceptance (:2231-2270: iR tracks the accepted idepth)
        iR_c = jnp.where(accept & good_c, idepth_c, iR_c)
        lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-4),
                        jnp.minimum(lam * 4.0, 1e4))
        fails = jnp.where(accept, 0, fails + 1)
        done = done | (jnp.linalg.norm(inc) <= 1e-4) | (fails >= 2)
        return (it + 1, R, t, aff_c, idepth_c, iR_c, good_c, energy_c,
                Jb, Hdd, bd, H8, b8, maxstep, lam, fails, snapped, done)

    (energy0, good0, _, Jb0, Hdd0, bd0, H80, b80, maxstep0) = _residual_pass(
        colors, u, v, idepth, finite, triangulated, R0, t0, aff,
        second_dir0, K4, cfg)

    carry = (jnp.int32(0), R0, t0, aff, idepth, iR, good0, energy0,
             Jb0, Hdd0, bd0, H80, b80, maxstep0, jnp.float32(0.1),
             jnp.int32(0), jnp.bool_(False), jnp.bool_(False))
    out = jax.lax.while_loop(lm_cond, lm_body, carry)
    (_, R, t, aff, idepth, iR, good, energy) = out[:8]
    snapped = out[16]

    n_good = jnp.maximum(jnp.sum(good), 1)
    return RefineResult(
        R=R, t=t, aff=aff, idepth=idepth, good=good,
        snapped=snapped,
        energy=jnp.sum(jnp.where(good, energy, 0.0)) / n_good,
    )
