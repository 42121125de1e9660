"""Online photometric calibration: joint response / vignette / exposure.

The reference declares this capability but ships it fully commented out
(reference: Include/OnlineCalibrator.h:13-67, Src/PhotometricDistorter/
OnlineCalibrator.cpp — dead; the live hook points are the
PhotoUnDistMode::OnlineCalib enum, GlobalTypes.h:89-95, and
PhotometricUndistorter::UpdateGamma, photometricUndistorter.cpp:175-200).
This module implements the capability as batched device code.

Model (classic online photometric calibration, Bergmann et al. style):
    O_ik = G( e_i * V(r_ik) * L_k )
for observation O of scene point k in frame i at normalized radius r.
In log-irradiance space with U = log o G^{-1}:
    U(O_ik) = log e_i + log V(r_ik) + log L_k
Parametrization (all smooth, jit/autodiff-friendly):
  * U: monotone piecewise-linear over [0, 255] with softplus-positive
    increments (n_knots);
  * V: even radial polynomial 1 + a2 r^2 + a4 r^4 + a6 r^6;
  * e_i: per-frame log-exposures; L_k: per-point log-radiance.
Gauge is fixed by pinning U(255)=log(255), frame-0 exposure = 1.
Optimization: joint Gauss-Newton via autodiff JVPs (small dense system
over [knots + 3 + F]; radiances eliminated in closed form per point).

Outputs plug into the per-frame correction path: `gamma_lut()` returns the
256-entry response G for PhotometricUndistorter-style use
(ops/undistort.invert_response / response_grad_weight).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.flatten_util
import jax.numpy as jnp


class PhotoParams(NamedTuple):
    u_raw: jnp.ndarray       # (n_knots,) raw increments of U (softplus'd)
    u_span_raw: jnp.ndarray  # () raw log-irradiance span of U (softplus'd)
    vig: jnp.ndarray         # (3,) [a2, a4, a6]
    log_exp: jnp.ndarray     # (F,) per-frame log exposure (frame 0 pinned)


def init_params(n_frames: int, n_knots: int = 16) -> PhotoParams:
    return PhotoParams(
        u_raw=jnp.zeros(n_knots),
        u_span_raw=jnp.asarray(5.96),    # softplus ~ 5.96 -> span ~ 6.5
        vig=jnp.zeros(3),
        log_exp=jnp.zeros(n_frames),
    )


def _U(params: PhotoParams, obs: jnp.ndarray) -> jnp.ndarray:
    """Monotone map observed intensity [0,255] -> log irradiance.
    U(255)=log(255) is the gauge pin; U(0) = log(255) - span with the span
    a free parameter — a FIXED span would impose an arbitrary response
    scale (the gamma-ambiguity direction, G vs G^a), contradicting pinned
    exposures and biasing the recovered curve toward identity."""
    n = params.u_raw.shape[0]
    inc = jax.nn.softplus(params.u_raw) + 1e-4         # positive increments
    csum = jnp.concatenate([jnp.zeros(1), jnp.cumsum(inc)])
    csum = csum / csum[-1]                             # 0..1 over n knots
    x = jnp.clip(obs / 255.0, 0.0, 1.0) * n
    i0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, n - 1)
    frac = x - i0
    u01 = csum[i0] * (1 - frac) + csum[i0 + 1] * frac
    hi = jnp.log(255.0)
    span = jax.nn.softplus(params.u_span_raw) + 0.5
    return (hi - span) + u01 * span


def _log_vignette(params: PhotoParams, r2: jnp.ndarray) -> jnp.ndarray:
    a2, a4, a6 = params.vig[0], params.vig[1], params.vig[2]
    v = 1.0 + a2 * r2 + a4 * r2 * r2 + a6 * r2 * r2 * r2
    # [0.1, 4]: physical lens falloff never leaves this range; the clip is
    # the last-ditch bound on correction damage if the fit still overshoots
    return jnp.log(jnp.clip(v, 0.1, 4.0))


def residuals(params: PhotoParams, obs: jnp.ndarray, frame_idx: jnp.ndarray,
              r2: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """obs: (P, F) tracked-point intensities; r2: (P, F) normalized radius^2;
    mask: (P, F) observation validity. Returns masked residuals (P, F):
    U(O) - log e_i - log V - mean_over_frames(...) (radiance eliminated)."""
    le = params.log_exp.at[0].set(0.0)                 # gauge: e_0 = 1
    x = _U(params, obs) - le[frame_idx] - _log_vignette(params, r2)
    m = mask.astype(jnp.float32)
    # closed-form radiance: weighted mean per point
    L = jnp.sum(x * m, axis=1) / jnp.maximum(jnp.sum(m, axis=1), 1.0)
    return (x - L[:, None]) * m


@partial(jax.jit, static_argnames=("n_iters",))
def calibrate(params: PhotoParams, obs: jnp.ndarray, frame_idx: jnp.ndarray,
              r2: jnp.ndarray, mask: jnp.ndarray, n_iters: int = 20,
              lam: float = 1e-4, smooth_w: float = 0.3,
              exp_known: jnp.ndarray | None = None,
              vig_w: tuple = (0.02, 0.2, 2.0),
              prev: "PhotoParams | None" = None, prev_w: float = 0.5):
    """Joint GN over (u_raw, vig, log_exp). Returns updated params and the
    final data-residual RMS.

    `smooth_w` regularizes the log-increments of the response toward
    uniformity — without it the problem has a near-degenerate minimum that
    flattens the response over the observed range and zeroes the exposures
    (the response shape is only constrained where observations overlap).

    `vig_w` Tikhonov-regularizes the vignette polynomial with graduated
    weights on (a2, a4, a6). Tracked-point observations in one window cover
    a NARROW radius band; unregularized, the even polynomial extrapolates
    catastrophically outside it (measured: fitted a6 swinging to ~280 on a
    ground-truth a2-only vignette, making the "correction" worse than raw).
    The weights ride the same sqrt(n_obs) scale as the data norm, so a2 at
    w=0.02 moves freely to genuine values (~-0.45) while a6 at w=2 cannot
    run away.

    `prev` (a PhotoParams or None) adds a weak prior toward the previous
    refit's vignette/response — the temporal smoothing that keeps
    successive online refits from oscillating (each window sees different
    frames; the applied LUT is a blend, so per-refit swings photometrically
    de-sync the window).

    `exp_known` ((F,) exposure times or None): with UNKNOWN exposures the
    problem has a 1-parameter gauge ambiguity — U -> a*U is absorbed exactly
    by scaled log-exposures/radiances and near-exactly by the vignette
    polynomial (equivalently G(x) vs G(x)^a; the classic gamma ambiguity of
    joint response+exposure estimation). Real datasets the reference targets
    ship exposure times (TUM-MonoVO; consumed by photometricUndistorter.cpp:
    121-146), and pinning log-exposures to the telemetry breaks the gauge,
    making the full response shape identifiable."""
    flat, unravel = jax.flatten_util.ravel_pytree(params)
    n_obs = jnp.sqrt(jnp.maximum(jnp.sum(mask), 1.0))
    vig_wv = jnp.asarray(vig_w)

    def res_flat(p):
        pp = unravel(p)
        data = residuals(pp, obs, frame_idx, r2, mask).reshape(-1)
        log_inc = jnp.log(jax.nn.softplus(pp.u_raw) + 1e-4)
        reg = smooth_w * (n_obs / pp.u_raw.shape[0]) * jnp.diff(log_inc)
        reg = jnp.concatenate([reg, vig_wv * n_obs * pp.vig])
        if prev is not None:
            reg_p = jnp.concatenate([
                prev_w * n_obs * (pp.vig - prev.vig),
                prev_w * (n_obs / pp.u_raw.shape[0])
                * (pp.u_raw - prev.u_raw),
            ])
            reg = jnp.concatenate([reg, reg_p])
        if exp_known is not None:
            # exposure telemetry: pin log-exposures (relative to frame 0,
            # matching the e_0 = 1 gauge of `residuals`)
            le_t = jnp.log(jnp.maximum(exp_known, 1e-6))
            le_t = le_t - le_t[0]
            reg_e = 10.0 * n_obs * (pp.log_exp.at[0].set(0.0) - le_t)
            reg = jnp.concatenate([reg, reg_e])
        return jnp.concatenate([data, reg])

    n_data = obs.size

    def body(_, carry):
        p, _ = carry
        r = res_flat(p)
        J = jax.jacfwd(res_flat)(p)
        H = J.T @ J
        H = H + jnp.diag(jnp.maximum(jnp.diag(H), 1e-8)) * lam
        dp = -jnp.linalg.solve(H, J.T @ r)
        p_new = p + dp
        r_new = res_flat(p_new)
        better = jnp.sum(r_new**2) < jnp.sum(r**2)
        p = jnp.where(better, p_new, p)
        r_eff = jnp.where(better, r_new, r)[:n_data]
        rms = jnp.sqrt(jnp.sum(r_eff**2) / jnp.maximum(jnp.sum(mask), 1.0))
        return p, rms

    flat, rms = jax.lax.fori_loop(0, n_iters, body, (flat, jnp.float32(0.0)))
    return unravel(flat), rms


def gamma_lut(params: PhotoParams) -> jnp.ndarray:
    """The response curve G as a 256-entry LUT mapping irradiance-index to
    observed intensity — the format PhotometricUndistorter::UpdateGamma
    consumes (photometricUndistorter.cpp:175-200). G = U^{-1} rescaled to
    [0, 255]."""
    obs = jnp.arange(256.0)
    u = _U(params, obs)                    # log irradiance per observed level
    irr = jnp.exp(u)
    irr = (irr - irr[0]) / (irr[-1] - irr[0]) * 255.0
    # G maps irradiance -> observed: invert the monotone table
    idx = jnp.searchsorted(irr, jnp.arange(256.0))
    idx = jnp.clip(idx, 1, 255)
    lo = irr[idx - 1]
    hi = irr[idx]
    frac = jnp.where(hi > lo, (jnp.arange(256.0) - lo) / jnp.maximum(hi - lo, 1e-9), 0.0)
    return jnp.clip((idx - 1) + frac, 0.0, 255.0)


def vignette_map(params: PhotoParams, height: int, width: int) -> jnp.ndarray:
    """Dense V(x) map for the correction kernel."""
    ys, xs = jnp.mgrid[0:height, 0:width]
    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    r2 = ((xs - cx) ** 2 + (ys - cy) ** 2) / (cx * cx + cy * cy)
    return jnp.exp(_log_vignette(params, r2))
