"""Keyframe-block-sharded GLOBAL bundle adjustment (north-star config #5).

The long-sequence scaling tier between the edge-sharded Sim3 pose graph
(parallel/dist_pose_graph.py — no structure) and the point-sharded
windowed photometric BA (parallel/dist_ba.py — parallel only WITHIN the
7-frame window): a full metric BA over HUNDREDS of keyframes with their
landmark depths, partitioned across the device mesh by KEYFRAME BLOCK.

There is no reference implementation to mirror — the reference is a
single-process sliding-window system (SURVEY.md §5 "long-context":
`ReduceToEssential`, Frame.cpp:194-253, throws the data away instead) —
so this is designed from scratch for a device mesh:

  * State: world-to-cam SE3 poses (N, ...) + per-landmark inverse depth
    (P,) in the HOST keyframe (the DSO parametrization — one scalar per
    point, Schur-eliminated exactly like the window BA's HdiF algebra,
    AccumulatedSCHessian.cpp:10-52).
  * Measurements: pixel reprojections of a landmark into other keyframes
    (the hybrid layer's indirect factors at trajectory scale), Huber-robust.
  * Solve: Gauss-Newton; the reduced camera system (6N x 6N after the
    per-point Schur) is applied MATRIX-FREE inside PCG — each Hx product
    is two segment-sums over observations plus a per-point scalar pass,
    with a block-Jacobi (6x6) preconditioner. No O(N^2) memory anywhere.
  * Sharding: landmarks live with their HOST keyframe; a contiguous block
    of keyframes (and every landmark hosted in it, with all its
    observations) goes to each device. Per-CG-iteration reductions
    (gradient, Hx, preconditioner blocks, chi^2) psum the (N, 6) vectors
    across devices — tiny (12 KB at N=512) — while the observation work scales
    out with the mesh. Cross-block observations need no communication:
    target poses are replicated, only the reductions ride the collective.
  * Gauge: pose 0 pinned (6 dofs) + a soft idepth prior (monocular scale).

Entry points:
  build_problem(...)       -- pack arrays into a GlobalBA pytree
  global_ba(problem, ...)  -- single-device GN/PCG relaxation
  sharded_global_ba(mesh, problem, ...)
                           -- same math, observation work sharded over the
                              mesh axis "kfblocks" (parity-tested equal)
  pad_problem(...)         -- pad P/O to a multiple of the mesh size
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from ..utils import lie


class GlobalBA(NamedTuple):
    # keyframe states (world-to-cam), replicated across shards
    R: jnp.ndarray        # (N, 3, 3)
    t: jnp.ndarray        # (N, 3)
    # landmarks, sharded by host-keyframe block
    host: jnp.ndarray     # (P,) int32 host keyframe index
    pu: jnp.ndarray       # (P,) pixel in host frame
    pv: jnp.ndarray       # (P,)
    rho: jnp.ndarray      # (P,) inverse depth in host frame
    p_valid: jnp.ndarray  # (P,) bool
    # observations (landmark seen in a target keyframe), sharded with
    # their landmark (obs_p indexes the LOCAL landmark shard)
    obs_p: jnp.ndarray    # (O,) int32 landmark index
    obs_t: jnp.ndarray    # (O,) int32 target keyframe index
    obs_uv: jnp.ndarray   # (O, 2) measured pixel
    obs_w: jnp.ndarray    # (O,) weight; 0 disables


def build_problem(R, t, host, pu, pv, rho, obs_p, obs_t, obs_uv,
                  obs_w=None, p_valid=None) -> GlobalBA:
    obs_p = jnp.asarray(obs_p, jnp.int32)
    if obs_w is None:
        obs_w = jnp.ones(obs_p.shape[0], jnp.float32)
    host = jnp.asarray(host, jnp.int32)
    if p_valid is None:
        p_valid = jnp.ones(host.shape[0], bool)
    return GlobalBA(
        R=jnp.asarray(R, jnp.float32), t=jnp.asarray(t, jnp.float32),
        host=host, pu=jnp.asarray(pu, jnp.float32),
        pv=jnp.asarray(pv, jnp.float32), rho=jnp.asarray(rho, jnp.float32),
        p_valid=jnp.asarray(p_valid),
        obs_p=obs_p, obs_t=jnp.asarray(obs_t, jnp.int32),
        obs_uv=jnp.asarray(obs_uv, jnp.float32),
        obs_w=jnp.asarray(obs_w, jnp.float32),
    )


def _project(Rw, tw, Xw, K):
    """World point -> pixel + depth in a w2c frame."""
    Xc = jnp.einsum("oij,oj->oi", Rw, Xw) + tw
    z = jnp.where(jnp.abs(Xc[:, 2]) < 1e-9, 1e-9, Xc[:, 2])
    u = K[0, 0] * Xc[:, 0] / z + K[0, 2]
    v = K[1, 1] * Xc[:, 1] / z + K[1, 2]
    return jnp.stack([u, v], -1), Xc


def _linearize(p: GlobalBA, K):
    """Per-observation residual (O, 2) and Jacobians wrt host pose (O,2,6),
    target pose (O,2,6) [left se3 increments on world-to-cam], and host
    inverse depth (O,2). Host-frame back-projection:
    X_h = d * Kinv [u,v,1], d = 1/rho; X_w = R_h^T (X_h - t_h)."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    h = p.host[p.obs_p]
    tg = p.obs_t
    d = 1.0 / jnp.maximum(p.rho[p.obs_p], 1e-6)          # (O,)
    xh = (p.pu[p.obs_p] - cx) / fx
    yh = (p.pv[p.obs_p] - cy) / fy
    X_h = jnp.stack([xh * d, yh * d, d], -1)             # (O, 3)
    Rh, th = p.R[h], p.t[h]
    Rt, tt = p.R[tg], p.t[tg]
    X_w = jnp.einsum("oji,oj->oi", Rh, X_h - th)
    uv, Xc = _project(Rt, tt, X_w, K)
    r = uv - p.obs_uv                                    # (O, 2)

    # d pixel / d X_c (target cam coords)
    z = jnp.where(jnp.abs(Xc[:, 2]) < 1e-9, 1e-9, Xc[:, 2])
    iz = 1.0 / z
    u_n, v_n = Xc[:, 0] * iz, Xc[:, 1] * iz
    zero = jnp.zeros_like(iz)
    Jpi = jnp.stack([
        jnp.stack([fx * iz, zero, -fx * u_n * iz], -1),
        jnp.stack([zero, fy * iz, -fy * v_n * iz], -1),
    ], -2)                                               # (O, 2, 3)

    # target pose: left increment xi on (R_t, t_t):
    # d X_c / d xi = [I | -[X_c]_x]  (trans, rot)
    Xc_hat = _hat(Xc)                                    # (O, 3, 3)
    J_t = jnp.concatenate([Jpi, -jnp.einsum("oab,obc->oac", Jpi, Xc_hat)],
                          axis=-1)                       # (O, 2, 6)

    # host pose: X_w = R_h^T (X_h - t_h);
    # d X_w / d xi_h = [-R_h^T | R_h^T [X_h]_x] => chain through R_t
    RtRhT = jnp.einsum("oab,ocb->oac", Rt, Rh)           # R_t R_h^T (O,3,3)
    dXc_dth = -RtRhT
    dXc_dphih = jnp.einsum("oab,obc->oac", RtRhT, _hat(X_h))
    J_h = jnp.concatenate([
        jnp.einsum("oab,obc->oac", Jpi, dXc_dth),
        jnp.einsum("oab,obc->oac", Jpi, dXc_dphih),
    ], axis=-1)                                          # (O, 2, 6)

    # inverse depth: X_h = bearing / rho => dX_h/drho = -X_h / rho
    rho = jnp.maximum(p.rho[p.obs_p], 1e-6)
    dXw_drho = jnp.einsum("oji,oj->oi", Rh, -X_h / rho[:, None])
    dXc_drho = jnp.einsum("oij,oj->oi", Rt, dXw_drho)
    J_rho = jnp.einsum("oab,ob->oa", Jpi, dXc_drho)      # (O, 2)
    return r, J_h, J_t, J_rho


def _hat(v):
    """(..., 3) -> (..., 3, 3) cross-product matrices."""
    z = jnp.zeros_like(v[..., 0])
    return jnp.stack([
        jnp.stack([z, -v[..., 2], v[..., 1]], -1),
        jnp.stack([v[..., 2], z, -v[..., 0]], -1),
        jnp.stack([-v[..., 1], v[..., 0], z], -1),
    ], -2)


def _huber_w(r, k):
    """IRLS weights for a Huber loss with threshold k (px)."""
    e = jnp.linalg.norm(r, axis=-1)
    return jnp.where(e <= k, 1.0, k / jnp.maximum(e, 1e-12))


def gn_step(p: GlobalBA, K, cg_iters: int = 100, huber_px: float = 3.0,
            rho_prior: float = 1.0, damping: float = 1e-4,
            outlier_px: float = 20.0,
            axis: str | None = None):
    """One Gauss-Newton step: linearize, Schur-eliminate inverse depths,
    matrix-free PCG on the reduced (N*6) camera system, back-substitute.
    Returns (new problem, chi2-before). Under `axis` the observation and
    landmark arrays are the LOCAL shard; (N,6) reductions psum over it."""
    N = p.R.shape[0]
    P_ = p.host.shape[0]

    def allsum(x):
        return jax.lax.psum(x, axis) if axis is not None else x

    r, J_h, J_t, J_rho = _linearize(p, K)
    h = p.host[p.obs_p]
    tg = p.obs_t
    valid = (p.obs_w > 0) & p.p_valid[p.obs_p]
    # Huber reweighting + a hard gate on gross outliers: Huber bounds the
    # influence of each residual but 10% of 40-px wrong associations still
    # bias the solve; the gate zeroes them outright (the global-BA analog
    # of the window BA's frameEnergyTH outlier gating,
    # OptimizationClasses.cpp:221-229)
    e = jnp.linalg.norm(r, axis=-1)
    w = jnp.where(valid & (e <= outlier_px),
                  p.obs_w * _huber_w(r, huber_px), 0.0)           # (O,)
    chi2 = allsum(jnp.sum(w * jnp.sum(r * r, -1)))

    # gauge: pin pose 0 by zeroing its Jacobian columns
    free_h = (h != 0).astype(jnp.float32)[:, None, None]
    free_t = (tg != 0).astype(jnp.float32)[:, None, None]
    J_h = J_h * free_h
    J_t = J_t * free_t

    wr = w[:, None] * r                                           # (O, 2)

    # per-point Schur scalars: Hdd = sum w |J_rho|^2 + prior, bd = sum w J_rho.r
    Hdd = jax.ops.segment_sum(
        jnp.sum(w[:, None] * J_rho * J_rho, -1), p.obs_p,
        num_segments=P_) + rho_prior
    bd = jax.ops.segment_sum(jnp.sum(J_rho * wr, -1), p.obs_p,
                             num_segments=P_)
    iHdd = 1.0 / Hdd                                              # (P,)

    # camera gradient: b_c = sum_obs J_c^T w r, scattered to (N, 6)
    def scat_c(vec_o):
        """(O, 6) contributions tagged host+target -> (N, 6), psum'd."""
        gh = jax.ops.segment_sum(vec_o[0], h, num_segments=N)
        gt = jax.ops.segment_sum(vec_o[1], tg, num_segments=N)
        return allsum(gh + gt)

    b_c = scat_c((jnp.einsum("oab,oa->ob", J_h, wr),
                  jnp.einsum("oab,oa->ob", J_t, wr)))             # (N, 6)
    # E = J_c^T w J_rho per obs (6,) — the camera-depth coupling
    E_h = jnp.einsum("oab,oa->ob", J_h, w[:, None] * J_rho)
    E_t = jnp.einsum("oab,oa->ob", J_t, w[:, None] * J_rho)
    # reduced gradient: b = b_c - E iHdd bd
    s_p = (iHdd * bd)[p.obs_p]                                    # (O,)
    b_red = b_c - scat_c((E_h * s_p[:, None], E_t * s_p[:, None]))

    # block-Jacobi preconditioner from H_cc diagonal blocks
    Ph = jnp.einsum("oab,oac->obc", J_h * w[:, None, None], J_h)
    Pt = jnp.einsum("oab,oac->obc", J_t * w[:, None, None], J_t)
    Pn = allsum(jax.ops.segment_sum(Ph, h, num_segments=N)
                + jax.ops.segment_sum(Pt, tg, num_segments=N))
    Pn = Pn + (damping + 1e-6) * jnp.eye(6)[None]
    Pn_inv = jnp.linalg.inv(Pn)                                   # (N, 6, 6)

    def Sx(x):
        """Reduced-system product S x, x (N, 6): H_cc x - E iHdd E^T x.

        Under sharding each device owns DISTINCT landmarks (a landmark's
        observations never cross shards — partition_problem guarantees
        it), so the per-point scalars (etx, iHdd) stay local with no
        collective; only the (N, 6) scatters psum."""
        xh = x[h]                                                 # (O, 6)
        xt = x[tg]
        # J_c x per obs (2,)
        Jx = (jnp.einsum("oab,ob->oa", J_h, xh)
              + jnp.einsum("oab,ob->oa", J_t, xt))
        hcc = scat_c((jnp.einsum("oab,oa->ob", J_h, w[:, None] * Jx),
                      jnp.einsum("oab,oa->ob", J_t, w[:, None] * Jx)))
        # E^T x per point: sum_obs (E_h.xh + E_t.xt)
        etx = jax.ops.segment_sum(
            jnp.sum(E_h * xh, -1) + jnp.sum(E_t * xt, -1),
            p.obs_p, num_segments=P_)
        sp = (iHdd * etx)[p.obs_p]
        schur = scat_c((E_h * sp[:, None], E_t * sp[:, None]))
        return hcc - schur + damping * x

    def psolve(v):
        return jnp.einsum("nab,nb->na", Pn_inv, v)

    # PCG on S dx = b_red
    x0 = jnp.zeros((N, 6))
    r0 = b_red
    z0 = psolve(r0)
    d0 = z0

    def cg_body(carry):
        k, x, rr, z, d, rz = carry
        Sd = Sx(d)
        alpha = rz / jnp.maximum(jnp.sum(d * Sd), 1e-20)
        x = x + alpha * d
        rr = rr - alpha * Sd
        z = psolve(rr)
        rz_new = jnp.sum(rr * z)
        beta = rz_new / jnp.maximum(rz, 1e-20)
        d = z + beta * d
        return k + 1, x, rr, z, d, rz_new

    def cg_cond(carry):
        k, x, rr, z, d, rz = carry
        return (k < cg_iters) & (jnp.sum(rr * rr) > 1e-16)

    _, dx, _, _, _, _ = jax.lax.while_loop(
        cg_cond, cg_body, (0, x0, r0, z0, d0, jnp.sum(r0 * z0)))
    dx = jnp.where(jnp.isfinite(dx), dx, 0.0)
    dx = dx.at[0].set(0.0)                               # gauge: pose 0

    # back-substitute inverse depths: d_rho = iHdd (bd - E^T dx)
    etx = jax.ops.segment_sum(
        jnp.sum(E_h * dx[h], -1) + jnp.sum(E_t * dx[tg], -1),
        p.obs_p, num_segments=P_)
    d_rho = iHdd * (bd - etx)
    d_rho = jnp.where(jnp.isfinite(d_rho) & p.p_valid, d_rho, 0.0)

    # apply: left-multiply pose increments exp(-dx) (GN solves J dx = r
    # with r = pred - meas, so the step is the negative)
    dR, dt = lie.se3_exp(-dx)
    R_new = jnp.einsum("nab,nbc->nac", dR, p.R)
    t_new = jnp.einsum("nab,nb->na", dR, p.t) + dt
    rho_new = jnp.clip(p.rho - d_rho, 1e-4, 1e4)
    rho_new = jnp.where(p.p_valid, rho_new, p.rho)
    return p._replace(R=R_new, t=t_new, rho=rho_new), chi2


def global_ba(p: GlobalBA, K, n_iters: int = 5, cg_iters: int = 100,
              huber_px: float = 3.0, rho_prior: float = 1.0,
              axis: str | None = None):
    """GN relaxation; returns (problem, chi2 history (n_iters,))."""
    K = jnp.asarray(K, jnp.float32)

    def body(p, _):
        p, chi2 = gn_step(p, K, cg_iters=cg_iters, huber_px=huber_px,
                          rho_prior=rho_prior, axis=axis)
        return p, chi2

    p, chis = jax.lax.scan(body, p, None, length=n_iters)
    return p, chis


def partition_problem(p: GlobalBA, n_shards: int) -> GlobalBA:
    """Lay the problem out for `sharded_global_ba`: equal-sized contiguous
    LANDMARK blocks (landmarks already ordered by host keyframe, so a
    block spans a contiguous keyframe range — the keyframe-block
    partition), and equal-sized observation blocks such that block s holds
    EXACTLY the observations of landmark block s. A landmark's
    observations never cross a shard boundary, so all per-point Schur
    algebra stays shard-local. Pads with invalid landmarks / zero-weight
    observations. Host-side (numpy)."""
    host = np.asarray(p.host)
    obs_p = np.asarray(p.obs_p)
    order = np.argsort(host, kind="stable")        # landmarks by host KF
    P_ = len(host)
    m = -(-P_ // n_shards)                         # landmarks per block

    def take_p(a, idx, pad, padval):
        a = np.asarray(a)[idx]
        if pad:
            padding = np.full((pad,) + a.shape[1:], padval, a.dtype)
            a = np.concatenate([a, padding])
        return a

    pad_p = m * n_shards - P_
    new_host = take_p(host, order, pad_p, 0)
    inv = np.empty(P_, np.int64)
    inv[order] = np.arange(P_)                     # old id -> new id

    # group observations by NEW landmark id, then block them
    new_obs_p = inv[obs_p]
    oorder = np.argsort(new_obs_p, kind="stable")
    blk_of_obs = new_obs_p[oorder] // m
    counts = np.bincount(blk_of_obs, minlength=n_shards)
    ob = int(counts.max()) if len(counts) else 1
    ob = max(ob, 1)
    O_new = ob * n_shards
    oidx = np.zeros(O_new, np.int64)               # indices into oorder
    ow_new = np.zeros(O_new, np.float32)
    op_new = np.zeros(O_new, np.int64)
    start = 0
    obs_w = np.asarray(p.obs_w)
    for s in range(n_shards):
        c = counts[s] if s < len(counts) else 0
        sel = oorder[start:start + c]
        start += c
        oidx[s * ob: s * ob + c] = sel
        ow_new[s * ob: s * ob + c] = obs_w[sel]
        op_new[s * ob: s * ob + c] = new_obs_p[sel]
        op_new[s * ob + c: (s + 1) * ob] = s * m   # pad -> block's first lm

    return GlobalBA(
        R=p.R, t=p.t,
        host=jnp.asarray(new_host, jnp.int32),
        pu=jnp.asarray(take_p(p.pu, order, pad_p, 0.0)),
        pv=jnp.asarray(take_p(p.pv, order, pad_p, 0.0)),
        rho=jnp.asarray(take_p(p.rho, order, pad_p, 1.0)),
        p_valid=jnp.asarray(take_p(np.asarray(p.p_valid), order, pad_p,
                                   False)),
        obs_p=jnp.asarray(op_new, jnp.int32),
        obs_t=jnp.asarray(np.asarray(p.obs_t)[oidx], jnp.int32),
        obs_uv=jnp.asarray(np.asarray(p.obs_uv)[oidx], jnp.float32),
        obs_w=jnp.asarray(ow_new),
    )


def sharded_global_ba(mesh: Mesh, p: GlobalBA, K, n_iters: int = 5,
                      cg_iters: int = 100, huber_px: float = 3.0,
                      rho_prior: float = 1.0):
    """global_ba with landmarks + observations sharded over the mesh axis
    (poses replicated; per-CG-iteration (N,6) reductions psum across devices).
    The problem MUST be laid out by `partition_problem(p, mesh.size)`
    first: equal-sized landmark blocks by host keyframe with every
    landmark's observations on its own shard."""
    ax = mesh.axis_names[0]
    spec = GlobalBA(
        R=P(), t=P(),
        host=P(ax), pu=P(ax), pv=P(ax), rho=P(ax), p_valid=P(ax),
        obs_p=P(ax), obs_t=P(ax), obs_uv=P(ax, None), obs_w=P(ax),
    )

    @partial(shard_map, mesh=mesh, in_specs=(spec, P()),
             out_specs=(spec, P()), check_vma=False)
    def run(p_l, K_l):
        # rebase global observation landmark ids to the local shard
        # (landmark blocks are equal-sized: block s = [s*n_loc, (s+1)*n_loc))
        n_loc = p_l.host.shape[0]
        shard_ix = jax.lax.axis_index(ax)
        p_l = p_l._replace(obs_p=p_l.obs_p - shard_ix * n_loc)
        out, chis = global_ba(p_l, K_l, n_iters=n_iters, cg_iters=cg_iters,
                              huber_px=huber_px, rho_prior=rho_prior,
                              axis=ax)
        out = out._replace(obs_p=out.obs_p + shard_ix * n_loc)
        return out, chis

    return run(p, jnp.asarray(K, jnp.float32))


def build_problem_from_trajectory(R_w2c, t_w2c, K, points_per_kf,
                                  obs_radius, width, height, rng,
                                  depth_fn, pix_noise=0.5):
    """Synthesize a GlobalBA problem from a keyframe trajectory: sample
    `points_per_kf` pixels per keyframe, lift them with `depth_fn(u, v, i)`
    (true scene depth in the host frame), and observe each landmark in the
    keyframes within +-obs_radius that see it. Landmarks are ordered by
    host keyframe and observations by landmark — the layout
    sharded_global_ba requires. Host-side (numpy) problem construction."""
    N = len(R_w2c)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    host, pu, pv, rho = [], [], [], []
    obs_p, obs_t, obs_uv = [], [], []
    pid = 0
    for i in range(N):
        us = rng.uniform(8, width - 8, points_per_kf)
        vs = rng.uniform(8, height - 8, points_per_kf)
        for u, v in zip(us, vs):
            d = depth_fn(u, v, i)
            X_h = np.array([(u - cx) / fx * d, (v - cy) / fy * d, d])
            X_w = R_w2c[i].T @ (X_h - t_w2c[i])
            seen = []
            for j in range(max(0, i - obs_radius),
                           min(N, i + obs_radius + 1)):
                if j == i:
                    continue
                Xc = R_w2c[j] @ X_w + t_w2c[j]
                if Xc[2] < 0.2:
                    continue
                uu = fx * Xc[0] / Xc[2] + cx
                vv = fy * Xc[1] / Xc[2] + cy
                if 2 < uu < width - 3 and 2 < vv < height - 3:
                    seen.append((j, uu + rng.normal(0, pix_noise),
                                 vv + rng.normal(0, pix_noise)))
            if len(seen) >= 2:
                host.append(i)
                pu.append(u)
                pv.append(v)
                rho.append(1.0 / d)
                for (j, uu, vv) in seen:
                    obs_p.append(pid)
                    obs_t.append(j)
                    obs_uv.append((uu, vv))
                pid += 1
    return build_problem(
        np.stack(R_w2c), np.stack(t_w2c), np.array(host), np.array(pu),
        np.array(pv), np.array(rho), np.array(obs_p), np.array(obs_t),
        np.array(obs_uv))
