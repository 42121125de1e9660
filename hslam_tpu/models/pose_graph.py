"""Sim(3) / SE(3) pose-graph optimization.

Capability equivalent of the reference's vendored-but-unused g2o pose graph
(reference: Thirdparty/g2o, linked at CMakeLists.txt:38,111 — loop closure
and pose-graph relaxation are declared capabilities with no active code,
SURVEY.md §0). Design is batched and device-first:

  * states: (N, 7) sim3 tangent coordinates of world-to-keyframe poses,
    updated by left-multiplied increments;
  * edges: (E,) index pairs with sim3 measurements (relative constraints);
  * residuals r_e = log_sim3( S_meas_e^-1 * S_i * S_j^-1 ) evaluated
    batched; Jacobians by jax.jacfwd of the batched residual closure
    (dense autodiff — exact, compiled once);
  * Gauss-Newton with diagonal damping; dense solve for windows up to
    ~1000 keyframes (7N x 7N), gauge fixed by pinning the first keyframe.

For scale-drift-correcting monocular loop closure (Strasdat-style), edges
are Sim3; with fix_scale=True the sigma component is pinned to zero and
the same machinery does SE3 relaxation.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils import lie


# per-GN-iteration cap on each node's sim3 tangent step norm (trust
# region): real corrections move nodes by far less per iteration; an
# inconsistent edge otherwise explodes through exp()
MAX_NODE_STEP = 1.0


class PoseGraph(NamedTuple):
    # states: world-to-kf sim3 as (s (N,), R (N,3,3), t (N,3))
    s: jnp.ndarray
    R: jnp.ndarray
    t: jnp.ndarray
    valid: jnp.ndarray        # (N,)
    # edges
    edge_i: jnp.ndarray       # (E,) int32
    edge_j: jnp.ndarray       # (E,)
    meas_s: jnp.ndarray       # (E,) measured S_ij = S_i * S_j^-1
    meas_R: jnp.ndarray       # (E, 3, 3)
    meas_t: jnp.ndarray       # (E, 3)
    weight: jnp.ndarray       # (E,) edge weights


def residuals(pg: PoseGraph, delta: jnp.ndarray) -> jnp.ndarray:
    """(E, 7) residuals at states perturbed by delta (N, 7):
    S_i' = exp(delta_i) * S_i."""
    ds, dR, dt = lie.sim3_exp(delta)
    s = pg.s * ds
    R = dR @ pg.R
    t = ds[:, None] * jnp.einsum("nij,nj->ni", dR, pg.t) + dt

    si, Ri, ti = s[pg.edge_i], R[pg.edge_i], t[pg.edge_i]
    sj, Rj, tj = s[pg.edge_j], R[pg.edge_j], t[pg.edge_j]
    sji, Rji, tji = lie.sim3_inverse(sj, Rj, tj)
    s_ij, R_ij, t_ij = lie.sim3_mul(si, Ri, ti, sji, Rji, tji)
    # error = meas^-1 * S_ij
    sm, Rm, tm = lie.sim3_inverse(pg.meas_s, pg.meas_R, pg.meas_t)
    se, Re, te = lie.sim3_mul(sm, Rm, tm, s_ij, R_ij, t_ij)
    return lie.sim3_log(se, Re, te)


@partial(jax.jit, static_argnames=("n_iters", "fix_scale"))
def optimize_pose_graph(pg: PoseGraph, n_iters: int = 10,
                        lam: float = 1e-6, fix_scale: bool = False):
    """Batched GN with autodiff Jacobians. Returns updated (s, R, t)."""
    N = pg.s.shape[0]

    def gn_step(pg: PoseGraph):
        delta0 = jnp.zeros((N, 7))

        def res_flat(delta):
            r = residuals(pg, delta)
            return (r * jnp.sqrt(pg.weight)[:, None]).reshape(-1)

        r0 = res_flat(delta0)
        J = jax.jacfwd(res_flat)(delta0).reshape(-1, N * 7)   # (7E, 7N)

        # gauge: pin keyframe 0 (all 7 dims); invalid nodes pinned too
        pin = jnp.zeros(N, bool).at[0].set(True) | ~pg.valid
        mask = jnp.repeat(~pin, 7).astype(jnp.float32)
        if fix_scale:
            scale_dims = (jnp.arange(N * 7) % 7) == 6
            mask = mask * (1.0 - scale_dims.astype(jnp.float32))
        J = J * mask[None, :]

        H = J.T @ J
        b = J.T @ r0
        H = H + jnp.diag(jnp.maximum(jnp.diag(H) * lam, 1e-8) + (1.0 - mask))
        dx = -jnp.linalg.solve(H, b)
        dx = (dx * mask).reshape(N, 7)
        # trust region: bound each node's tangent step — an inconsistent
        # (wrong-match) loop edge otherwise drives exp() of huge sim3
        # tangents into overflow and the next iteration into NaN
        nrm = jnp.linalg.norm(dx, axis=1, keepdims=True)
        dx = dx * jnp.minimum(1.0, MAX_NODE_STEP / jnp.maximum(nrm, 1e-12))

        ds, dR, dt = lie.sim3_exp(dx)
        s_new = pg.s * ds
        R_new = dR @ pg.R
        t_new = ds[:, None] * jnp.einsum("nij,nj->ni", dR, pg.t) + dt
        return pg._replace(s=s_new, R=R_new, t=t_new)

    def body(_, pg):
        return gn_step(pg)

    pg = jax.lax.fori_loop(0, n_iters, body, pg)
    return pg.s, pg.R, pg.t


# ---------------------------------------------------------------------------
# sparse / matrix-free path (KITTI-length graphs, north-star config #5)
# ---------------------------------------------------------------------------


def _edge_residual(delta_ij: jnp.ndarray, edge) -> jnp.ndarray:
    """(7,) residual of ONE edge as a function of its two incident node
    perturbations delta_ij = [delta_i (7) | delta_j (7)] — the closure that
    vmapped-jacfwd turns into per-edge (7, 14) Jacobian blocks."""
    si, Ri, ti, sj, Rj, tj, ms, mR, mt = edge
    di = delta_ij[None, :7]
    dj = delta_ij[None, 7:]
    dsi, dRi, dti = lie.sim3_exp(di)
    dsj, dRj, dtj = lie.sim3_exp(dj)
    s_i = si * dsi[0]
    R_i = dRi[0] @ Ri
    t_i = dsi[0] * (dRi[0] @ ti) + dti[0]
    s_j = sj * dsj[0]
    R_j = dRj[0] @ Rj
    t_j = dsj[0] * (dRj[0] @ tj) + dtj[0]
    sji, Rji, tji = lie.sim3_inverse(s_j[None], R_j[None], t_j[None])
    s_ij, R_ij, t_ij = lie.sim3_mul(
        s_i[None], R_i[None], t_i[None], sji, Rji, tji)
    sm, Rm, tm = lie.sim3_inverse(ms[None], mR[None], mt[None])
    se, Re, te = lie.sim3_mul(sm, Rm, tm, s_ij, R_ij, t_ij)
    return lie.sim3_log(se, Re, te)[0]


@partial(jax.jit, static_argnames=("n_iters", "cg_iters", "fix_scale", "axis"))
def optimize_pose_graph_pcg(pg: PoseGraph, n_iters: int = 10,
                            cg_iters: int = 150, cg_tol: float = 1e-8,
                            lam: float = 1e-6, fix_scale: bool = False,
                            axis: str | None = None):
    """Sparse pose-graph GN: never materializes J or H.

    Per GN iteration: per-edge (7, 14) Jacobian blocks (vmapped jacfwd of
    `_edge_residual`), then preconditioned CG on the normal equations with
    H·x evaluated as two einsums + two segment-sums over edges (O(E) work
    and memory) and a block-Jacobi preconditioner (per-node 7x7 = sum of
    incident JᵀJ blocks, batched inverse). Replaces the dense (7N)² solve
    of `optimize_pose_graph` for KITTI-length graphs (10k+ keyframes).

    `axis`: mesh axis name when the edge arrays are a per-device shard
    inside a shard_map (parallel/dist_pose_graph.py) — node states are
    replicated and every edge reduction (gradient scatter, preconditioner,
    H·x) is psum'd over the axis so each device holds the full node
    vectors while owning only its edge partition.
    """
    N = pg.s.shape[0]
    E = pg.edge_i.shape[0]
    I7 = jnp.eye(7)

    def allsum(x):
        return jax.lax.psum(x, axis) if axis is not None else x

    pin = jnp.zeros(N, bool).at[0].set(True) | ~pg.valid
    dim_ok = jnp.ones(7)
    if fix_scale:
        dim_ok = dim_ok.at[6].set(0.0)
    node_mask = jnp.where(pin[:, None], 0.0, 1.0) * dim_ok[None, :]  # (N, 7)

    def gn_step(pg: PoseGraph):
        edges = (pg.s[pg.edge_i], pg.R[pg.edge_i], pg.t[pg.edge_i],
                 pg.s[pg.edge_j], pg.R[pg.edge_j], pg.t[pg.edge_j],
                 pg.meas_s, pg.meas_R, pg.meas_t)
        sw = jnp.sqrt(pg.weight)
        r0 = residuals(pg, jnp.zeros((N, 7))) * sw[:, None]       # (E, 7)
        Jblk = jax.vmap(jax.jacfwd(_edge_residual), in_axes=(0, 0))(
            jnp.zeros((E, 14)), edges) * sw[:, None, None]        # (E, 7, 14)
        Ji, Jj = Jblk[..., :7], Jblk[..., 7:]

        def scat(y):
            """Jᵀ y accumulated into nodes: (E, 7) -> (N, 7)."""
            gi = jnp.einsum("eab,ea->eb", Ji, y)
            gj = jnp.einsum("eab,ea->eb", Jj, y)
            return allsum(jax.ops.segment_sum(gi, pg.edge_i, num_segments=N)
                          + jax.ops.segment_sum(gj, pg.edge_j, num_segments=N))

        b = scat(r0) * node_mask                                   # (N, 7)

        # block-Jacobi preconditioner + GN damping (per-node 7x7)
        Pi = jnp.einsum("eab,eac->ebc", Ji, Ji)
        Pj = jnp.einsum("eab,eac->ebc", Jj, Jj)
        Pn = allsum(jax.ops.segment_sum(Pi, pg.edge_i, num_segments=N)
                    + jax.ops.segment_sum(Pj, pg.edge_j, num_segments=N))
        dH = jnp.diagonal(Pn, axis1=1, axis2=2)                    # (N, 7)
        damp = jnp.maximum(dH * lam, 1e-8)
        # pinned dims get identity rows so the batched inverse stays sane
        mm = node_mask[:, :, None] * node_mask[:, None, :]
        Pn = Pn * mm + I7[None] * jnp.where(node_mask[:, :, None] > 0,
                                            damp[..., None] * I7[None],
                                            I7[None])
        P_inv = jnp.linalg.inv(Pn)

        def Hx(x):
            xm = x * node_mask
            y = (jnp.einsum("eab,eb->ea", Ji, xm[pg.edge_i])
                 + jnp.einsum("eab,eb->ea", Jj, xm[pg.edge_j]))
            return scat(y) * node_mask + damp * xm + x * (1 - node_mask)

        def psolve(v):
            return jnp.einsum("nab,nb->na", P_inv, v)

        # PCG for H dx = -b
        x0 = jnp.zeros((N, 7))
        r = -b - Hx(x0)
        z = psolve(r)
        p = z
        rz = jnp.sum(r * z)

        def cg_body(carry):
            x, r, p, rz, k = carry
            hp = Hx(p)
            alpha = rz / jnp.maximum(jnp.sum(p * hp), 1e-30)
            x = x + alpha * p
            r = r - alpha * hp
            z = psolve(r)
            rz_new = jnp.sum(r * z)
            p = z + (rz_new / jnp.maximum(rz, 1e-30)) * p
            return x, r, p, rz_new, k + 1

        def cg_cond(carry):
            _, r, _, _, k = carry
            return (k < cg_iters) & (jnp.sum(r * r) > cg_tol)

        dx, _, _, _, _ = jax.lax.while_loop(
            cg_cond, cg_body, (x0, r, p, rz, jnp.int32(0)))
        dx = dx * node_mask
        # trust region (see dense path): bound per-node tangent steps
        nrm = jnp.linalg.norm(dx, axis=1, keepdims=True)
        dx = dx * jnp.minimum(1.0, MAX_NODE_STEP / jnp.maximum(nrm, 1e-12))

        ds, dR, dt = lie.sim3_exp(dx)
        return pg._replace(
            s=pg.s * ds,
            R=dR @ pg.R,
            t=ds[:, None] * jnp.einsum("nij,nj->ni", dR, pg.t) + dt,
        )

    pg = jax.lax.fori_loop(0, n_iters, lambda _, g: gn_step(g), pg)
    return pg.s, pg.R, pg.t


def pad_graph(pg: PoseGraph, n_nodes: int, n_edges: int) -> PoseGraph:
    """Pad a graph to fixed bucket sizes so the jitted solvers compile a
    bounded (~log2 N) set of executables over a whole run instead of one
    per keyframe count. Padded nodes are identity poses marked invalid
    (both solvers pin invalid nodes); padded edges are weight-0 identity
    self-loops on node 0 (zero residual AND zero Jacobian rows, so they
    contribute nothing to b, H, or the preconditioner)."""
    N = pg.s.shape[0]
    E = pg.edge_i.shape[0]
    if n_nodes < N or n_edges < E:
        raise ValueError(f"pad_graph: buckets ({n_nodes},{n_edges}) smaller "
                         f"than graph ({N},{E})")
    dn = n_nodes - N
    de = n_edges - E
    if dn == 0 and de == 0:
        return pg
    eye = jnp.broadcast_to(jnp.eye(3), (dn, 3, 3))
    eye_e = jnp.broadcast_to(jnp.eye(3), (de, 3, 3))
    return PoseGraph(
        s=jnp.concatenate([pg.s, jnp.ones(dn)]),
        R=jnp.concatenate([pg.R, eye]),
        t=jnp.concatenate([pg.t, jnp.zeros((dn, 3))]),
        valid=jnp.concatenate([pg.valid, jnp.zeros(dn, bool)]),
        edge_i=jnp.concatenate([pg.edge_i, jnp.zeros(de, jnp.int32)]),
        edge_j=jnp.concatenate([pg.edge_j, jnp.zeros(de, jnp.int32)]),
        meas_s=jnp.concatenate([pg.meas_s, jnp.ones(de)]),
        meas_R=jnp.concatenate([pg.meas_R, eye_e]),
        meas_t=jnp.concatenate([pg.meas_t, jnp.zeros((de, 3))]),
        weight=jnp.concatenate([pg.weight, jnp.zeros(de)]),
    )


def bucket_size(n: int, lo: int = 32) -> int:
    """Smallest power-of-two bucket >= n (minimum `lo`)."""
    b = lo
    while b < n:
        b *= 2
    return b


def make_graph(s, R, t, valid, edge_i, edge_j, meas, weight=None) -> PoseGraph:
    """meas: tuple (s (E,), R (E,3,3), t (E,3)) of measured S_i * S_j^-1."""
    E = edge_i.shape[0]
    if weight is None:
        weight = jnp.ones(E)
    return PoseGraph(
        s=jnp.asarray(s), R=jnp.asarray(R), t=jnp.asarray(t),
        valid=jnp.asarray(valid),
        edge_i=jnp.asarray(edge_i, jnp.int32),
        edge_j=jnp.asarray(edge_j, jnp.int32),
        meas_s=jnp.asarray(meas[0]), meas_R=jnp.asarray(meas[1]),
        meas_t=jnp.asarray(meas[2]), weight=jnp.asarray(weight),
    )
