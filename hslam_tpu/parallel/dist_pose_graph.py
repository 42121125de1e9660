"""Edge-sharded Sim(3) pose-graph relaxation.

Multi-chip path for KITTI-length loop-closure graphs (north-star config
#5): the PCG solver in models/pose_graph.py does all its O(E) work in
per-edge Jacobian blocks and segment-sums, so edges partition across the
device mesh; each device keeps the full replicated (N, 7) node vectors
(tiny — 280 KB at 10k keyframes) and psums its partial gradient /
preconditioner / H·x contributions across devices. The reference's g2o pose
graph (Thirdparty/g2o, declared capability — SURVEY.md §0) is
single-threaded sparse Cholesky; this is the same math re-laid-out so a
multi-chip mesh splits the edge set.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from ..models.pose_graph import PoseGraph, optimize_pose_graph_pcg


def pad_edges(pg: PoseGraph, multiple: int) -> PoseGraph:
    """Pad the edge set to a multiple of the mesh size with zero-weight
    self-edges on node 0 (identity measurement): their residual is zero,
    their Jacobian is scaled by sqrt(weight)=0, and their segment-sum
    contributions vanish — pure shape padding."""
    E = pg.edge_i.shape[0]
    pad = (-E) % multiple
    if pad == 0:
        return pg
    I3 = jnp.broadcast_to(jnp.eye(3, dtype=pg.meas_R.dtype), (pad, 3, 3))
    return pg._replace(
        edge_i=jnp.concatenate([pg.edge_i, jnp.zeros(pad, jnp.int32)]),
        edge_j=jnp.concatenate([pg.edge_j, jnp.zeros(pad, jnp.int32)]),
        meas_s=jnp.concatenate([pg.meas_s, jnp.ones(pad, pg.meas_s.dtype)]),
        meas_R=jnp.concatenate([pg.meas_R, I3]),
        meas_t=jnp.concatenate([pg.meas_t,
                                jnp.zeros((pad, 3), pg.meas_t.dtype)]),
        weight=jnp.concatenate([pg.weight, jnp.zeros(pad, pg.weight.dtype)]),
    )


@partial(jax.jit, static_argnames=("mesh", "n_iters", "cg_iters",
                                   "fix_scale"))
def sharded_optimize_pose_graph_pcg(mesh: Mesh, pg: PoseGraph,
                                    n_iters: int = 10, cg_iters: int = 150,
                                    cg_tol: float = 1e-8, lam: float = 1e-6,
                                    fix_scale: bool = False):
    """optimize_pose_graph_pcg with the edge arrays sharded over the mesh
    axis "edges" and every edge reduction psum'd. Node states stay
    replicated; returns replicated (s, R, t) identical (up to psum
    summation order) to the single-device solver. Jitted for the reason
    given at dist_ba.sharded_ba_optimize."""
    axis = mesh.axis_names[0]
    pg = pad_edges(pg, mesh.size)

    node_spec = P()
    edge_spec = P(axis)
    in_spec = PoseGraph(
        s=node_spec, R=node_spec, t=node_spec, valid=node_spec,
        edge_i=edge_spec, edge_j=edge_spec,
        meas_s=edge_spec, meas_R=edge_spec, meas_t=edge_spec,
        weight=edge_spec,
    )

    @partial(shard_map, mesh=mesh, in_specs=(in_spec,),
             out_specs=(P(), P(), P()), check_vma=False)
    def opt(pg_l):
        return optimize_pose_graph_pcg(
            pg_l, n_iters=n_iters, cg_iters=cg_iters, cg_tol=cg_tol,
            lam=lam, fix_scale=fix_scale, axis=axis)

    return opt(pg)
