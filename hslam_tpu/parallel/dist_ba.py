"""Distributed windowed BA: point-sharded linearization with psum-reduced
camera systems.

The scaling story the reference lacks (SURVEY.md §2.8 item 6, §5): residual
linearization and Hessian accumulation are embarrassingly parallel over
points, so points shard across the device mesh; the (4+8F)^2 camera system
and the Schur terms are psum-reduced across devices, each device solves the tiny
replicated system, and idepth back-substitution stays local to the shard.
One step == one GN iteration of models/optimizer.ba_optimize.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from ..config import CPARS, Config
from ..models import window as W
from ..models.calib import Calib
from ..models.optimizer import (BAResult, _prior_vectors, _slot_mask,
                                _stitched_delta, ba_optimize,
                                marginalize_points, solve_camera_system)
from ..ops import ba


def _points_spec() -> W.Points:
    return W.Points(
        status=P("points"), host=P("points"), u=P("points"), v=P("points"),
        idepth=P("points"), idepth_zero=P("points"),
        color=P("points", None), weight=P("points", None),
        prior=P("points"), res_state=P("points", None),
        max_rel_baseline=P("points"), num_good_res=P("points"),
        idepth_hessian=P("points"),
        kp_idx=P("points"), ind_u=P("points", None), ind_v=P("points", None),
        ind_w=P("points", None), ind_valid=P("points", None),
    )


def _replicated(tree):
    return jax.tree.map(lambda _: P(), tree)


@partial(jax.jit, static_argnames=("mesh", "cfg"))
def sharded_ba_optimize(mesh: Mesh, wnd: W.Window, calib: Calib, cfg: Config,
                        n_iter) -> BAResult:
    """The FULL windowed GN optimize (models/optimizer.ba_optimize — the
    while_loop with convergence exit, sticky residual states, FEJ re-fix of
    the newest keyframe, energy thresholds, final fixing pass) under a
    point-sharded shard_map: every device linearizes and Schur-eliminates
    its point shard; the (4+8F)^2 camera system, convergence stats, and the
    energy quantile ride collectives each iteration. Frames/calib/HM/bM
    are replicated; all per-point state stays on its shard.

    Jitted, so a call outside another jit compiles one program: a
    shard_map called eagerly runs op by op and recompiles its loop bodies
    on every call. Numpy inputs are replicated on multi-process meshes."""
    wnd_spec = W.Window(frames=_replicated(wnd.frames), points=_points_spec(),
                        HM=P(), bM=P())
    out_spec = BAResult(
        window=wnd_spec, calib=_replicated(calib), rmse=P(),
        newest_proj_u=P("points"), newest_proj_v=P("points"),
        newest_proj_idepth=P("points"), newest_res_in=P("points"),
        HdiF=P("points"),
    )

    @partial(shard_map, mesh=mesh,
             in_specs=(wnd_spec, _replicated(calib), P()),
             out_specs=out_spec, check_vma=False)
    def opt(wnd_l, calib_l, n):
        return ba_optimize(wnd_l, calib_l, cfg, n, axis="points")

    return opt(wnd, calib, n_iter)


@partial(jax.jit, static_argnames=("mesh", "cfg"))
def sharded_marginalize_points(mesh: Mesh, wnd: W.Window, calib: Calib,
                               to_marg, to_drop, cfg: Config) -> W.Window:
    """marginalize_points with the flagged points' Schur-reduced blocks
    psum-folded into the replicated HM/bM."""
    wnd_spec = W.Window(frames=_replicated(wnd.frames), points=_points_spec(),
                        HM=P(), bM=P())

    @partial(shard_map, mesh=mesh,
             in_specs=(wnd_spec, _replicated(calib), P("points"),
                       P("points")),
             out_specs=wnd_spec, check_vma=False)
    def marg(wnd_l, calib_l, tm, td):
        return marginalize_points(wnd_l, calib_l, tm, td, cfg, axis="points")

    return marg(wnd, calib, to_marg, to_drop)


@partial(jax.jit, static_argnames=("mesh", "cfg"))
def sharded_ba_step(mesh: Mesh, wnd: W.Window, calib: Calib, cfg: Config):
    """Run one point-sharded GN step on `mesh` (axis name 'points').

    Returns (rmse, new frame states, idepth steps)."""
    F = cfg.max_frames

    pts_spec = _points_spec()
    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(pts_spec, jax.tree.map(lambda _: P(), wnd.frames),
                  jax.tree.map(lambda _: P(), calib), P(), P()),
        out_specs=(P(), P(), P("points")),
        check_vma=False,
    )
    def step(points, frames, calib_, HM, bM):
        lin = ba.linearize(frames, points, calib_, cfg)
        grid = (
            (points.status == W.PT_ACTIVE)[:, None]
            & frames.valid[None, :]
            & (points.host[:, None] != jnp.arange(F)[None, :])
        )
        active = grid & (lin.new_state == W.RES_IN)
        AH, AT = ba.compute_adjoints(frames)
        sys = ba.accumulate(lin, active, points.host, AH, AT, F)

        pt_active = (points.status == W.PT_ACTIVE) & (jnp.sum(active, axis=1) > 0)
        H_sc_loc, b_sc_loc, HdiF = ba.schur_complement(sys, points.prior, pt_active)

        # reduce the camera system over the point shards
        H = jax.lax.psum(sys.H, "points")
        b = jax.lax.psum(sys.b, "points")
        H_sc = jax.lax.psum(H_sc_loc, "points")
        b_sc = jax.lax.psum(b_sc_loc, "points")
        E = jax.lax.psum(jnp.sum(jnp.where(active, lin.energy, 0.0)), "points")
        n_res = jax.lax.psum(jnp.sum(active), "points")

        delta = _stitched_delta(frames, calib_)
        prior_diag, prior_b = _prior_vectors(frames, calib_, cfg)
        ns_proj = ba.nullspace_projector(ba.nullspaces(frames),
                                         cfg.solver_mode_delta)
        x = solve_camera_system(
            H, b, H_sc, b_sc, HM, bM, delta, prior_diag, prior_b,
            _slot_mask(frames), ns_proj, jnp.float32(cfg.fix_lambda),
            jnp.bool_(False), cfg,
        )
        d_step = ba.resubstitute(sys, HdiF, x)
        rmse = jnp.sqrt(E / jnp.maximum(8.0 * n_res, 1.0))
        new_state = frames.state - (x[CPARS:].reshape(F, 8) * frames.valid[:, None])
        return rmse, new_state, d_step

    return step(wnd.points, wnd.frames, calib, wnd.HM, wnd.bM)
