"""Half-resolution distance map for spatially-spread point activation.

Batched device reformulation of CoarseDistanceMap
(reference: Src/CoarseTracker.cpp:698-901): the reference runs a
40-iteration alternating 4/8-neighborhood BFS (`growDistBFS`, :765-859);
here the same distance field is produced by 40 iterated masked min-pool
steps (a chamfer relaxation) — dense, branch-free, identical result for
the alternating-neighborhood metric.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

MAX_DIST = 1000.0


def distance_map(seed_u: jnp.ndarray, seed_v: jnp.ndarray,
                 seed_valid: jnp.ndarray, height: int, width: int,
                 iterations: int = 40) -> jnp.ndarray:
    """seeds: half-resolution pixel coords of projected active points.
    Returns (height, width) float32 distances (capped by iteration count)."""
    ui = jnp.clip(jnp.round(seed_u).astype(jnp.int32), 0, width - 1)
    vi = jnp.clip(jnp.round(seed_v).astype(jnp.int32), 0, height - 1)
    flat = jnp.full(height * width, MAX_DIST, jnp.float32)
    idx = vi * width + ui
    flat = flat.at[idx].min(jnp.where(seed_valid, 0.0, MAX_DIST))
    dist = flat.reshape(height, width)

    n4 = [(0, 1), (0, -1), (1, 0), (-1, 0)]
    n8 = n4 + [(1, 1), (1, -1), (-1, 1), (-1, -1)]

    def step(i, d):
        # alternate 4- and 8-neighborhoods like growDistBFS (:765-859)
        def relax(d, shifts):
            out = d
            for dy, dx in shifts:
                shifted = jnp.roll(d, (dy, dx), axis=(0, 1))
                # mask the wrap-around at the borders
                if dy > 0:
                    shifted = shifted.at[:dy, :].set(MAX_DIST)
                elif dy < 0:
                    shifted = shifted.at[dy:, :].set(MAX_DIST)
                if dx > 0:
                    shifted = shifted.at[:, :dx].set(MAX_DIST)
                elif dx < 0:
                    shifted = shifted.at[:, dx:].set(MAX_DIST)
                out = jnp.minimum(out, shifted + 1.0)
            return out

        return jax.lax.cond(
            i % 2 == 0, lambda d: relax(d, n4), lambda d: relax(d, n8), d
        )

    return jax.lax.fori_loop(0, iterations, step, dist)
