"""Fixed-capacity slot allocation for masked SoA state.

The reference mutates pointer lists (push_back / erase); with static device
shapes, insert/delete become mask flips plus this helper: pair the j-th
valid candidate with the j-th free slot, in index order.
"""
from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp


def assign_free_slots(free_mask: jnp.ndarray, cand_mask: jnp.ndarray
                      ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """free_mask: (S,) bool — slots available for writing.
    cand_mask: (C,) bool — candidates wanting a slot.

    Returns (slots (C,), write (C,)): for each candidate, a target slot
    index and whether the write should happen (candidate valid AND enough
    free slots). Candidates are packed in index order."""
    S = free_mask.shape[0]
    C = cand_mask.shape[0]
    # order of free slots (stable): free slots first, by index
    slot_order = jnp.argsort(~free_mask, stable=True)        # (S,)
    n_free = jnp.sum(free_mask)
    # rank of each valid candidate among valid candidates
    rank = jnp.cumsum(cand_mask.astype(jnp.int32)) - 1        # (C,)
    fits = cand_mask & (rank < n_free) & (rank < S)
    slots = slot_order[jnp.clip(rank, 0, S - 1)]
    return slots, fits


def scatter_update(arr: jnp.ndarray, slots: jnp.ndarray, write: jnp.ndarray,
                   values: jnp.ndarray) -> jnp.ndarray:
    """Write values[j] into arr[slots[j]] where write[j]. Non-written slots
    keep their contents (uses a guard index trick: masked writes target
    their own slot with the old value)."""
    old = arr[slots]
    if values.ndim > 1 or arr.ndim > 1:
        w = write.reshape(write.shape + (1,) * (values.ndim - 1))
        vals = jnp.where(w, values, old)
    else:
        vals = jnp.where(write, values, old)
    return arr.at[slots].set(vals)
