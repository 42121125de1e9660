"""Gradient-based candidate pixel selection.

Batched device re-design of DSO's PixelSelector
(reference: Src/PixelSelector.cpp): the per-32x32-block gradient histogram
threshold (makeHists, :54-117) becomes a one-hot bincount + cumsum
quantile; the 3-tier nested scan (select, :271-414) becomes hierarchical
masked block-argmax reductions:

  * level 0: per pot-block best pixel with grad > th, scored by the
    projection onto a per-block pseudo-random direction;
  * level 1: per 2pot-block, only where no level-0 pick exists inside,
    best pixel passing the down-weighted level-1 gradient threshold;
  * level 2: per 4pot-block likewise with the level-2 gradient map.

The scan-order quirks of the reference inner loop (partial accumulation
before the first level-0 hit) are intentionally not reproduced; the clean
block semantics is what the algorithm means.

`pot` (the block size) is a static argument — the density-adaptation
recursion (makeMaps, :118-267) runs at the host level across a handful of
cached pot values.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import Config


def _pad_to(x, H, W, value=0.0):
    return jnp.pad(
        x, ((0, H - x.shape[0]), (0, W - x.shape[1])), constant_values=value
    )


def block_thresholds(abs_grad0: jnp.ndarray, cfg: Config) -> jnp.ndarray:
    """Per-32x32-block smoothed squared threshold (makeHists).

    abs_grad0: (H, W) squared-gradient map at level 0.
    Returns thsSmoothed: (ceil(H/32), ceil(W/32)).
    """
    H, W = abs_grad0.shape
    h32, w32 = H // 32, W // 32
    g = jnp.sqrt(jnp.maximum(abs_grad0, 0.0))
    g = jnp.clip(g, 0.0, 48.0).astype(jnp.int32)

    ys = jnp.arange(H)[:, None]
    xs = jnp.arange(W)[None, :]
    valid = (xs >= 1) & (xs <= W - 2) & (ys >= 1) & (ys <= H - 2)
    # histogram over 49 bins per block
    gb = g[: h32 * 32, : w32 * 32].reshape(h32, 32, w32, 32)
    vb = valid[: h32 * 32, : w32 * 32].reshape(h32, 32, w32, 32)
    onehot = jax.nn.one_hot(gb, 49, dtype=jnp.float32) * vb[..., None]
    hist = onehot.sum(axis=(1, 3))                      # (h32, w32, 49)
    total = hist.sum(-1)

    # computeHistQuantil: smallest g with cumsum > cut * total
    csum = jnp.cumsum(hist, axis=-1)
    cut = cfg.min_grad_hist_cut * total
    below = csum < cut[..., None]
    quant = jnp.sum(below.astype(jnp.int32), axis=-1).astype(jnp.float32)
    ths = quant + cfg.min_grad_hist_add                 # (h32, w32)

    # 3x3 box smooth with border-aware normalization
    padded = jnp.pad(ths, 1, mode="constant")
    cnt = jnp.pad(jnp.ones_like(ths), 1, mode="constant")
    ssum = jnp.zeros_like(ths)
    snum = jnp.zeros_like(ths)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ssum = ssum + padded[1 + dy : 1 + dy + h32, 1 + dx : 1 + dx + w32]
            snum = snum + cnt[1 + dy : 1 + dy + h32, 1 + dx : 1 + dx + w32]
    sm = ssum / snum
    return sm * sm


_DIRECTIONS = jnp.array(
    [
        [0, 1.0000], [0.3827, 0.9239], [0.1951, 0.9808], [0.9239, 0.3827],
        [0.7071, 0.7071], [0.3827, -0.9239], [0.8315, 0.5556], [0.8315, -0.5556],
        [0.5556, -0.8315], [0.9808, 0.1951], [0.9239, -0.3827], [0.7071, -0.7071],
        [0.5556, 0.8315], [0.9808, -0.1951], [1.0000, 0.0000], [0.1951, -0.9808],
    ],
    dtype=jnp.float32,
)


def _block_best(score: jnp.ndarray, blk: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Blockwise max + flat argmax index. score: (H, W) padded to multiples
    of blk; masked-out entries must be -inf."""
    H, W = score.shape
    hb, wb = H // blk, W // blk
    s = score.reshape(hb, blk, wb, blk).transpose(0, 2, 1, 3).reshape(hb, wb, blk * blk)
    best = jnp.max(s, axis=-1)
    arg = jnp.argmax(s, axis=-1)
    by, bx = arg // blk, arg % blk
    ys = jnp.arange(hb)[:, None] * blk + by
    xs = jnp.arange(wb)[None, :] * blk + bx
    return best, ys * W + xs


def select_pixels(
    dir_img0: jnp.ndarray,       # (H, W, 3) level-0 [I, dx, dy]
    abs_grad: Tuple[jnp.ndarray, ...],  # squared-grad maps, levels 0..2
    pot: int,
    th_factor: float,
    seed: jnp.ndarray,
    cfg: Config,
) -> jnp.ndarray:
    """Returns a dense status map (H, W) int32 in {0, 1, 2, 4}."""
    H, W = abs_grad[0].shape
    blk4 = 4 * pot
    Hp = ((H + blk4 - 1) // blk4) * blk4
    Wp = ((W + blk4 - 1) // blk4) * blk4

    ths = block_thresholds(abs_grad[0], cfg)            # (h32, w32)
    ys = jnp.arange(H)[:, None]
    xs = jnp.arange(W)[None, :]

    def _up(a, f):
        """Nearest-neighbor upsample by integer factor f, cropped/edge-
        padded to (H, W). Equivalent to the gather a[y//f, x//f] but lowers
        to broadcast+reshape instead of a 300k-element gather (three
        full-image gathers per call)."""
        u = jnp.repeat(jnp.repeat(a, f, axis=0), f, axis=1)
        ph, pw = max(0, H - u.shape[0]), max(0, W - u.shape[1])
        if ph or pw:
            u = jnp.pad(u, ((0, ph), (0, pw)), mode="edge")
        return u[:H, :W]

    th0 = _up(ths, 32)
    dw1 = cfg.grad_downweight_per_level
    dw2 = dw1 * dw1

    border = (xs >= 4) & (xs < W - 5) & (ys >= 4) & (ys < H - 4)

    ag0 = abs_grad[0]
    # level-1/2 gradient sampled at the reference's coordinates
    # (PixelSelector.cpp:371,385: (int)(xf*0.5+0.25), (int)(xf*0.25+0.125)
    # — both floor to y//2 / y//4 exactly, i.e. nearest-neighbor upsample)
    ag1 = _up(abs_grad[1], 2)
    ag2 = _up(abs_grad[2], 4)

    pass0 = (ag0 > th0 * th_factor) & border
    pass1 = (ag1 > th0 * dw1 * th_factor) & border
    pass2 = (ag2 > th0 * dw2 * th_factor) & border

    grad = dir_img0[..., 1:3]                           # (H, W, 2)

    # per-block pseudo-random directions, seeded deterministically
    def block_dirs(nby, nbx, salt):
        k = jax.random.fold_in(jax.random.PRNGKey(0), salt)
        k = jax.random.fold_in(k, seed)
        idx = jax.random.randint(k, (nby, nbx), 0, 16)
        return _DIRECTIONS[idx]                         # (nby, nbx, 2)

    def dir_score(blk, salt, mask):
        nby, nbx = Hp // blk, Wp // blk
        d = block_dirs(nby, nbx, salt)
        dfull = jnp.repeat(jnp.repeat(d, blk, axis=0), blk, axis=1)[:H, :W]
        if cfg.select_direction_distribution:
            s = jnp.abs(jnp.sum(grad * dfull, axis=-1))
        else:
            s = ag0
        s = jnp.where(mask, s, -jnp.inf)
        return _pad_to(s, Hp, Wp, -jnp.inf)

    # level 0: best per pot-block
    s0 = dir_score(pot, 0, pass0)
    best0, idx0 = _block_best(s0, pot)                  # (Hp/pot, Wp/pot)
    sel0 = best0 > -jnp.inf

    # level 1: per 2pot block, only if no level-0 selection inside
    s1 = dir_score(2 * pot, 1, pass1)
    best1, idx1 = _block_best(s1, 2 * pot)
    h0, w0 = sel0.shape
    sel0_2 = sel0.reshape(h0 // 2, 2, w0 // 2, 2).any(axis=(1, 3))
    sel1 = (best1 > -jnp.inf) & ~sel0_2

    # level 2: per 4pot block, only if nothing found inside
    s2 = dir_score(4 * pot, 2, pass2)
    best2, idx2 = _block_best(s2, 4 * pot)
    sel01_4 = (
        sel0.reshape(h0 // 4, 4, w0 // 4, 4).any(axis=(1, 3))
        | sel1.reshape(h0 // 4, 2, w0 // 4, 2).any(axis=(1, 3))
    )
    sel2 = (best2 > -jnp.inf) & ~sel01_4

    status = jnp.zeros(Hp * Wp, jnp.int32)
    status = status.at[idx0.reshape(-1)].max(jnp.where(sel0.reshape(-1), 1, 0))
    status = status.at[idx1.reshape(-1)].max(jnp.where(sel1.reshape(-1), 2, 0))
    status = status.at[idx2.reshape(-1)].max(jnp.where(sel2.reshape(-1), 4, 0))
    status = status.reshape(Hp, Wp)[:H, :W]
    return status


def compact_selection(
    status: jnp.ndarray,        # (H, W) int32 selection map
    abs_grad0: jnp.ndarray,     # (H, W) score for ranking
    capacity: int,
    want: jnp.ndarray,          # () desired number (for random subsample)
    seed: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Convert the dense map to a fixed-capacity point list.

    Returns (u, v, type, valid) each (capacity,). If more than `want`
    pixels are selected, a random subset of ~want survives (the reference
    deletes randomly, PixelSelector.cpp:148-176)."""
    H, W = status.shape
    flat_status = status.reshape(-1)
    n_sel = jnp.sum(flat_status > 0)
    keep_prob = jnp.minimum(1.0, want.astype(jnp.float32) / jnp.maximum(n_sel, 1))
    key = jax.random.fold_in(jax.random.PRNGKey(17), seed)
    rand = jax.random.uniform(key, flat_status.shape)
    keep = (flat_status > 0) & (rand < keep_prob)

    score = jnp.where(keep, abs_grad0.reshape(-1), -jnp.inf)
    top = jax.lax.top_k(score, capacity)
    idx = top[1]
    valid = top[0] > -jnp.inf
    u = (idx % W).astype(jnp.float32)
    v = (idx // W).astype(jnp.float32)
    ptype = flat_status[idx]
    return u, v, ptype, valid
