"""Batched bilinear sampling on image planes.

Device-side replacement for the reference's pointer-walking interpolation
kernels (reference: Include/GlobalTypes.h:355-401 —
getInterpolatedElement33/31/33BiLin). Images are dense arrays; sample sites
are float coordinate batches, gathered and lerped in one vectorized op.

Convention: images are (H, W) or (H, W, C); x = column (u), y = row (v),
pixel centers at integer coordinates — identical to the reference.
Out-of-bounds coordinates are clamped; callers carry validity masks.
"""
from __future__ import annotations

import jax.numpy as jnp


def bilinear(img, x, y):
    """Sample img (H, W) or (H, W, C) at float coords x, y (any batch shape).

    Returns samples with shape batch (+ (C,) if img has channels).
    Matches reference getInterpolatedElement31/33 weighting:
      w = [(1-dx)(1-dy), dx(1-dy), (1-dx)dy, dx dy] on the 2x2 neighborhood.
    """
    H, W = img.shape[0], img.shape[1]
    x = jnp.clip(x, 0.0, W - 1.0)
    y = jnp.clip(y, 0.0, H - 1.0)
    # clamp the cell index so the edge samples stay exact (dx, dy reach 1.0)
    ix = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, W - 2)
    iy = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, H - 2)
    dx = (x - ix.astype(x.dtype))
    dy = (y - iy.astype(y.dtype))

    flat = img.reshape((H * W,) + img.shape[2:])
    base = iy * W + ix
    p00 = flat[base]
    p01 = flat[base + 1]
    p10 = flat[base + W]
    p11 = flat[base + W + 1]

    if img.ndim == 3:
        dx = dx[..., None]
        dy = dy[..., None]
    top = p00 * (1.0 - dx) + p01 * dx
    bot = p10 * (1.0 - dx) + p11 * dx
    return top * (1.0 - dy) + bot * dy


def bilinear_with_grad(img, x, y):
    """Sample intensity and its image gradient like the reference's
    getInterpolatedElement33BiLin (GlobalTypes.h:355-375): returns
    (value, gx, gy) where gx/gy are bilinear finite differences of the 2x2
    cell — NOT samples of a precomputed gradient image.

    img: (H, W) single channel. Returns three arrays with batch shape.
    """
    H, W = img.shape
    x = jnp.clip(x, 0.0, W - 1.0)
    y = jnp.clip(y, 0.0, H - 1.0)
    ix = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, W - 2)
    iy = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, H - 2)
    dx = x - ix.astype(x.dtype)
    dy = y - iy.astype(y.dtype)

    flat = img.reshape(H * W)
    base = iy * W + ix
    tl = flat[base]
    tr = flat[base + 1]
    bl = flat[base + W]
    br = flat[base + W + 1]

    top = dx * tr + (1.0 - dx) * tl
    bot = dx * br + (1.0 - dx) * bl
    left = dy * bl + (1.0 - dy) * tl
    right = dy * br + (1.0 - dy) * tr
    val = dx * right + (1.0 - dx) * left
    return val, right - left, bot - top


def pack_cells(img: jnp.ndarray) -> jnp.ndarray:
    """Pack each pixel's 2x2 interpolation cell into channels:
    (H, W) -> (H, W, 4) = [I(y,x), I(y,x+1), I(y+1,x), I(y+1,x+1)].

    Bilinear sampling then needs ONE row gather instead of four — gathers
    cost per row fetched, so this cuts the gather rows of gather-heavy
    kernels (epipolar search, tracker warp) by 4x. Last row/col duplicate their
    neighbors (samples are clamped to W-2/H-2 anyway)."""
    r = jnp.concatenate([img[:, 1:], img[:, -1:]], axis=1)
    d = jnp.concatenate([img[1:, :], img[-1:, :]], axis=0)
    rd = jnp.concatenate([r[1:, :], r[-1:, :]], axis=0)
    return jnp.stack([img, r, d, rd], axis=-1)


def bilinear_packed(packed: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray):
    """Sample a pack_cells() image with one gather per sample."""
    H, W = packed.shape[0], packed.shape[1]
    xc = jnp.clip(x, 0.0, W - 1.0)
    yc = jnp.clip(y, 0.0, H - 1.0)
    ix = jnp.clip(jnp.floor(xc).astype(jnp.int32), 0, W - 2)
    iy = jnp.clip(jnp.floor(yc).astype(jnp.int32), 0, H - 2)
    dx = xc - ix
    dy = yc - iy
    cells = packed.reshape(H * W, 4)[iy * W + ix]      # (..., 4)
    top = cells[..., 0] * (1 - dx) + cells[..., 1] * dx
    bot = cells[..., 2] * (1 - dx) + cells[..., 3] * dx
    return top * (1 - dy) + bot * dy


def in_bounds(x, y, width, height, border: float = 1.1, margin: float = 3.0):
    """Validity predicate matching the reference projectPoint bounds
    (Include/DirectProjection.h:17,37): border < u < W - margin."""
    return (x > border) & (y > border) & (x < width - margin) & (y < height - margin)
