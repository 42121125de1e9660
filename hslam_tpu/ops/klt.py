"""Batched pyramidal Lucas-Kanade optical flow.

Batched device replacement for the reference's cv::calcOpticalFlowPyrLK use in
the two-view initializer (reference: Src/Initializer.cpp:341-398): all
features track in parallel; per level a fixed number of masked GN
iterations on a WIN x WIN patch.
"""
from __future__ import annotations

from typing import List, Tuple

import jax
import jax.numpy as jnp

WIN = 21          # window size (matches cv::calcOpticalFlowPyrLK default 21x21)
HALF = WIN // 2
MAX_ITERS = 30
EPS = 0.01


def _patch_coords(x, y):
    """(N,) centers -> (N, WIN*WIN) sample coords."""
    d = jnp.arange(WIN, dtype=jnp.float32) - HALF
    dy, dx = jnp.meshgrid(d, d, indexing="ij")
    return (
        x[:, None] + dx.reshape(-1)[None, :],
        y[:, None] + dy.reshape(-1)[None, :],
    )


def _gather(img, x, y):
    H, W = img.shape
    xc = jnp.clip(x, 0.0, W - 1.0)
    yc = jnp.clip(y, 0.0, H - 1.0)
    ix = jnp.clip(jnp.floor(xc).astype(jnp.int32), 0, W - 2)
    iy = jnp.clip(jnp.floor(yc).astype(jnp.int32), 0, H - 2)
    fx = xc - ix
    fy = yc - iy
    flat = img.reshape(-1)
    base = iy * W + ix
    return ((flat[base] * (1 - fx) + flat[base + 1] * fx) * (1 - fy)
            + (flat[base + W] * (1 - fx) + flat[base + W + 1] * fx) * fy)


def track(
    ref_pyr: List[jnp.ndarray],     # [(H_l, W_l)] intensity pyramids
    tgt_pyr: List[jnp.ndarray],
    pts: jnp.ndarray,               # (N, 2) level-0 coords in ref
    init: jnp.ndarray | None = None,  # (N, 2) initial guess in target
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Returns (tracked (N, 2), ok (N,), err (N,) mean abs residual)."""
    n_levels = len(ref_pyr)
    N = pts.shape[0]
    if init is None:
        init = pts
    # start at the coarsest level
    scale = 2.0 ** (n_levels - 1)
    cur = init / scale

    ok = jnp.ones(N, bool)
    err = jnp.zeros(N, jnp.float32)

    for lvl in range(n_levels - 1, -1, -1):
        s = 2.0 ** lvl
        ref = ref_pyr[lvl]
        tgt = tgt_pyr[lvl]
        Hl, Wl = ref.shape
        p_ref = pts / s

        rx, ry = _patch_coords(p_ref[:, 0], p_ref[:, 1])
        patch_ref = _gather(ref, rx, ry)                 # (N, WIN^2)
        # template gradients via central differences on the ref image
        gx = 0.5 * (_gather(ref, rx + 1, ry) - _gather(ref, rx - 1, ry))
        gy = 0.5 * (_gather(ref, rx, ry + 1) - _gather(ref, rx, ry - 1))
        Gxx = jnp.sum(gx * gx, axis=1)
        Gxy = jnp.sum(gx * gy, axis=1)
        Gyy = jnp.sum(gy * gy, axis=1)
        det = Gxx * Gyy - Gxy * Gxy
        invertible = det > 1e-6
        det_s = jnp.where(invertible, det, 1.0)

        def body(it, carry):
            cx, cy, done = carry
            tx, ty = _patch_coords(cx, cy)
            patch_t = _gather(tgt, tx, ty)
            r = patch_t - patch_ref
            bx = jnp.sum(r * gx, axis=1)
            by = jnp.sum(r * gy, axis=1)
            dx = -(Gyy * bx - Gxy * by) / det_s
            dy = -(-Gxy * bx + Gxx * by) / det_s
            step = jnp.where(done[:, None], 0.0, jnp.stack([dx, dy], -1))
            cx = cx + step[:, 0]
            cy = cy + step[:, 1]
            done = done | (jnp.abs(dx) + jnp.abs(dy) < EPS)
            return cx, cy, done

        cx, cy, _ = jax.lax.fori_loop(
            0, MAX_ITERS, body, (cur[:, 0], cur[:, 1], ~invertible)
        )
        ok = ok & invertible
        cur = jnp.stack([cx, cy], -1)
        if lvl > 0:
            cur = cur * 2.0
        else:
            tx, ty = _patch_coords(cx, cy)
            err = jnp.mean(jnp.abs(_gather(tgt, tx, ty) - patch_ref), axis=1)
            inb = (
                (cx > HALF) & (cy > HALF)
                & (cx < Wl - HALF - 1) & (cy < Hl - HALF - 1)
            )
            ok = ok & inb & (err < 30.0)

    return cur, ok, err
