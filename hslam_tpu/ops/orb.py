"""ORB-style feature detection and binary descriptors, batched.

Batched device re-design of the reference FeatureDetector
(reference: Src/Detector.cpp): FAST corner response as a dense map (16
shifted-image comparisons + contiguous-arc test instead of per-pixel
branching), IC_Angle orientation by intensity centroid (:133-159), rBRIEF
descriptors on the blurred image (:91-131), grid non-max suppression in
place of the SSC binary search (:451-553), and Hamming matching via XOR +
popcount (GlobalTypes.h:431-471's SSE popcount becomes
jnp.bitwise_count).

The 256 descriptor test pairs are generated from a fixed-seed Gaussian
(sigma = patch/5, the classic BRIEF construction) rather than copying
OpenCV's learned table — descriptors are self-consistent within this
framework (matching + our own BoW vocabulary), which is all the reference
behavior requires.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# ---------------------------------------------------------------------------
# FAST-9,16 dense corner response
# ---------------------------------------------------------------------------

_CIRCLE = np.array(
    [(0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
     (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3)],
    dtype=np.int32,
)


def fast_score(img: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """Dense FAST-9,16 response. Returns (H, W) score map; 0 = not a corner.
    Score = sum of |I_circle - I_center| over the qualifying arc pixels
    (a standard ranking score; cv::FAST's exact score differs slightly but
    is only used for NMS ordering)."""
    H, W = img.shape
    shifted = []
    for dx, dy in _CIRCLE:
        shifted.append(jnp.roll(img, (-dy, -dx), axis=(0, 1)))
    circ = jnp.stack(shifted)                      # (16, H, W)
    diff = circ - img[None]
    brighter = diff > threshold
    darker = diff < -threshold

    def has_arc9(mask):
        m = jnp.concatenate([mask, mask[:8]], axis=0)    # (24, H, W)
        run = m[0:16]
        for k in range(1, 9):
            run = run & m[k : k + 16]
        return jnp.any(run, axis=0)

    is_corner = has_arc9(brighter) | has_arc9(darker)
    mag = jnp.sum(jnp.where(brighter | darker, jnp.abs(diff), 0.0), axis=0)
    score = jnp.where(is_corner, mag, 0.0)
    # zero the border where the circle wraps
    score = score.at[:3, :].set(0.0).at[-3:, :].set(0.0)
    score = score.at[:, :3].set(0.0).at[:, -3:].set(0.0)
    return score


def grid_nms(score: jnp.ndarray, cell: int, capacity: int,
             min_score: float = 1e-6) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Per-cell argmax + global top-k — the batched replacement for SSC's
    adaptive binary-search suppression (Detector.cpp:451-553): uniform
    spatial coverage with bounded output, branch-free.

    Returns (u, v, valid) of up to `capacity` keypoints."""
    H, W = score.shape
    Hp = (H + cell - 1) // cell * cell
    Wp = (W + cell - 1) // cell * cell
    s = jnp.pad(score, ((0, Hp - H), (0, Wp - W)), constant_values=0.0)
    hb, wb = Hp // cell, Wp // cell
    blocks = s.reshape(hb, cell, wb, cell).transpose(0, 2, 1, 3).reshape(hb, wb, -1)
    best = jnp.max(blocks, axis=-1)
    arg = jnp.argmax(blocks, axis=-1)
    by, bx = arg // cell, arg % cell
    ys = (jnp.arange(hb)[:, None] * cell + by).reshape(-1)
    xs = (jnp.arange(wb)[None, :] * cell + bx).reshape(-1)
    vals = best.reshape(-1)
    k = min(capacity, vals.shape[0])
    top_vals, top_idx = jax.lax.top_k(vals, k)
    u = xs[top_idx].astype(jnp.float32)
    v = ys[top_idx].astype(jnp.float32)
    valid = top_vals > min_score
    if k < capacity:
        pad = capacity - k
        u = jnp.concatenate([u, jnp.zeros(pad)])
        v = jnp.concatenate([v, jnp.zeros(pad)])
        valid = jnp.concatenate([valid, jnp.zeros(pad, bool)])
    return u, v, valid


# ---------------------------------------------------------------------------
# orientation + descriptors
# ---------------------------------------------------------------------------

_PATCH_R = 15  # IC_Angle HALF_PATCH_SIZE (Detector.cpp:133-159)


def _circular_umax() -> np.ndarray:
    """Per-row half-width of the radius-15 circular patch."""
    umax = np.zeros(_PATCH_R + 1, np.int32)
    for v in range(_PATCH_R + 1):
        umax[v] = int(np.sqrt(max(_PATCH_R * _PATCH_R - v * v, 0)) + 0.5)
    return umax


_UMAX = _circular_umax()


def ic_angle(img: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Intensity-centroid orientation, batched. Returns angle radians (N,)."""
    H, W = img.shape
    d = jnp.arange(-_PATCH_R, _PATCH_R + 1)
    dy, dx = jnp.meshgrid(d, d, indexing="ij")          # (31, 31)
    mask = (dx * dx + dy * dy) <= _PATCH_R * _PATCH_R
    ui = jnp.clip(jnp.round(u).astype(jnp.int32), _PATCH_R, W - _PATCH_R - 1)
    vi = jnp.clip(jnp.round(v).astype(jnp.int32), _PATCH_R, H - _PATCH_R - 1)
    ys = vi[:, None, None] + dy[None]
    xs = ui[:, None, None] + dx[None]
    flat = img.reshape(-1)
    vals = flat[(ys * W + xs).reshape(u.shape[0], -1)].reshape(ys.shape)
    vals = vals * mask[None]
    m10 = jnp.sum(vals * dx[None], axis=(1, 2))
    m01 = jnp.sum(vals * dy[None], axis=(1, 2))
    return jnp.arctan2(m01, m10)


def _brief_pattern(n_pairs: int = 256, patch: int = 31, seed: int = 42) -> np.ndarray:
    """(n_pairs, 4) [x1, y1, x2, y2] Gaussian test pairs, sigma = patch/5."""
    rng = np.random.RandomState(seed)
    sigma = patch / 5.0
    lim = patch // 2 - 1
    pts = np.clip(rng.randn(n_pairs, 4) * sigma, -lim, lim)
    return pts.astype(np.float32)


_PATTERN256 = _brief_pattern()


def rbrief(img_blur: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray,
           angle: jnp.ndarray) -> jnp.ndarray:
    """Rotated BRIEF descriptors. Returns (N, 8) uint32 (256 bits)."""
    H, W = img_blur.shape
    pat = jnp.asarray(_PATTERN256)                       # (256, 4)
    ca = jnp.cos(angle)[:, None]
    sa = jnp.sin(angle)[:, None]

    def rot(x, y):
        return ca * x[None] - sa * y[None] + u[:, None], \
               sa * x[None] + ca * y[None] + v[:, None]

    x1, y1 = rot(pat[:, 0], pat[:, 1])                   # (N, 256)
    x2, y2 = rot(pat[:, 2], pat[:, 3])

    def sample(x, y):
        xc = jnp.clip(x, 0.0, W - 1.0)
        yc = jnp.clip(y, 0.0, H - 1.0)
        ix = jnp.clip(jnp.floor(xc).astype(jnp.int32), 0, W - 2)
        iy = jnp.clip(jnp.floor(yc).astype(jnp.int32), 0, H - 2)
        fx = xc - ix
        fy = yc - iy
        flat = img_blur.reshape(-1)
        base = iy * W + ix
        return ((flat[base] * (1 - fx) + flat[base + 1] * fx) * (1 - fy)
                + (flat[base + W] * (1 - fx) + flat[base + W + 1] * fx) * fy)

    bits = (sample(x1, y1) < sample(x2, y2)).astype(jnp.uint32)  # (N, 256)
    bits = bits.reshape(-1, 8, 32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, None, :]
    return jnp.sum(bits * weights, axis=-1, dtype=jnp.uint32)     # (N, 8)


def hamming_matrix(da: jnp.ndarray, db: jnp.ndarray) -> jnp.ndarray:
    """(Na, 8) x (Nb, 8) uint32 -> (Na, Nb) int32 Hamming distances."""
    x = jnp.bitwise_xor(da[:, None, :], db[None, :, :])
    return jnp.sum(jnp.bitwise_count(x).astype(jnp.int32), axis=-1)


def match_descriptors(da: jnp.ndarray, db: jnp.ndarray,
                      max_dist: int = 50, ratio: float = 0.9,
                      valid_a=None, valid_b=None):
    """Mutual nearest-neighbor matching with Lowe ratio test.

    Returns (idx_b (Na,), ok (Na,))."""
    D = hamming_matrix(da, db)
    if valid_b is not None:
        D = jnp.where(valid_b[None, :], D, 10_000)
    best = jnp.argmin(D, axis=1)
    dist1 = jnp.min(D, axis=1)
    D2 = D.at[jnp.arange(D.shape[0]), best].set(10_000)
    dist2 = jnp.min(D2, axis=1)
    back = jnp.argmin(D, axis=0)
    mutual = back[best] == jnp.arange(D.shape[0])
    ok = (dist1 <= max_dist) & (dist1 <= ratio * dist2) & mutual
    if valid_a is not None:
        ok = ok & valid_a
    return best, ok


# shared jitted entry for the loop-closure / relocalization paths (warmed
# by SLAMSystem's background precompile thread so the first failure or
# loop candidate never pays a compile)
match_descriptors_jit = jax.jit(match_descriptors)
