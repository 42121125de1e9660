"""Multi-scale feature frontend: the indirect (feature) pyramid, batched.

Batched device re-design of the reference's per-frame indirect layer:

  * CV_8U 1.2x-scale "indirect" pyramid with a 19-px usable border
    (reference: Src/Frame.cpp:57-74 CreateIndPyrs, Include/CalibData.h:170-188
    pyrK per indirect level),
  * FAST detection + adaptive non-max suppression per level
    (Src/Detector.cpp:47-55 + Ssc :451-553),
  * IC-angle orientation + rBRIEF descriptors at the keypoint's octave
    (Src/Detector.cpp:70-131,133-159),
  * grid-bucketed radius queries over the keypoints
    (Frame::GetFeaturesInArea, Src/Frame.cpp:255-303).

Device formulation: the per-keypoint work is ONE dynamic-slice patch gather per
keypoint from the blurred level image; orientation moments are in-register
reductions over that patch; descriptor sampling uses rotation-QUANTIZED
static index tables (16 orientation bins, pattern offsets rounded to the
patch grid per bin) so the 512 BRIEF taps per keypoint compile to constant
gathers instead of 512 dynamic ones. Descriptors are self-consistent within
this framework (matching, BoW, loop closure), which is all the reference
behavior requires — the bin quantization (<= 11.25 deg) costs a few extra
Hamming bits of intra-match noise, absorbed by the match thresholds.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .pyramid import gaussian_blur7
from .orb import fast_score, grid_nms

# patch geometry: 32x32 gathered around each keypoint; BRIEF samples are
# clipped to radius <= 14 at pattern-generation time so every rotated tap
# stays inside the patch; the IC-angle circle (radius 15) also fits.
PATCH = 32
PATCH_C = 15            # patch-coordinate of the keypoint center
_BRIEF_R = 14.0         # max BRIEF tap radius (pre-rotation == post-rotation)
N_BINS = 16             # orientation quantization bins
N_PAIRS = 256

# keypoints need the full patch inside the image: this is the analogue
# of the reference's 19-px indirect-pyramid border (Frame.cpp:57-74)
BORDER = PATCH_C + 2


class Feats(NamedTuple):
    """Per-window-slot keypoint store (fixed capacity NF per slot)."""

    u: jnp.ndarray        # (F, NF) level-0 x
    v: jnp.ndarray        # (F, NF) level-0 y
    level: jnp.ndarray    # (F, NF) int32 octave
    score: jnp.ndarray    # (F, NF) FAST response
    desc: jnp.ndarray     # (F, NF, 8) uint32 — 256-bit rBRIEF
    valid: jnp.ndarray    # (F, NF) bool


def empty_feats(n_slots: int, capacity: int) -> Feats:
    return Feats(
        u=jnp.zeros((n_slots, capacity), jnp.float32),
        v=jnp.zeros((n_slots, capacity), jnp.float32),
        level=jnp.zeros((n_slots, capacity), jnp.int32),
        score=jnp.zeros((n_slots, capacity), jnp.float32),
        desc=jnp.zeros((n_slots, capacity, 8), jnp.uint32),
        valid=jnp.zeros((n_slots, capacity), bool),
    )


def _brief_pattern_clipped(seed: int = 42) -> np.ndarray:
    """(N_PAIRS, 4) Gaussian test pairs (sigma = patch/5, the classic BRIEF
    construction), radially clipped to _BRIEF_R so every rotation stays
    inside the 32x32 patch."""
    rng = np.random.RandomState(seed)
    sigma = 31 / 5.0
    pts = rng.randn(N_PAIRS, 4) * sigma
    for k in (0, 2):
        r = np.sqrt(pts[:, k] ** 2 + pts[:, k + 1] ** 2)
        f = np.where(r > _BRIEF_R, _BRIEF_R / np.maximum(r, 1e-9), 1.0)
        pts[:, k] *= f
        pts[:, k + 1] *= f
    return pts.astype(np.float64)


def _rotated_index_tables() -> np.ndarray:
    """(N_BINS, N_PAIRS, 2) int32 flattened-patch indices of the two taps of
    every BRIEF pair, pre-rotated per orientation bin and rounded to the
    patch grid (the batched replacement for per-keypoint rotated sampling,
    Detector.cpp computeOrbDescriptor)."""
    pat = _brief_pattern_clipped()
    out = np.zeros((N_BINS, N_PAIRS, 2), np.int32)
    for b in range(N_BINS):
        th = 2.0 * np.pi * b / N_BINS
        ca, sa = np.cos(th), np.sin(th)
        for k, off in ((0, 0), (1, 2)):
            x = pat[:, off] * ca - pat[:, off + 1] * sa
            y = pat[:, off] * sa + pat[:, off + 1] * ca
            ix = np.clip(np.round(x).astype(np.int64) + PATCH_C, 0, PATCH - 1)
            iy = np.clip(np.round(y).astype(np.int64) + PATCH_C, 0, PATCH - 1)
            out[b, :, k] = (iy * PATCH + ix).astype(np.int32)
    return out


_IDX_TABLES = _rotated_index_tables()


def _ic_masks() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Static (PATCH, PATCH) moment kernels for the radius-15 IC-angle circle
    centered at PATCH_C (Detector.cpp:133-159)."""
    d = np.arange(PATCH) - PATCH_C
    dy, dx = np.meshgrid(d, d, indexing="ij")
    mask = (dx * dx + dy * dy) <= 15 * 15
    return (
        (dx * mask).astype(np.float32),
        (dy * mask).astype(np.float32),
        mask.astype(np.float32),
    )


_MX, _MY, _MASK = _ic_masks()


def _gather_patches(img: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray):
    """One (PATCH, PATCH) dynamic-slice gather per keypoint (integer-anchored).
    Returns (K, PATCH, PATCH)."""
    H, W = img.shape
    y0 = jnp.clip(jnp.round(v).astype(jnp.int32) - PATCH_C, 0, H - PATCH)
    x0 = jnp.clip(jnp.round(u).astype(jnp.int32) - PATCH_C, 0, W - PATCH)

    def slice_one(y, x):
        return jax.lax.dynamic_slice(img, (y, x), (PATCH, PATCH))

    return jax.vmap(slice_one)(y0, x0)


def describe(img_blur: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray):
    """Orientation + rBRIEF for keypoints at integer-ish (u, v) on the
    blurred image. Returns (desc (K, 8) uint32, angle (K,))."""
    patches = _gather_patches(img_blur, u, v)            # (K, 32, 32)
    m10 = jnp.sum(patches * jnp.asarray(_MX)[None], axis=(1, 2))
    m01 = jnp.sum(patches * jnp.asarray(_MY)[None], axis=(1, 2))
    angle = jnp.arctan2(m01, m10)
    bin_ = jnp.mod(
        jnp.round(angle * (N_BINS / (2.0 * np.pi))).astype(jnp.int32), N_BINS
    )                                                     # (K,)

    flat = patches.reshape(patches.shape[0], PATCH * PATCH)
    idx = jnp.asarray(_IDX_TABLES.reshape(-1))            # (16*256*2,) static
    taps = jnp.take(flat, idx, axis=1).reshape(-1, N_BINS, N_PAIRS, 2)
    bits_all = taps[..., 0] < taps[..., 1]                # (K, 16, 256)
    bits = jnp.take_along_axis(
        bits_all, bin_[:, None, None], axis=1
    )[:, 0, :].astype(jnp.uint32)                         # (K, 256)
    w32 = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, None, :]
    desc = jnp.sum(bits.reshape(-1, 8, 32) * w32, axis=-1, dtype=jnp.uint32)
    return desc, angle


def _level_capacities(capacity: int, n_levels: int, scale: float):
    """Static per-level keypoint budget proportional to level area, summing
    exactly to `capacity` (the reference distributes nFeatures the same way
    over its 1.2x pyramid)."""
    inv = np.array([scale ** (-2.0 * l) for l in range(n_levels)])
    raw = capacity * inv / inv.sum()
    caps = np.floor(raw).astype(int)
    caps[0] += capacity - caps.sum()
    return [int(c) for c in caps]


def extract_multiscale(
    img: jnp.ndarray,         # (H, W) level-0 intensity
    n_levels: int,
    capacity: int,
    fast_th: float,
    scale: float = 1.2,
    nms_cell: int = 8,
    do_subpix: bool = False,
    use_fast_only: bool = False,
    min_grad: float = 7.0,
):
    """Multi-scale FAST + oriented rBRIEF over a 1.2x feature pyramid
    (Frame::CreateIndPyrs + FeatureDetector::ExtractFeatures). Returns
    (u, v, level, score, desc, valid) with fixed capacity; coordinates in
    level-0 pixels. `do_subpix` enables cornerSubPix-style refinement of
    the keypoint locations (Detector.cpp:77-86).

    `use_fast_only=False` (the reference DEFAULT, UseFAST=false:
    Detector.cpp:56-67 converts PixelSelector gradient samples into the
    keypoint set) unions the FAST response with a gradient-magnitude score
    on cells where FAST fires nothing: low-corner scenes — smooth texture,
    man-made gradients — still yield a full descriptor set, exactly like
    the reference's gradient-sampled keypoints. FAST corners keep priority
    in their cells (their scores ride on top). `min_grad` is the minimum
    gradient magnitude for a gradient-selected keypoint
    (PixelSelector's histogram-threshold add, Settings min_grad_hist_add)."""
    H, W = img.shape
    caps = _level_capacities(capacity, n_levels, scale)

    us, vs, lvls, scs, descs, vals = [], [], [], [], [], []
    lvl_img = img
    for l in range(n_levels):
        if l > 0:
            hl = max(int(round(H / scale ** l)), PATCH + 2)
            wl = max(int(round(W / scale ** l)), PATCH + 2)
            lvl_img = jax.image.resize(img, (hl, wl), method="bilinear")
        hl, wl = lvl_img.shape
        score = fast_score(lvl_img, fast_th)
        if not use_fast_only:
            dx = 0.5 * (jnp.roll(lvl_img, -1, 1) - jnp.roll(lvl_img, 1, 1))
            dy = 0.5 * (jnp.roll(lvl_img, -1, 0) - jnp.roll(lvl_img, 1, 0))
            g2 = dx * dx + dy * dy
            grad_sc = jnp.where(g2 > min_grad * min_grad, g2, 0.0)
            # FAST corners outrank every gradient pick: corner scores are
            # lifted above the gradient cap, gradient scores keep their
            # relative order below it
            score = jnp.where(score > 0.0, score + 1e4,
                              jnp.minimum(grad_sc, 9.9e3))
        # exclude the descriptor border (the 19-px indirect-pyramid border
        # semantics, Frame.cpp:57-74)
        score = score.at[:BORDER, :].set(0.0).at[-BORDER:, :].set(0.0)
        score = score.at[:, :BORDER].set(0.0).at[:, -BORDER:].set(0.0)
        u, v, valid = grid_nms(score, nms_cell, caps[l])
        if do_subpix:
            u, v = subpix_refine(lvl_img, u, v)
        desc, _ = describe(gaussian_blur7(lvl_img), u, v)
        f = scale ** l
        us.append(u * f)
        vs.append(v * f)
        lvls.append(jnp.full(caps[l], l, jnp.int32))
        si = jnp.clip(v.astype(jnp.int32), 0, hl - 1)
        sj = jnp.clip(u.astype(jnp.int32), 0, wl - 1)
        scs.append(score[si, sj])
        descs.append(desc)
        vals.append(valid)

    return (
        jnp.concatenate(us), jnp.concatenate(vs), jnp.concatenate(lvls),
        jnp.concatenate(scs), jnp.concatenate(descs), jnp.concatenate(vals),
    )


def subpix_refine(img: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray,
                  iters: int = 5) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched gradient-based corner refinement: the cv::cornerSubPix
    (window 1x1 => 3x3 neighborhood) call of the reference
    (Src/Detector.cpp:77-86, off by default via DoSubPix, Settings.cpp:21).

    Each iteration solves sum_q [g g^T] c = sum_q [g g^T] q over a 3x3
    window of bilinear-sampled gradients around the current estimate —
    one (K, 2, 2) batched solve per iteration, no data-dependent control
    flow. Divergent corners (singular structure tensor or >1.5 px total
    drift) fall back to their integer location."""
    from ..utils.interp import bilinear

    H, W = img.shape
    dx = jnp.zeros_like(img).at[:, 1:-1].set(
        0.5 * (img[:, 2:] - img[:, :-2]))
    dy = jnp.zeros_like(img).at[1:-1, :].set(
        0.5 * (img[2:, :] - img[:-2, :]))
    d = jnp.arange(-1.0, 2.0)
    oy, ox = jnp.meshgrid(d, d, indexing="ij")
    ox = ox.reshape(-1)
    oy = oy.reshape(-1)

    def body(_, c):
        qx = c[:, 0:1] + ox[None, :]
        qy = c[:, 1:2] + oy[None, :]
        gx = bilinear(dx, qx, qy)
        gy = bilinear(dy, qx, qy)
        a = jnp.sum(gx * gx, -1)
        b = jnp.sum(gx * gy, -1)
        cc = jnp.sum(gy * gy, -1)
        bx = jnp.sum(gx * gx * qx + gx * gy * qy, -1)
        by = jnp.sum(gx * gy * qx + gy * gy * qy, -1)
        det = a * cc - b * b
        ok = det > 1e-8
        det = jnp.where(ok, det, 1.0)
        nx = (cc * bx - b * by) / det
        ny = (a * by - b * bx) / det
        new = jnp.stack([nx, ny], -1)
        return jnp.where(ok[:, None], new, c)

    c0 = jnp.stack([u, v], -1)
    c = jax.lax.fori_loop(0, iters, body, c0)
    drift2 = jnp.sum((c - c0) ** 2, -1)
    good = (drift2 <= 1.5 ** 2) & jnp.all(jnp.isfinite(c), -1)
    c = jnp.where(good[:, None], c, c0)
    cu = jnp.clip(c[:, 0], 1.0, W - 2.0)
    cv_ = jnp.clip(c[:, 1], 1.0, H - 2.0)
    return cu, cv_


# ---------------------------------------------------------------------------
# queries + matching
# ---------------------------------------------------------------------------


def features_in_area(
    f_u: jnp.ndarray, f_v: jnp.ndarray, f_valid: jnp.ndarray,
    f_level: jnp.ndarray,
    u: jnp.ndarray, v: jnp.ndarray, radius: float,
    min_level: int = -1, max_level: int = 10_000,
) -> jnp.ndarray:
    """GetFeaturesInArea (Frame.cpp:255-303) as a batched masked query:
    (Q, NF) bool — True where keypoint j is within `radius` of query i and
    inside the level band. The reference's 10-px cell grid is an O(1) CPU
    shortcut; on the device the dense (Q, NF) mask IS the efficient form
    (one elementwise pass, no data-dependent control flow)."""
    d2 = ((u[:, None] - f_u[None, :]) ** 2
          + (v[:, None] - f_v[None, :]) ** 2)
    lv_ok = (f_level >= min_level) & (f_level <= max_level)
    return (d2 <= radius * radius) & f_valid[None, :] & lv_ok[None, :]


def match_pair(desc_a, valid_a, desc_b, valid_b,
               max_dist: int = 64, ratio: float = 0.8):
    """Mutual NN + Lowe ratio Hamming matching (GlobalTypes.h:431-471
    popcount distance + the standard two-way check). Returns
    (idx_b (Na,), ok (Na,))."""
    x = jnp.bitwise_xor(desc_a[:, None, :], desc_b[None, :, :])
    D = jnp.sum(jnp.bitwise_count(x).astype(jnp.int32), axis=-1)
    BIG = 10_000
    D = jnp.where(valid_b[None, :], D, BIG)
    D = jnp.where(valid_a[:, None], D, BIG)
    best = jnp.argmin(D, axis=1)
    d1 = jnp.min(D, axis=1)
    D2 = D.at[jnp.arange(D.shape[0]), best].set(BIG)
    d2 = jnp.min(D2, axis=1)
    back = jnp.argmin(D, axis=0)
    mutual = back[best] == jnp.arange(D.shape[0])
    ok = (d1 <= max_dist) & (d1 <= ratio * d2) & mutual & valid_a
    return best, ok


# shared jitted entry: the relocalization path calls this on its FIRST
# tracking failure — a lazily-compiled matcher there would stall the
# latency-critical recovery path for a full compile (warmed up front by
# SLAMSystem's background precompile thread)
match_pair_jit = jax.jit(match_pair)
