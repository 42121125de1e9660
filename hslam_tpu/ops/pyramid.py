"""Image pyramid construction for the direct (photometric) pipeline.

Device equivalent of the reference's per-frame pyramid build
(reference: Src/Frame.cpp:104-181 `CreateDirPyrs`): per level, the image is
2x2-average downsampled, then per-pixel central-difference gradients (dx, dy)
and the gradient-magnitude map `absSquaredGrad` are computed, the latter
optionally re-weighted by the photometric response derivative
(Frame.cpp:158-164 via `getBGradOnly`).

Plain jnp: XLA fuses each level's passes itself. A hand-written fused
level kernel (Pallas, Triton route) was measured on the H100 and was not
faster end to end inside track_step, so there is none.

Static shapes: levels are a Python-level list (each level has a different
shape, which XLA requires to be static anyway).
"""
from __future__ import annotations

from typing import List, Tuple

import jax.numpy as jnp


def downsample2(img: jnp.ndarray) -> jnp.ndarray:
    """2x2 average pooling, matching the reference's 4-pixel mean
    (Frame.cpp: DirPyr[lvl] from DirPyr[lvl-1]). Odd trailing row/col are
    dropped (reference uses w>>1, h>>1)."""
    H, W = img.shape
    H2, W2 = H // 2, W // 2
    img = img[: H2 * 2, : W2 * 2]
    return img.reshape(H2, 2, W2, 2).mean(axis=(1, 3))


def image_gradients(img: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Central-difference gradients 0.5*(I[x+1]-I[x-1]), zero on the border —
    matches reference Frame.cpp gradient loop (it indexes idx-1/idx+1 and
    skips the outermost pixels)."""
    dx = jnp.zeros_like(img)
    dy = jnp.zeros_like(img)
    dx = dx.at[:, 1:-1].set(0.5 * (img[:, 2:] - img[:, :-2]))
    dy = dy.at[1:-1, :].set(0.5 * (img[2:, :] - img[:-2, :]))
    return dx, dy


def build_direct_pyramid(
    image: jnp.ndarray,
    n_levels: int,
    gamma_grad_weight: jnp.ndarray | None = None,
) -> Tuple[List[jnp.ndarray], List[jnp.ndarray]]:
    """Build the direct pyramid.

    Args:
      image: (H, W) float32 photometrically-corrected intensities (0..255).
      n_levels: number of pyramid levels.
      gamma_grad_weight: optional (256,) per-intensity weight from the
        photometric response derivative; absSquaredGrad is scaled by
        w[I]^2 as in Frame.cpp:158-164.

    Returns:
      (pyr, abs_grad2):
        pyr: list of (H_l, W_l, 3) arrays [I, dx, dy] per level.
        abs_grad2: list of (H_l, W_l) squared-gradient-magnitude maps.
    """
    levels = []
    grads = []
    img = image
    for lvl in range(n_levels):
        if lvl > 0:
            img = downsample2(img)
        dx, dy = image_gradients(img)
        g2 = dx * dx + dy * dy
        if gamma_grad_weight is not None:
            idx = jnp.clip(img.astype(jnp.int32), 0, 255)
            gw = gamma_grad_weight[idx]
            g2 = g2 * gw * gw
        levels.append(jnp.stack([img, dx, dy], axis=-1))
        grads.append(g2)
    return levels, grads


def pyramid_shapes(h: int, w: int, n_levels: int) -> List[Tuple[int, int]]:
    shapes = []
    for _ in range(n_levels):
        shapes.append((h, w))
        h, w = h // 2, w // 2
    return shapes


def gaussian_blur3(img: jnp.ndarray) -> jnp.ndarray:
    """Separable 3-tap [1,2,1]/4 blur (used by the indirect pyramid before
    descriptor extraction; reference uses cv::GaussianBlur 7x7 sigma 2 —
    we approximate with iterated small kernels at the call site)."""
    k = jnp.array([0.25, 0.5, 0.25], dtype=img.dtype)
    padded = jnp.pad(img, ((1, 1), (0, 0)), mode="edge")
    img = padded[:-2] * k[0] + padded[1:-1] * k[1] + padded[2:] * k[2]
    padded = jnp.pad(img, ((0, 0), (1, 1)), mode="edge")
    return padded[:, :-2] * k[0] + padded[:, 1:-1] * k[1] + padded[:, 2:] * k[2]


def gaussian_blur7(img: jnp.ndarray) -> jnp.ndarray:
    """7x7 sigma=2 separable Gaussian, matching cv::GaussianBlur(7,7,2,2)
    used before rBRIEF sampling (reference: Src/Detector.cpp)."""
    # OpenCV's getGaussianKernel(7, 2) values:
    k = jnp.array(
        [0.070766, 0.131305, 0.190776, 0.214305, 0.190776, 0.131305, 0.070766],
        dtype=img.dtype,
    )
    k = k / jnp.sum(k)
    padded = jnp.pad(img, ((3, 3), (0, 0)), mode="edge")
    out = jnp.zeros_like(img)
    for i in range(7):
        out = out + padded[i : i + img.shape[0]] * k[i]
    padded = jnp.pad(out, ((0, 0), (3, 3)), mode="edge")
    out2 = jnp.zeros_like(img)
    for i in range(7):
        out2 = out2 + padded[:, i : i + img.shape[1]] * k[i]
    return out2
