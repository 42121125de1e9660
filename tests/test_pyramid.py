"""Direct pyramid (ops/pyramid.py) against a float64 numpy oracle of the
reference's CreateDirPyrs: 2x2 mean downsample, central-difference
gradients zero on the border, and |grad|^2 weighted by the squared gamma
response derivative. The sizes are those of the EuRoC, TUM-mono and KITTI
cameras at six levels, so the deep levels have odd sizes."""
import numpy as np
import pytest

from hslam_tpu.ops.pyramid import build_direct_pyramid, pyramid_shapes

LEVELS = 6


def oracle(img, n_levels, gw):
    levels, grads = [], []
    cur = img.astype(np.float64)
    for lvl in range(n_levels):
        if lvl > 0:
            h, w = cur.shape[0] // 2, cur.shape[1] // 2
            cur = cur[:2 * h, :2 * w].reshape(h, 2, w, 2).mean(axis=(1, 3))
        dx = np.zeros_like(cur)
        dy = np.zeros_like(cur)
        dx[:, 1:-1] = 0.5 * (cur[:, 2:] - cur[:, :-2])
        dy[1:-1, :] = 0.5 * (cur[2:, :] - cur[:-2, :])
        w8 = gw[np.clip(cur.astype(np.int64), 0, 255)]
        levels.append(np.stack([cur, dx, dy], -1))
        grads.append((dx * dx + dy * dy) * w8 * w8)
    return levels, grads


@pytest.mark.parametrize("height,width", [(480, 640), (480, 752), (376, 1241)])
def test_pyramid_matches_float64_oracle(height, width):
    rng = np.random.default_rng(height + width)
    # 8-bit sensor frames: every level is then exact in float32 (means of
    # 4^l integers), so only the |grad|^2 products carry rounding
    img = rng.integers(0, 256, (height, width)).astype(np.uint8)
    gw = np.linspace(0.5, 1.5, 256)
    lv, gr = build_direct_pyramid(img.astype(np.float32), LEVELS,
                                  gamma_grad_weight=gw.astype(np.float32))
    lv_o, gr_o = oracle(img, LEVELS, gw)
    shapes = pyramid_shapes(height, width, LEVELS)
    assert [tuple(a.shape[:2]) for a in lv] == shapes
    assert any(h % 2 or w % 2 for h, w in shapes[1:])
    for a, b in zip(lv, lv_o):
        np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=1e-4)
    for a, b in zip(gr, gr_o):
        np.testing.assert_allclose(np.asarray(a), b, rtol=1e-5, atol=1e-3)
