"""Long-sequence drift test: 500 frames of a slow
lissajous sweep over the textured plane with mild exposure flicker.

Exercises, in one run: the mode-1 linearized-residual FEJ chain over ~85
keyframe insertions/marginalizations, the hybrid indirect layer, the live
loop-closure pipeline (BoW detect + PnP + significance/consistency gates
— on this near-drift-free planar scene the gates correctly REJECT
sub-noise-floor corrections: round-4 measurement showed micro-corrections
turning ATE 0.07 into 0.38), and the affine brightness model (flicker).
Pure-odometry reference ATE: 0.069 at scene depth 2.0; silent
FEJ/marginalization drift bugs — the error class a short run cannot
see — blow well past the bound.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from hslam_tpu.config import Config
from hslam_tpu.utils import lie
from tests.test_system import FX, FY, CX, CY, H, W, make_texture, render


@pytest.mark.slow
def test_500_frame_drift_bounded():
    from hslam_tpu.models.system import SLAMSystem
    from hslam_tpu.io.trajectory import ate_rmse

    cfg = Config(
        max_frames=6, max_points=512, max_immature=512, max_features=512,
        pyr_levels=3, init_min_matches=50, init_ransac_iters=100,
        desired_point_density=400.0, desired_immature_density=300.0,
        tracker_iters_per_level=(6, 10, 10),
    )
    slam = SLAMSystem(FX, FY, CX, CY, W, H, cfg)
    I0 = make_texture()

    gt_all, est_all = [], []
    for i in range(500):
        t = i / 10.0
        xi = jnp.array(
            [0.45 * np.sin(0.23 * t), 0.3 * np.sin(0.31 * t + 1.0),
             0.12 * np.sin(0.17 * t),
             0.03 * np.sin(0.19 * t), 0.04 * np.sin(0.13 * t + 0.4),
             0.02 * np.sin(0.29 * t)])
        R, tt = lie.se3_exp(xi)
        img = render(I0, R, tt)
        gain = 1.0 + 0.1 * np.sin(0.9 * i)      # unmodeled exposure flicker
        slam.process_frame(np.clip(img * gain, 0, 255), t)
        assert not slam.is_lost, f"lost at frame {i}"
        Tcw = np.eye(4)
        Tcw[:3, :3], Tcw[:3, 3] = np.asarray(R), np.asarray(tt)
        gt_all.append(np.linalg.inv(Tcw))
        est_all.append(slam.shells[-1].cam_to_world.copy())

    assert slam.initialized
    assert slam.next_kf_id > 50            # real marginalization churn
    # the loop-closure pipeline must have RUN (database populated, detect
    # exercised every keyframe) even when the gates reject corrections
    assert slam.loop_closer is not None
    assert len(slam.loop_closer.entries) > 50
    err = ate_rmse(np.array([g[:3, 3] for g in gt_all]),
                   np.array([e[:3, 3] for e in est_all]))
    # calibrated: 0.155 on a clean run (depth 2.0); gate at 1.3x calibrated
    # (a 2x gate would hide regressions smaller than 2x) — FEJ drift bugs
    # blow far past either bound
    assert np.isfinite(err) and err < 0.20, f"long-run drift ATE {err}"
