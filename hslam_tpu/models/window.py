"""Sliding-window state: the central pytree of the backend.

Re-design of the reference's pointer-graph backend state
(FrameShell/Frame/FrameOptimizationData Include/Frame.h:75-275,
MapPoint/MapPointOptimizationData Include/MapPoint.h, EnergyFunctional
frames/points/residual lists) as fixed-capacity struct-of-arrays with
validity masks — insert/delete become mask flips, so every BA step compiles
once and runs with static shapes on the device.

Conventions (matching the reference):
  * Frame state `state` is in SOLVER units; natural units =
    FRAME_STATE_SCALE * state, ordered [trans(3), rot(3), a, b]
    (Frame.h:185-199 setState/setStateScaled).
  * worldToCam = se3_exp(natural_xi) * evalPT (left-multiplied delta,
    Frame.h:192).
  * `state_zero` has zero pose part by construction (Frame.h:151 assert).
  * Points are hosted in a frame slot; idepth in the host frame, pattern
    colors/weights sampled at creation (MapPoint.h:92-115).
  * The dense residual grid (P, F) replaces per-point residual lists — the
    reference adds a residual for every active point x frame anyway
    (Mapping.cpp:41-57). res_state: 0=IN, 1=OOB, 2=OUT (GlobalTypes.h:97).
  * HM/bM: the marginalization prior over the full fixed-capacity absolute
    state [calib(4), frames(F * 8)] in solver units (EnergyFunctional.h:67).
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..config import CPARS, FRAME_STATE_SCALE, Config

RES_IN = 0
RES_OOB = 1
RES_OUT = 2

PT_EMPTY = 0
PT_ACTIVE = 1


class Frames(NamedTuple):
    valid: jnp.ndarray        # (F,) bool
    evalpt_R: jnp.ndarray     # (F, 3, 3) worldToCam FEJ rotation
    evalpt_t: jnp.ndarray     # (F, 3)
    state: jnp.ndarray        # (F, 8) solver-unit delta [t, r, a, b]
    state_zero: jnp.ndarray   # (F, 8) linearization point (pose part == 0)
    exposure: jnp.ndarray     # (F,)
    energy_th: jnp.ndarray    # (F,) adaptive frameEnergyTH
    prior: jnp.ndarray        # (F, 8) diagonal prior (solver units)
    kf_id: jnp.ndarray        # (F,) int32; -1 for empty slots
    images: jnp.ndarray       # (F, H, W, 3) level-0 direct image [I, dx, dy]


class Points(NamedTuple):
    status: jnp.ndarray       # (P,) int32: PT_EMPTY / PT_ACTIVE
    host: jnp.ndarray         # (P,) int32 frame slot
    u: jnp.ndarray            # (P,) level-0 coords in host
    v: jnp.ndarray
    idepth: jnp.ndarray       # (P,) current inverse depth (host frame)
    idepth_zero: jnp.ndarray  # (P,) FEJ inverse depth
    color: jnp.ndarray        # (P, 8) host pattern intensities
    weight: jnp.ndarray       # (P, 8) host pattern gradient weights
    prior: jnp.ndarray        # (P,) idepth prior hessian (solver units)
    res_state: jnp.ndarray    # (P, F) int32 residual state machine
    max_rel_baseline: jnp.ndarray  # (P,)
    num_good_res: jnp.ndarray      # (P,) int32
    idepth_hessian: jnp.ndarray    # (P,) H_dd + prior, for marg gating
    # --- hybrid indirect layer: keypoint-hosted points carry a link to
    # their host keyframe's feature table (kp_idx; -1 for gradient-selected
    # points) and per-target-frame matched-keypoint observations that enter
    # the window BA as reprojection factors (the reference hosts its point
    # candidates on detector keypoints, Src/Detector.cpp:56-67 +
    # Include/MapPoint.h pattern/descriptor coupling).
    kp_idx: jnp.ndarray       # (P,) int32 index into host Feats row; -1 none
    ind_u: jnp.ndarray        # (P, F) matched keypoint x in target frame
    ind_v: jnp.ndarray        # (P, F)
    ind_w: jnp.ndarray        # (P, F) information weight (octave sigma^-2)
    ind_valid: jnp.ndarray    # (P, F) bool — a match exists for this pair


class Window(NamedTuple):
    frames: Frames
    points: Points
    HM: jnp.ndarray           # (D, D), D = 4 + 8 F
    bM: jnp.ndarray           # (D,)


def state_dim(cfg: Config) -> int:
    return CPARS + 8 * cfg.max_frames


def empty_window(cfg: Config, height: int, width: int) -> Window:
    F, P = cfg.max_frames, cfg.max_points
    D = state_dim(cfg)
    frames = Frames(
        valid=jnp.zeros(F, bool),
        evalpt_R=jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (F, 3, 3)),
        evalpt_t=jnp.zeros((F, 3), jnp.float32),
        state=jnp.zeros((F, 8), jnp.float32),
        state_zero=jnp.zeros((F, 8), jnp.float32),
        exposure=jnp.ones(F, jnp.float32),
        energy_th=jnp.full(F, 12.0 * 12.0 * 8.0, jnp.float32),
        prior=jnp.zeros((F, 8), jnp.float32),
        kf_id=jnp.full(F, -1, jnp.int32),
        images=jnp.zeros((F, height, width, 3), jnp.float32),
    )
    points = Points(
        status=jnp.zeros(P, jnp.int32),
        host=jnp.zeros(P, jnp.int32),
        u=jnp.zeros(P, jnp.float32),
        v=jnp.zeros(P, jnp.float32),
        idepth=jnp.ones(P, jnp.float32),
        idepth_zero=jnp.ones(P, jnp.float32),
        color=jnp.zeros((P, 8), jnp.float32),
        weight=jnp.ones((P, 8), jnp.float32),
        prior=jnp.zeros(P, jnp.float32),
        res_state=jnp.full((P, F), RES_OOB, jnp.int32),
        max_rel_baseline=jnp.zeros(P, jnp.float32),
        num_good_res=jnp.zeros(P, jnp.int32),
        idepth_hessian=jnp.zeros(P, jnp.float32),
        kp_idx=jnp.full(P, -1, jnp.int32),
        ind_u=jnp.zeros((P, F), jnp.float32),
        ind_v=jnp.zeros((P, F), jnp.float32),
        ind_w=jnp.zeros((P, F), jnp.float32),
        ind_valid=jnp.zeros((P, F), bool),
    )
    return Window(
        frames=frames,
        points=points,
        HM=jnp.zeros((D, D), jnp.float32),
        bM=jnp.zeros(D, jnp.float32),
    )


def frame_natural_state(frames: Frames) -> jnp.ndarray:
    """(F, 8) in natural units [xi(6), a, b]."""
    return frames.state * jnp.asarray(FRAME_STATE_SCALE)


def frame_poses(frames: Frames):
    """Current worldToCam per frame: exp(natural xi) * evalPT."""
    from ..utils import lie

    nat = frame_natural_state(frames)
    dR, dt = lie.se3_exp(nat[:, :6])
    return lie.se3_mul(dR, dt, frames.evalpt_R, frames.evalpt_t)


def frame_affine(frames: Frames) -> jnp.ndarray:
    """Current (a, b) per frame in natural units (aff_g2l, Frame.h:142)."""
    nat = frame_natural_state(frames)
    return nat[:, 6:8]


def frame_affine_zero(frames: Frames) -> jnp.ndarray:
    """(a, b) at the linearization point (aff_g2l_0, Frame.h:143)."""
    nat0 = frames.state_zero * jnp.asarray(FRAME_STATE_SCALE)
    return nat0[:, 6:8]


def first_frame_prior(cfg: Config) -> np.ndarray:
    """Prior diag for keyframe 0 (Frame.h getPrior, id == 0 branch)."""
    p = np.zeros(8, np.float32)
    p[0:3] = cfg.initial_trans_prior
    p[3:6] = cfg.initial_rot_prior
    p[6] = cfg.initial_aff_a_prior
    p[7] = cfg.initial_aff_b_prior
    return p


def later_frame_prior(cfg: Config) -> np.ndarray:
    """Prior diag for later keyframes (Frame.h getPrior, else branch):
    affine priors only (affineOptMode values are the prior weights)."""
    p = np.zeros(8, np.float32)
    p[6] = cfg.affine_opt_mode_a if cfg.affine_opt_mode_a >= 0 else cfg.initial_aff_a_prior
    p[7] = cfg.affine_opt_mode_b if cfg.affine_opt_mode_b >= 0 else cfg.initial_aff_b_prior
    return p
