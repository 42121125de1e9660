"""System orchestration: the per-frame SLAM pipeline.

Re-design of the reference's System/Mapping orchestration
(Src/System.cpp ProcessNewFrame :104-247, Src/Mapping.cpp AddKeyframe
:12-142) on the fixed-capacity Window pytree. The host (Python) keeps only
the tiny state machine — keyframe decision, window slot bookkeeping,
marginalization flags, initializer retry logic — while all numeric work
runs in a handful of jit-compiled device functions with static shapes
(compiled once each).

Bootstrap: two-view initialization via batched KLT + H/F RANSAC +
cheirality-checked triangulation + median-depth normalization
(Src/Initializer.cpp Initialize :28-225; the DirectRefinement photometric
polish of the reference, :1330-2314, is planned as a follow-up stage).
"""
from __future__ import annotations

import dataclasses
import threading
import time as _time
from collections import deque
from functools import partial
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import PATTERN, Config
from ..models import kf_step as KS
from ..models import window as W
from ..models.calib import (Calib, k_pyr_from_value, level_intrinsics,
                            make_calib)
from ..models.optimizer import BAResult, ba_optimize
from ..ops import epipolar as epi_ops
from ..ops import klt as klt_ops
from ..ops import selector as sel_ops
from ..ops import tracker as trk_ops
from ..ops import twoview as tv_ops
from ..ops.pyramid import build_direct_pyramid
from ..utils import lie
from ..utils.compaction import assign_free_slots, scatter_update
from ..utils.interp import bilinear


@dataclasses.dataclass
class Shell:
    """Host-side per-frame record (FrameShell, Include/Frame.h:75-114)."""

    id: int
    timestamp: float
    exposure: float
    cam_to_world: np.ndarray      # (4, 4)
    tracking_ref: Optional[int]   # shell id of reference KF
    cam_to_ref: np.ndarray        # (4, 4)
    aff: np.ndarray               # (2,)
    is_kf: bool = False
    kf_id: int = -1
    pose_valid: bool = True
    relocalized: bool = False     # pose came from BoW/PnP relocalization —
                                  # downstream motion models must not read a
                                  # velocity across this frame


def _se3_np(R, t):
    T = np.eye(4, dtype=np.float64)
    T[:3, :3] = np.asarray(R)
    T[:3, 3] = np.asarray(t)
    return T


def default_vocab_path() -> Optional[str]:
    """The shipped 10^4-word BoW vocabulary (trained on diverse generated
    scenes by scripts/train_vocab.py --diverse; the reference makes the
    vocabulary a mandatory CLI argument, Main.h:81). None if the asset is
    missing (source checkout stripped of assets) — callers then fall back
    to online training."""
    import os
    p = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                     "assets", "vocab_10k.npz")
    return p if os.path.exists(p) else None


# candidate-point SoA lives in models/kf_step.py (Imm pytree); re-exported
# for checkpoint IO and tests
Imm = KS.Imm

# jitted-kernel cache shared across SLAMSystem instances, keyed by
# (cfg, height, width, mesh-id): constructing a second system with the same
# configuration (bench comparison runs, multi-system tests) binds the SAME
# jitted callables — and their already-compiled executables — instead of
# recompiling ~10 large graphs from scratch
_KERNEL_CACHE: dict = {}


def _copy_to_host_async(tree):
    """Start device->host copies of every leaf (hides the transfer latency
    behind subsequent device work); jax.device_get later finds the data
    staged."""
    for leaf in jax.tree_util.tree_leaves(tree):
        try:
            leaf.copy_to_host_async()
        except AttributeError:
            pass
    return tree


class SLAMSystem:
    """Monocular hybrid SLAM engine. Host-driven orchestration over
    jit-compiled device kernels."""

    def __init__(self, fx, fy, cx, cy, width, height, cfg: Config = Config(),
                 enable_loop_closure: bool = True, sequential: bool = True,
                 online_photo_calib: bool = False, photo_calib_every: int = 8,
                 dist_mesh=None, vocab_path: str | None = None,
                 metrics_path: str | None = None):
        """`dist_mesh` (optional jax.sharding.Mesh with a "points" axis):
        point-shard the windowed BA + point marginalization across the mesh
        devices (psum-reduced camera systems; parallel/dist_ba.py).
        cfg.max_points must divide the mesh size.

        `vocab_path`: BoW vocabulary (.npz from ops.bow.save_vocabulary /
        scripts/train_vocab.py) — the equivalent of the reference's
        mandatory vocabulary CLI argument (Main.h:81). Default (None)
        loads the SHIPPED 10^4-word vocabulary trained on diverse
        generated scenes (hslam_tpu/assets/vocab_10k.npz); pass "online"
        to instead train a small vocabulary from the first 8 keyframes of
        the run (scene-specialized fallback), or a path to your own.

        `metrics_path`: optional JSONL stream of per-frame ("frame") and
        per-keyframe ("kf") records — the structured observability layer
        the reference only had as printf (SURVEY.md §5); costs one
        json.dumps per frame, no extra device pulls."""
        from .. import ensure_compile_cache
        ensure_compile_cache()   # persistent compile cache iff the RESOLVED
        # backend is an accelerator (safe here: backend is in use anyway)
        self.cfg = cfg
        self.dist_mesh = dist_mesh
        if dist_mesh is not None:
            assert cfg.max_points % dist_mesh.size == 0, (
                "max_points must divide the mesh size")
        self.calib = make_calib(fx, fy, cx, cy, width, height)
        self.width, self.height = width, height
        self.enable_loop_closure = enable_loop_closure

        # --- online photometric calibration (the declared OnlineCalibrator
        # capability: Include/OnlineCalibrator.h:13-67 [stub in reference],
        # applied through the UpdateGamma hook semantics,
        # photometricUndistorter.cpp:175-200 + Frame.cpp:158-164).
        # When enabled, process_frame expects RAW (uncorrected) intensities;
        # the estimated inverse response + inverse vignette are applied
        # on-device before the pyramid build, and the response derivative
        # re-weights the gradient maps. The whole calibration chain runs on
        # device with zero host syncs.
        self.online_photo_calib = online_photo_calib
        self.photo_calib_every = photo_calib_every
        self._pc_blend = 0.3      # refit blend rate (see _photo_calib_step)
        self._pc_ring: deque = deque(maxlen=photo_calib_every)
        self._pc_params = None           # device PhotoParams after first fit
        self._pc_window_resync = False   # first fit landed; window state
                                         # must be re-corrected (mapping thread)
        self._pc_rms = None              # device scalar, pulled lazily
        self._inv_response = None        # (256,) device LUT
        self._inv_vignette = None        # (H, W) device map
        self._grad_weight = None         # (256,) device B' weights
        self.loop_closer = None          # built lazily once a vocab exists
        self._vocab_descs: list = []     # descriptor pool for training
        self._pending_entries: list = []  # KF entries awaiting the vocab
        if vocab_path is None:
            vocab_path = default_vocab_path()   # shipped artifact (or None)
        elif vocab_path == "online":
            vocab_path = None
        if enable_loop_closure and vocab_path is not None:
            from ..ops import bow as bow_ops
            from .loop_closure import LoopCloser
            self.loop_closer = LoopCloser(
                bow_ops.load_vocabulary(vocab_path), min_gap=10,
                dist_mesh=dist_mesh,
                min_loop_error_rel=1.0, consistency_th=2)
        self.n_loops_closed = 0
        self.n_relocs = 0    # successful BoW/PnP relocalizations
        self._metrics_f = open(metrics_path, "w") if metrics_path else None
        self.window = W.empty_window(cfg, height, width)
        self.imm = KS.empty_imm(cfg)
        from ..ops import features as FT
        self.feats = FT.empty_feats(cfg.max_frames, cfg.max_kf_features)
        self.shells: List[Shell] = []
        self.kf_shell_ids: List[int] = []
        self.slot_shell: List[Optional[int]] = [None] * cfg.max_frames
        self.initialized = False
        self.is_lost = False
        self.init_failed = False
        self.current_min_act_dist = 2.0
        self.last_coarse_rmse = np.full(5, 100.0)
        self.first_coarse_rmse = -1.0
        self.frame_count = 0
        self.next_kf_id = 0
        self.selector_pot = 5
        self._marg_counts: dict = {}
        self._last_flow = np.zeros(3)
        # --- host mirrors of the window policy state, refreshed from each
        # keyframe's KFBundle (ONE pull per KF): the inputs of
        # flagFramesForMarginalization / density adaptation never touch
        # device data between keyframes.
        F = cfg.max_frames
        self._m_valid = np.zeros(F, bool)
        self._m_kfid = np.full(F, -1, np.int64)
        self._m_t = np.zeros((F, 3))
        self._m_aff = np.zeros((F, 2))
        self._m_exp = np.ones(F)
        self._m_nact_host = np.zeros(F, np.int64)
        self._m_nimm_host = np.zeros(F, np.int64)
        self._m_n_active = 0
        # keyframe connectivity map (EnergyFunctional.h:83):
        # (host_kf_id, target_kf_id) -> [n_active_res, n_marginalized_res]
        self.connectivity: dict = {}
        # per-keyframe live indirect-observation counts (hybrid layer)
        self.ind_obs_history: List[int] = []

        # tracker reference state (host mirrors)
        self._newest_template: Optional[trk_ops.Template] = None
        self.template: Optional[trk_ops.Template] = None
        self.ref_slot = -1
        self.ref_shell_id = -1
        self.ref_aff = np.zeros(2)
        self.ref_exposure = 1.0

        # initializer state
        self._init_first = None   # dict with pyramid, points, colors...

        # --- async tracking/mapping pipeline (Mapping.cpp:144-214,
        # System.cpp:191-212). sequential=True mirrors the reference's
        # SequentialOperation default (Settings.cpp:42); sequential=False
        # runs AddKeyframe/ProcessNonKeyframe on a mapping thread with the
        # double-buffered tracker-reference swap of System.cpp:127-133.
        self.sequential = sequential
        self._pending_ref = None        # (template, slot, shell_id, aff, exp)
        self._ref_lock = threading.Lock()
        self._shell_lock = threading.Lock()
        self._map_exc: Optional[BaseException] = None
        self._lc_exc: Optional[BaseException] = None   # loop-closure worker
        # failures get their own slot — a concurrent mapping-thread
        # exception must not overwrite (or be overwritten by) one
        self.n_frames_skipped = 0       # non-KF frames dropped in catch-up
        # KF-need latch (reference NeedNewKFAfter, System.h:143): the shell
        # id of the tracking reference of the newest frame that wanted a
        # keyframe. The mapping thread keyframes the FRESHEST queued frame
        # once the queue drains, iff the latch outlives the newest window
        # KF (Mapping.cpp:197). Never lost, never applied to stale frames.
        self._need_kf_after = -1
        self._catch_up = False
        self._pending_kf_final = None   # deferred KF finalization (bundle)
        # lag-N pipelined-tracking frontier (process_frame_pipelined):
        # frame k's host finalization happens while frames k+1..k+lag compute
        # on device, which hides both the device time AND the device->host
        # latency of the result pull. The lag adds that many frames of pose
        # latency; its best value on a given device is not measured.
        self.pipeline_lag = 2
        self._pipe: deque = deque()
        self._frontier_frames = 0
        self._dev_prev = jnp.eye(4, dtype=jnp.float32)
        self._dev_prevprev = jnp.eye(4, dtype=jnp.float32)
        self._dev_aff = jnp.zeros(2, jnp.float32)
        # dispatch-frontier timestamps: the constant-motion hypothesis is a
        # velocity, so under input skipping it must be scaled by the
        # timestamp gap ratio (see ops/tracker.motion_hypotheses_device)
        self._prev_ts = 0.0
        self._prevprev_ts = 0.0
        self.n_track_retries = 0   # batched-winner rejections (paced-load
                                   # observability; see bench.py)
        # kf_latencies: time-to-fresh-template (dispatch latency — what the
        # tracker waits on). kf_full_latencies: dispatch -> finalized bundle
        # pull (the full mapper cost per keyframe) — report BOTH: the first
        # alone hides how long the mapper really takes per keyframe.
        self.kf_latencies: deque = deque(maxlen=200)
        self.kf_full_latencies: deque = deque(maxlen=200)
        self.lc_detect_ms: deque = deque(maxlen=200)
        # loop-closure worker state (async mode): BoW/PnP/pose-graph work
        # runs off the mapping thread; corrections are handed back via
        # _pending_loop_corr and applied between keyframe steps
        self._lc_thread = None
        self._pending_loop_corr = None
        self._lc_corr_lock = threading.Lock()
        if not sequential:
            self._queue: deque = deque()
            self._qcond = threading.Condition()
            self._map_stop = False
            self._map_busy = False
            self._map_thread = threading.Thread(
                target=self._mapping_loop, daemon=True)
            self._map_thread.start()
            if enable_loop_closure:
                self._lc_queue: deque = deque()
                self._lc_cond = threading.Condition()
                self._lc_stop = False
                self._lc_busy = False
                self._lc_thread = threading.Thread(
                    target=self._lc_loop, daemon=True)
                self._lc_thread.start()

        self._build_jit()

        self._precompile_thread = None
        self._precompile_stop = False
        self._precompile_exc: Optional[BaseException] = None
        if not sequential:
            # compile every kernel the live paths can touch up front (in
            # background, overlapping the main-path compiles): the selector
            # ladder AND the failure/relocalization/loop-closure chain — a
            # mid-run XLA compile on the recovery path stalls tracking for
            # the length of the compile, and under paced input the frames
            # skipped meanwhile push the next ones onto the failure path too
            self._precompile_thread = threading.Thread(
                target=self._precompile_kernels, daemon=True)
            self._precompile_thread.start()

    def _precompile_kernels(self):
        """Background thread body: run every precompile stage, keep the
        first exception for wait_compiles() to raise (a kernel that fails
        to compile must surface before the run, not in the middle of it)."""
        for stage in (self._precompile_selector, self._precompile_main_path,
                      self._precompile_reloc, self._precompile_lc,
                      self._precompile_photocal):
            if self._precompile_stop:
                return
            try:
                stage()
            except Exception as e:  # noqa: BLE001 — re-raised by wait_compiles
                if self._precompile_exc is None:
                    self._precompile_exc = e

    def _precompile_selector(self):
        cfg = self.cfg
        dummy = jnp.zeros((self.height, self.width, 3), jnp.float32)
        grads = tuple(
            jnp.zeros((self.height >> l, self.width >> l), jnp.float32)
            for l in range(3))
        for pot in self._POT_LADDER:
            if self._precompile_stop:
                return
            self._select_px(pot, dummy, grads,
                            int(cfg.desired_immature_density), 0)

    def _precompile_reloc(self):
        """Relocalization chain, with the EXACT live call signatures
        (shapes, dtypes, kwarg presence — any mismatch silently compiles a
        second executable at failure time)."""
        cfg = self.cfg
        from ..ops import features as FT
        from ..ops import pnp as pnp_ops
        img = jnp.zeros((self.height, self.width), jnp.float32)
        if cfg.enable_indirect:
            _, _, _, _, cdesc, cval = self._extract_feats(img)
            FT.match_pair_jit(cdesc, cval, cdesc, cval,
                              max_dist=80, ratio=0.9)
            n_feat = int(cdesc.shape[0])
        else:
            from ..ops import orb as orb_ops
            from ..ops.pyramid import gaussian_blur7
            score = orb_ops.fast_score(img, float(cfg.min_th_fast))
            u, v, valid = orb_ops.grid_nms(score, 8, 512)
            ang = orb_ops.ic_angle(img, u, v)
            desc = orb_ops.rbrief(gaussian_blur7(img), u, v, ang)
            orb_ops.match_descriptors_jit(desc, desc, valid_a=valid,
                                          valid_b=valid)
            n_feat = 512
        tcap = min(self.height * self.width, trk_ops.TEMPLATE_CAP)
        tz = jnp.zeros(tcap, jnp.float32)
        kz = jnp.zeros(n_feat, jnp.float32)
        self._lift_depths(kz, kz, tz, tz, tz, jnp.ones(tcap, bool))
        X = jnp.zeros((n_feat, 3), jnp.float32).at[:, 2].set(1.0)
        obs = jnp.zeros((n_feat, 2), jnp.float32)
        pnp_ops.solve_pnp_jit(
            X, obs, jnp.ones(n_feat, bool),
            jnp.asarray(np.eye(3, dtype=np.float32)),
            jax.random.PRNGKey(0),
            init_R=jnp.eye(3, dtype=jnp.float32),
            init_t=jnp.zeros(3, jnp.float32))

    def _precompile_lc(self):
        """Loop-closure detect kernels (BoW quantize/score, matcher, PnP)."""
        if self.loop_closer is not None:
            cfg = self.cfg
            n = (cfg.max_kf_features if cfg.enable_indirect else 512)
            self.loop_closer.warmup(n)

    def _precompile_photocal(self):
        """Online photometric calibration: sample + cold fit + warm refit —
        three distinct executables the live path hits."""
        if not self.online_photo_calib:
            return
        Fr = self.photo_calib_every
        tcap = min(self.height * self.width, trk_ops.TEMPLATE_CAP)
        tz = jnp.zeros(tcap, jnp.float32)
        K4 = jnp.asarray(np.ones(4, np.float32))
        raws = jnp.zeros((Fr, self.height, self.width), jnp.uint8)
        eyeF = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (Fr, 3, 3))
        obs, r2, mask = self._pc_sample(
            tz, tz, tz, jnp.ones(tcap, bool), K4, eyeF,
            jnp.zeros((Fr, 3), jnp.float32), raws)
        expz = jnp.ones(Fr, jnp.float32)
        p0, *_ = self._pc_fit(obs, r2, mask, expz, known=True)
        if not self._precompile_stop:
            self._pc_fit(obs, r2, mask, expz, known=True,
                         params0=p0, warm=True)

    def _precompile_main_path(self):
        """Touch every main-path kernel on dummy (all-invalid / zero)
        inputs, in the order the live init consumes them — compiles on a
        cold machine, cache loads on a warm one, overlapped with rendering
        and host set-up. Concurrent first calls on the same jit object are
        safe: the main thread finds the executable ready or waits on the
        same lock. Pure functions on masked state: garbage in, discarded
        out."""
        cfg = self.cfg
        F = cfg.max_frames
        stop = lambda: self._precompile_stop  # noqa: E731
        eye4 = jnp.eye(4, dtype=jnp.float32)
        z2 = jnp.zeros(2, jnp.float32)
        one = jnp.float32(1.0)

        img = jnp.zeros((self.height, self.width), jnp.float32)
        pyr, grads3 = self._prep(img)
        if stop():
            return
        nf = cfg.max_features
        zf = jnp.zeros(nf, jnp.float32)
        vf = jnp.zeros(nf, bool)
        self._klt_flow(tuple(p[..., 0] for p in pyr),
                       tuple(p[..., 0] for p in pyr), zf, zf, vf)
        if stop():
            return
        K3 = jnp.asarray(np.eye(3, dtype=np.float32))
        self._two_view(jnp.zeros((nf, 2)), jnp.zeros((nf, 2)), vf, K3,
                       jax.random.PRNGKey(0))
        if stop():
            return
        if cfg.init_direct_refine:
            self._init_refine(pyr[0], pyr[0], zf, zf, vf,
                              jnp.ones(nf, jnp.float32), vf,
                              jnp.eye(3, dtype=jnp.float32),
                              jnp.zeros(3, jnp.float32), self.calib.value)
        if stop():
            return
        wnd0 = W.empty_window(cfg, self.height, self.width)
        from ..ops import features as FT
        feats0 = FT.empty_feats(cfg.max_frames, cfg.max_kf_features)
        if cfg.enable_indirect:
            ext = self._extract_feats(img)
        else:
            z1 = jnp.zeros(1, jnp.float32)
            ext = (z1, z1, jnp.zeros(1, jnp.int32), z1,
                   jnp.zeros((1, 8), jnp.uint32), jnp.zeros(1, bool))
        self._init_seed(wnd0, feats0, pyr[0], zf, zf, vf,
                        jnp.ones(nf, jnp.float32), one, *ext)
        if stop():
            return
        sel = self._select_px(self.selector_pot, pyr[0], grads3,
                              int(cfg.desired_immature_density), 0)
        imm0 = KS.empty_imm(cfg)
        out = self._kf_step(
            wnd0, self.calib, imm0, feats0, tuple(pyr),
            jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32),
            z2, one, jnp.int32(0), jnp.int32(0), jnp.int32(-1),
            jnp.zeros(F, bool), jnp.float32(2.0), jnp.int32(1),
            *sel, ind_w_scale=one)
        template = out[4]
        if stop():
            return
        self._track_step(template, jnp.zeros((self.height, self.width),
                                             jnp.uint8),
                         self.calib.value, eye4, eye4, eye4,
                         jnp.bool_(False), z2, one, one, z2,
                         dt_ratio=one)
        if stop():
            return
        self._trace_step(imm0, wnd0.frames, self.calib.value,
                         jnp.eye(3, dtype=jnp.float32),
                         jnp.zeros(3, jnp.float32), z2, one, pyr[0])

    def wait_compiles(self, timeout: float = 1200.0):
        """Block until the background kernel precompiles finish — call after
        the warmup frames and before latency-sensitive measurement so no
        compile contends the device mid-run. Raises the first exception a
        precompile stage hit."""
        if self._precompile_thread is not None:
            self._precompile_thread.join(timeout=timeout)
        if self._precompile_exc is not None:
            exc, self._precompile_exc = self._precompile_exc, None
            raise exc

    # ------------------------------------------------------------------ jit
    def _build_jit(self):
        """Bind the jitted device kernels. Kernels are cached at MODULE
        level keyed by (cfg, image shape, mesh): a second SLAMSystem with
        the same configuration in the same process (bench comparison runs,
        multi-system tests) reuses the SAME jitted callables — and their
        warm executables — instead of recompiling ~10 large graphs."""
        key = (self.cfg, self.height, self.width,
               None if self.dist_mesh is None else id(self.dist_mesh))
        ns = _KERNEL_CACHE.get(key)
        if ns is None:
            ns = _KERNEL_CACHE[key] = self._make_kernels()
        for name, fn in ns.items():
            setattr(self, name, fn)
        self._K_pyr_cache = self._k_pyr(self.calib.value)

    def _make_kernels(self):
        cfg = self.cfg
        n_lvl = cfg.pyr_levels
        height, width = self.height, self.width
        mesh = self.dist_mesh
        ns = {}

        @jax.jit
        def prep(img):
            pyr, grads = build_direct_pyramid(img.astype(jnp.float32), n_lvl)
            return pyr, grads

        ns["_prep"] = prep

        @jax.jit
        def prep_calibrated(raw, inv_resp, inv_vig, grad_w):
            """Photometric correction fused into the pyramid build
            (photometricUndistorter.cpp:121-146 + Frame.cpp:158-164)."""
            from ..ops.undistort import photometric_correct
            img = photometric_correct(raw, inv_resp, inv_vig)
            return build_direct_pyramid(img, n_lvl, gamma_grad_weight=grad_w)

        ns["_prep_calibrated"] = prep_calibrated

        @jax.jit
        def pc_sample(u, v, idepth, valid, K4, R_rel, t_rel, raws):
            """Sample RAW intensities of the template points warped into
            each ring frame: returns obs (P, F), r2 (P, F), mask (P, F)."""
            raws = raws.astype(jnp.float32)   # ring frames may be uint8
            fx, fy, cx, cy = K4[0], K4[1], K4[2], K4[3]
            Hh, Ww = raws.shape[1], raws.shape[2]
            px = (u - cx) / fx
            py = (v - cy) / fy
            dirs = jnp.stack([px, py, jnp.ones_like(px)], -1)     # (P, 3)
            p3 = (jnp.einsum("fij,pj->fpi", R_rel, dirs)
                  + t_rel[:, None, :] * idepth[None, :, None])    # (F, P, 3)
            z = jnp.where(jnp.abs(p3[..., 2]) < 1e-9, 1e-9, p3[..., 2])
            uu = fx * p3[..., 0] / z + cx
            vv = fy * p3[..., 1] / z + cy
            inb = ((z > 0) & (uu > 1) & (vv > 1)
                   & (uu < Ww - 2) & (vv < Hh - 2))
            obs = jax.vmap(bilinear)(raws, uu, vv)                # (F, P)
            ccx, ccy = (Ww - 1) / 2.0, (Hh - 1) / 2.0
            r2 = (((uu - ccx) ** 2 + (vv - ccy) ** 2)
                  / (ccx * ccx + ccy * ccy))
            mask = inb & valid[None, :] & jnp.isfinite(obs)
            return obs.T, r2.T, mask.T

        ns["_pc_sample"] = pc_sample

        @partial(jax.jit, static_argnames=("known", "warm"))
        def pc_fit(obs, r2, mask, exp, known, params0=None, warm=False):
            """Joint response/vignette/exposure GN + LUT derivation, all
            on device (models/photo_calib.py). `known=True` pins the
            log-exposures to the telemetry in `exp` — breaks the gamma
            gauge ambiguity of joint response+exposure estimation. `warm`
            (with `params0` = the previous refit's params) warm-starts the
            GN and adds a weak prior toward the previous response/vignette
            so successive refits cannot oscillate."""
            from ..models import photo_calib as PC
            from ..ops.undistort import invert_response, response_grad_weight
            if warm:
                params = params0._replace(
                    log_exp=jnp.zeros(obs.shape[1], params0.log_exp.dtype))
                prev = params0
            else:
                params = PC.init_params(obs.shape[1])
                prev = None
            params, rms = PC.calibrate(
                params, obs, jnp.arange(obs.shape[1]), r2, mask,
                exp_known=exp if known else None, prev=prev)
            lut = PC.gamma_lut(params)
            inv_resp = invert_response(lut)
            grad_w = response_grad_weight(lut)
            inv_vig = 1.0 / PC.vignette_map(params, height, width)
            return params, rms, inv_resp, grad_w, inv_vig

        ns["_pc_fit"] = pc_fit

        @jax.jit
        def pc_resync_state(images, imm_color, imm_u, imm_v,
                            pts_color, pts_u, pts_v, inv_resp, inv_vig):
            """Re-correct the photometric state the window already holds
            when the FIRST online-calibration fit switches the correction
            on: the stored keyframe images (and their gradients), the
            immature candidates' pattern colors, and the active points'
            pattern colors were all built from UNCORRECTED frames — leaving
            them stale photometrically de-syncs every new (corrected) frame
            from the whole window (measured: coarse rmse 4-9 vs 0.5
            baseline until the window cycles). Exact because the prior
            correction was identity."""
            from ..ops.pyramid import image_gradients
            from ..ops.undistort import photometric_correct as pc

            def fix_img(img3):
                I = pc(img3[..., 0], inv_resp, inv_vig)
                dx, dy = image_gradients(I)
                return jnp.stack([I, dx, dy], -1)

            images2 = jax.vmap(fix_img)(images)
            pat = jnp.asarray(PATTERN, jnp.float32)

            def fix_colors(c, u, v):
                up = jnp.clip(u[:, None] + pat[None, :, 0], 0.0, width - 1.0)
                vp = jnp.clip(v[:, None] + pat[None, :, 1], 0.0, height - 1.0)
                vig = bilinear(inv_vig, up, vp)
                return pc(c, inv_resp, None) * vig

            return (images2, fix_colors(imm_color, imm_u, imm_v),
                    fix_colors(pts_color, pts_u, pts_v))

        ns["_pc_resync_state"] = pc_resync_state

        @jax.jit
        def pc_resync_template(tpl, inv_resp, inv_vig):
            """Re-correct the live tracking template's colors (same first-
            fit transient as pc_resync_state, but for the half of it the
            TRACKING thread owns — the coarse tracker compares template
            colors against corrected incoming frames)."""
            from ..ops.undistort import photometric_correct as pc
            new_colors = []
            for lvl in range(len(tpl.color)):
                f = float(1 << lvl)
                u0 = jnp.clip(tpl.u[lvl] * f, 0.0, width - 1.0)
                v0 = jnp.clip(tpl.v[lvl] * f, 0.0, height - 1.0)
                vig = bilinear(inv_vig, u0, v0)
                new_colors.append(pc(tpl.color[lvl], inv_resp, None) * vig)
            return tpl._replace(color=new_colors)

        ns["_pc_resync_template"] = pc_resync_template

        from ..ops.undistort import photometric_correct
        ns["_correct_img"] = jax.jit(photometric_correct)
        ns["_track"] = jax.jit(
            partial(trk_ops.track_coarse, cfg=cfg, coarsest_lvl=n_lvl - 1)
        )
        ns["_track_multi"] = jax.jit(
            partial(trk_ops.track_coarse_multi, cfg=cfg, coarsest_lvl=n_lvl - 1)
        )
        ns["_track_step"] = jax.jit(
            partial(trk_ops.track_step, cfg=cfg, n_levels=n_lvl)
        )

        def track_step_cal(template, raw, inv_resp, inv_vig, grad_w,
                           calib_value, *rest, dt_ratio=None):
            """Online-calib variant of the fused tracking step: photometric
            correction + gamma gradient-reweighting fused into the same
            dispatch, so the pipelined path matches the sequential path's
            Frame.cpp:158-164 semantics (round-3 gap: the pipelined path
            applied intensity correction only)."""
            from ..ops.undistort import photometric_correct
            img = photometric_correct(raw.astype(jnp.float32), inv_resp,
                                      inv_vig)
            return trk_ops.track_step(template, img, calib_value, *rest,
                                      cfg=cfg, n_levels=n_lvl,
                                      gamma_grad_weight=grad_w,
                                      dt_ratio=dt_ratio)

        ns["_track_step_cal"] = jax.jit(track_step_cal)
        # n_iterations is a traced scalar (the GN while_loop bound) so the
        # init-time 20/15-iteration windows share ONE compilation with the
        # steady-state 6-iteration one
        ns["_ba"] = jax.jit(
            lambda wnd, calib, n: ba_optimize(wnd, calib, cfg, n))
        # the whole AddKeyframe pipeline as one dispatch + one bundle pull
        ns["_kf_step"] = jax.jit(partial(KS.kf_step, cfg=cfg, mesh=mesh))

        def trace_step(imm, frames, calib_value, R_new, t_new, aff, exp, tgt):
            tr = KS.trace_candidates(imm, frames, calib_value, R_new, t_new,
                                     aff, exp, tgt, cfg)
            return imm._replace(trace=tr)

        ns["_trace_step"] = jax.jit(trace_step)

        from ..ops import features as FT
        ns["_extract_feats"] = jax.jit(
            lambda img: FT.extract_multiscale(
                img, cfg.ind_pyr_levels, cfg.max_kf_features,
                float(cfg.min_th_fast), scale=cfg.ind_pyr_scale,
                do_subpix=cfg.do_subpix, use_fast_only=cfg.use_fast,
                min_grad=float(cfg.min_grad_hist_add)))
        from ..ops import init_refine as ir_ops
        ns["_init_refine"] = jax.jit(partial(ir_ops.direct_refine, cfg=cfg))
        ns["_k_pyr"] = jax.jit(partial(k_pyr_from_value, n_levels=n_lvl))
        ns["_select"] = {}   # per-pot compiled selector (shared so a pot
                             # warmed by one system is warm for all)

        @jax.jit
        def sample_pattern(img, u, v):
            pat = jnp.asarray(PATTERN, jnp.float32)
            up = u[:, None] + pat[None, :, 0]
            vp = v[:, None] + pat[None, :, 1]
            col = bilinear(img[..., 0], up, vp)
            gx = bilinear(img[..., 1], up, vp)
            gy = bilinear(img[..., 2], up, vp)
            c = cfg.outlier_th_sum_component
            wgt = jnp.sqrt(c / (c + gx**2 + gy**2))
            gH = jnp.stack(
                [
                    jnp.stack([jnp.sum(gx * gx, -1), jnp.sum(gx * gy, -1)], -1),
                    jnp.stack([jnp.sum(gx * gy, -1), jnp.sum(gy * gy, -1)], -1),
                ],
                -2,
            )
            finite = jnp.all(jnp.isfinite(col), axis=-1)
            return col, wgt, gH, finite

        ns["_sample_pattern"] = sample_pattern

        # --- init-path kernels. These run only during bootstrap, but
        # UN-jitted they dispatch hundreds of single-op executables, each
        # compiled on first use. One jit each.
        def klt_flow(ref_pyr, tgt_pyr, u, v, valid):
            """KLT + stationarity statistics in one dispatch
            (Initializer.cpp:341-398 + :117-118)."""
            pts = jnp.stack([u, v], -1)
            tracked, ok, _err = klt_ops.track(list(ref_pyr), list(tgt_pyr),
                                              pts)
            ok = ok & valid
            n_ok = jnp.sum(ok)
            flow = jnp.sqrt(jnp.sum((tracked - pts) ** 2, -1))
            mean_flow = (jnp.sum(jnp.where(ok, flow, 0.0))
                         / jnp.maximum(n_ok, 1))
            return pts, tracked, ok, n_ok, mean_flow

        ns["_klt_flow"] = jax.jit(klt_flow)
        ns["_two_view"] = jax.jit(
            lambda p1, p2, ok, K, key: tv_ops.two_view_reconstruct(
                p1, p2, ok, K, key, n_iters=cfg.init_ransac_iters))

        def init_seed(wnd, feats, img0, u, v, cand_ok, idepth, exposure,
                      f_u, f_v, f_lvl, f_sc, f_desc, f_val):
            """InitFromInitializer's numeric core (System.cpp:249-319):
            seed KF0 into slot 0 with depth-prior'd active points (+ the
            indirect keypoint links) — ONE dispatch instead of ~40
            op-by-op scatters."""
            frames = wnd.frames
            frames = frames._replace(
                valid=frames.valid.at[0].set(True),
                evalpt_R=frames.evalpt_R.at[0].set(jnp.eye(3)),
                evalpt_t=frames.evalpt_t.at[0].set(jnp.zeros(3)),
                state=frames.state.at[0].set(0.0),
                state_zero=frames.state_zero.at[0].set(0.0),
                exposure=frames.exposure.at[0].set(exposure),
                prior=frames.prior.at[0].set(
                    jnp.asarray(W.first_frame_prior(cfg))),
                kf_id=frames.kf_id.at[0].set(0),
                images=frames.images.at[0].set(img0),
            )
            col, wgt, _gH, finite = sample_pattern(img0, u, v)
            cand_ok = cand_ok & finite

            kp_link = jnp.full(u.shape[0], -1, jnp.int32)
            if cfg.enable_indirect:
                feats = feats._replace(
                    u=feats.u.at[0].set(f_u),
                    v=feats.v.at[0].set(f_v),
                    level=feats.level.at[0].set(f_lvl),
                    score=feats.score.at[0].set(f_sc),
                    desc=feats.desc.at[0].set(f_desc),
                    valid=feats.valid.at[0].set(f_val),
                )
                d2 = ((u[:, None] - f_u[None, :]) ** 2
                      + (v[:, None] - f_v[None, :]) ** 2)
                d2 = jnp.where(f_val[None, :], d2, jnp.inf)
                nn = jnp.argmin(d2, axis=1)
                kp_link = jnp.where(jnp.min(d2, axis=1) <= 2.5 ** 2,
                                    nn.astype(jnp.int32), -1)

            points = wnd.points
            slots, write = assign_free_slots(points.status == W.PT_EMPTY,
                                             cand_ok)
            points = points._replace(
                kp_idx=scatter_update(points.kp_idx, slots, write, kp_link),
                status=scatter_update(points.status, slots, write,
                                      jnp.full_like(slots, W.PT_ACTIVE)),
                host=scatter_update(points.host, slots, write,
                                    jnp.zeros_like(slots)),
                u=scatter_update(points.u, slots, write, u),
                v=scatter_update(points.v, slots, write, v),
                idepth=scatter_update(points.idepth, slots, write, idepth),
                idepth_zero=scatter_update(points.idepth_zero, slots, write,
                                           idepth),
                color=scatter_update(points.color, slots, write, col),
                weight=scatter_update(points.weight, slots, write, wgt),
                prior=scatter_update(points.prior, slots, write,
                                     jnp.full_like(u, cfg.idepth_fix_prior)),
            )
            n_pts0 = jnp.sum(cand_ok)
            return (W.Window(frames=frames, points=points, HM=wnd.HM,
                             bM=wnd.bM), feats, n_pts0)

        ns["_init_seed"] = jax.jit(init_seed)

        @jax.jit
        def map_cloud(frames, points, calib_value):
            """World-space positions of every point slot + validity — the
            live-map feed (capability of Src/Display.cpp:382-441: per-KF
            point clouds with the maxRelBaseline / idepth-variance noise
            filter of :409-421). Fixed shapes; the host decimates."""
            fx, fy, cx, cy = (calib_value[0], calib_value[1],
                              calib_value[2], calib_value[3])
            R, t = W.frame_poses(frames)          # worldToCam
            idp = jnp.maximum(points.idepth, 1e-6)
            z = 1.0 / idp
            pc = jnp.stack([(points.u - cx) / fx * z,
                            (points.v - cy) / fy * z, z], -1)   # (P, 3)
            Rh = R[points.host]                   # (P, 3, 3)
            th = t[points.host]
            xyz = jnp.einsum("pji,pj->pi", Rh, pc - th)
            # noise filter (Display.cpp:409-421): depth-prior'd bootstrap
            # points keep max_rel_baseline 0 — exempt them via the prior
            id_var = 1.0 / (points.idepth_hessian + 0.01)
            ok = ((points.status == W.PT_ACTIVE) & (points.idepth > 1e-6)
                  & ((points.max_rel_baseline >= 0.01) | (points.prior > 0))
                  & (id_var <= 1e-2 * z * z * z * z))
            return xyz, ok, points.color[:, 4]

        ns["_map_cloud"] = map_cloud

        # device keypoint depth lift (shared with kf_step's in-dispatch
        # version, ops/tracker.nearest_template_depth) — used by the
        # relocalization and non-indirect loop-closure paths
        ns["_lift_depths"] = jax.jit(trk_ops.nearest_template_depth)
        return ns

    def _select_px(self, pot, dir_img, grads, want, seed):
        """Candidate pixel source. Default: the PixelSelector gradient
        sampler (reference UseFAST=false default, Detector.cpp:56-67);
        cfg.use_fast switches to FAST corners + grid NMS
        (Detector.cpp:47-55 + Ssc)."""
        cfg = self.cfg
        if cfg.use_fast:
            if "fast" not in self._select:
                from ..ops import orb as orb_ops

                def fast_sel(d, w, s):
                    score = orb_ops.fast_score(d[..., 0], float(cfg.min_th_fast))
                    u, v, valid = orb_ops.grid_nms(
                        score, max(cfg.enforced_min_dist, 4), cfg.max_features
                    )
                    ptype = jnp.ones_like(u, jnp.int32)
                    return u, v, ptype, valid

                self._select["fast"] = jax.jit(fast_sel)
            return self._select["fast"](dir_img, jnp.int32(want), jnp.int32(seed))
        if pot not in self._select:
            self._select[pot] = jax.jit(
                lambda d, g0, g1, g2, w, s: sel_ops.compact_selection(
                    sel_ops.select_pixels(d, (g0, g1, g2), pot, 1.0, s, cfg),
                    g0, cfg.max_features, w, s,
                )
            )
        return self._select[pot](dir_img, grads[0], grads[1], grads[2],
                                 jnp.int32(want), jnp.int32(seed))

    # ------------------------------------------------------------ main entry
    def process_frame(self, image: np.ndarray, timestamp: float,
                      exposure: float = 1.0):
        """ProcessNewFrame (System.cpp:104-247). `image` is the
        geometrically-corrected grayscale frame; photometrically corrected
        too unless online_photo_calib is on (then RAW intensities)."""
        cfg = self.cfg
        raw = jnp.asarray(image, jnp.float32)
        if self.online_photo_calib and self._inv_response is not None:
            pyr, grads = self._prep_calibrated(
                raw, self._inv_response, self._inv_vignette, self._grad_weight)
        else:
            pyr, grads = self._prep(raw)

        shell = Shell(
            id=self.frame_count, timestamp=timestamp, exposure=exposure,
            cam_to_world=np.eye(4), tracking_ref=None, cam_to_ref=np.eye(4),
            aff=np.zeros(2),
        )
        self.frame_count += 1
        self.shells.append(shell)

        if self._map_exc is not None:
            exc, self._map_exc = self._map_exc, None
            raise exc

        if not self.initialized:
            self._try_initialize(shell, pyr, grads)
            return shell

        # --- adopt a freshly published tracker reference (the
        # coarseTracker <-> coarseTracker_forNewKF swap, System.cpp:127-133)
        with self._ref_lock:
            if self._pending_ref is not None:
                (self.template, self.ref_slot, self.ref_shell_id,
                 self.ref_aff, self.ref_exposure) = self._pending_ref
                self._pending_ref = None
                self.first_coarse_rmse = -1.0

        # --- track against the reference keyframe template
        ok = self._track_new_coarse(shell, pyr)
        if not ok:
            self.is_lost = True
            return shell

        # --- online photometric calibration observation + periodic refit
        if self.online_photo_calib:
            self._pc_ring.append((shell.id, raw))
            if (len(self._pc_ring) == self._pc_ring.maxlen
                    and shell.id % self.photo_calib_every == 0):
                self._photo_calib_step()

        # --- keyframe decision (System.cpp:159-177)
        need_kf = self._need_keyframe(shell)
        self._emit_metrics(
            t="frame", id=shell.id, ts=timestamp, kf=bool(need_kf),
            rmse=float(self.last_coarse_rmse[0]),
            pose_valid=bool(shell.pose_valid),
            reloc=bool(shell.relocalized),
            p=[round(float(x), 4) for x in shell.cam_to_world[:3, 3]])

        if self.sequential:
            if need_kf:
                self._add_keyframe(shell, pyr, grads)
            else:
                self._process_non_kf(shell, pyr)
        else:
            with self._qcond:
                if need_kf and shell.tracking_ref is not None:
                    self._need_kf_after = max(self._need_kf_after,
                                              shell.tracking_ref)
                self._queue.append((shell, pyr, grads))
                self._qcond.notify_all()
        return shell

    # ---------------------------------------------------- pipelined entry
    def process_frame_pipelined(self, image: np.ndarray, timestamp: float,
                                exposure: float = 1.0) -> Optional[Shell]:
        """Lag-1 pipelined ProcessNewFrame: dispatch this frame's fused
        tracking step (pyramid + device-side motion hypotheses + batched
        scoring + coarse-to-fine LM, ops/tracker.track_step) WITHOUT
        blocking, then pull and finalize the PREVIOUS frame's result — so
        the host round-trip for frame k-1 overlaps frame k's device
        compute. Returns the newly COMPLETED shell (frame k-1), or None.

        Call flush_pipeline() + finish() at end of sequence. Requires
        sequential=False (the mapping thread consumes KF work)."""
        if self._map_exc is not None:
            exc, self._map_exc = self._map_exc, None
            raise exc
        cfg = self.cfg
        shell = Shell(
            id=self.frame_count, timestamp=timestamp, exposure=exposure,
            cam_to_world=np.eye(4), tracking_ref=None, cam_to_ref=np.eye(4),
            aff=np.zeros(2),
        )
        self.frame_count += 1
        self.shells.append(shell)

        if not self.initialized:
            self.flush_pipeline()
            img = jnp.asarray(image, jnp.float32)
            if self.online_photo_calib and self._inv_response is not None:
                pyr, grads = self._prep_calibrated(
                    img, self._inv_response, self._inv_vignette,
                    self._grad_weight)
            else:
                pyr, grads = self._prep(img)
            self._try_initialize(shell, pyr, grads)
            if self.initialized:
                # seed the device frontier at the second init keyframe
                self._frontier_frames = 0
                self._dev_prev = jnp.asarray(shell.cam_to_world, jnp.float32)
                self._dev_prevprev = self._dev_prev
                self._dev_aff = jnp.asarray(shell.aff, jnp.float32)
            return None

        # adopt a freshly published tracker reference (System.cpp:127-133)
        with self._ref_lock:
            if self._pending_ref is not None:
                (self.template, self.ref_slot, self.ref_shell_id,
                 self.ref_aff, self.ref_exposure) = self._pending_ref
                self._pending_ref = None
                self.first_coarse_rmse = -1.0

        with self._shell_lock:
            ref_c2w = self.shells[self.ref_shell_id].cam_to_world.copy()
        shell.tracking_ref = self.ref_shell_id
        # timestamp-gap ratio for the constant-motion hypotheses: under the
        # realtime input-skip policy (Main.cpp:91-106) consecutive PROCESSED
        # frames can be many camera periods apart — the velocity model must
        # scale with the gap or the true pose falls outside the hypothesis
        # set and every post-skip frame takes the failure path
        dt_prev = self._prev_ts - self._prevprev_ts
        dt_new = timestamp - self._prev_ts
        if self._frontier_frames >= 2 and dt_prev > 1e-9 and dt_new > 0:
            dt_ratio = float(np.clip(dt_new / dt_prev, 0.1, 32.0))
        else:
            dt_ratio = 1.0
        dt_ratio = jnp.float32(dt_ratio)
        # frames go to the device in their native dtype (uint8 preferred:
        # 4x fewer host->device bytes); conversion happens on device
        raw = jnp.asarray(image)
        if self.online_photo_calib and self._inv_response is not None:
            # fused correction + gamma gradient-reweighting + tracking in
            # ONE dispatch — photometrically identical to the sequential
            # path (Frame.cpp:158-164 semantics)
            out = self._track_step_cal(
                self.template, raw, self._inv_response, self._inv_vignette,
                self._grad_weight, self.calib.value,
                jnp.asarray(ref_c2w, jnp.float32),
                self._dev_prev, self._dev_prevprev,
                jnp.bool_(self._frontier_frames >= 2),
                self._dev_aff,
                jnp.float32(self.ref_exposure), jnp.float32(shell.exposure),
                jnp.asarray(self.ref_aff, jnp.float32),
                dt_ratio=dt_ratio,
            )
        else:
            out = self._track_step(
                self.template, raw, self.calib.value,
                jnp.asarray(ref_c2w, jnp.float32),
                self._dev_prev, self._dev_prevprev,
                jnp.bool_(self._frontier_frames >= 2),
                self._dev_aff,
                jnp.float32(self.ref_exposure), jnp.float32(shell.exposure),
                jnp.asarray(self.ref_aff, jnp.float32),
                dt_ratio=dt_ratio,
            )
        # start the device->host copy of the small result NOW so the pull in
        # _complete_tracked (pipeline_lag frames later) finds it staged
        _copy_to_host_async((out.R, out.t, out.aff, out.ok,
                             out.residuals, out.flow))
        self._pipe.append((shell, out, raw))
        self._dev_prevprev = self._dev_prev
        self._dev_prev = out.c2w
        self._dev_aff = out.aff
        self._prevprev_ts = self._prev_ts
        self._prev_ts = timestamp
        self._frontier_frames += 1

        if len(self._pipe) > self.pipeline_lag:
            return self._complete_tracked(*self._pipe.popleft())
        return None

    def flush_pipeline(self):
        """Complete all in-flight pipelined frames."""
        out = None
        while getattr(self, "_pipe", None):
            out = self._complete_tracked(*self._pipe.popleft())
        return out

    def _photo_calib_step(self):
        """One online-calibration refit: warp the tracker template into the
        ring frames, sample their RAW intensities, jointly fit response /
        vignette / exposure, and refresh the correction LUTs — entirely on
        device (UpdateGamma semantics, photometricUndistorter.cpp:175-200;
        capability per Include/OnlineCalibrator.h:13-67)."""
        if self.template is None:
            return
        tpl = self.template
        with self._shell_lock:
            ref_c2w = self.shells[self.ref_shell_id].cam_to_world.copy()
            rels = []
            exps = []
            for sid, _ in self._pc_ring:
                T = np.linalg.inv(self.shells[sid].cam_to_world) @ ref_c2w
                rels.append(T)
                exps.append(self.shells[sid].exposure or 1.0)
        rels = np.stack(rels)
        exps = np.asarray(exps, np.float32)
        # exposure telemetry (when present) pins the gauge; all-ones means
        # "unknown" (DatasetLoader convention for missing exposure files)
        exp_known = bool(np.any(np.abs(exps - 1.0) > 1e-9))
        raws = jnp.stack([r for _, r in self._pc_ring])
        K4 = jnp.asarray([self.calib.value[i] for i in range(4)])
        obs, r2, mask = self._pc_sample(
            tpl.u[0], tpl.v[0], tpl.idepth[0], tpl.valid[0], K4,
            jnp.asarray(rels[:, :3, :3], jnp.float32),
            jnp.asarray(rels[:, :3, 3], jnp.float32), raws,
        )
        (self._pc_params, self._pc_rms, inv_resp, grad_w,
         inv_vig) = self._pc_fit(
            obs, r2, mask, jnp.asarray(exps), known=exp_known,
            params0=self._pc_params, warm=self._pc_params is not None)
        if self._inv_response is None:
            # first fit: switch the correction on AND re-correct the
            # photometric state built before it existed. The template half
            # is owned by this (tracking) thread and fixed here; the
            # window/candidate half is owned by the mapping thread and
            # rides its next keyframe step (_add_keyframe checks the flag).
            self._inv_response = inv_resp
            self._grad_weight = grad_w
            self._inv_vignette = inv_vig
            if self.template is not None:
                # calling thread owns self.template (tracking thread in
                # pipelined mode, the single thread in sequential mode)
                self.template = self._pc_resync_template(
                    self.template, inv_resp, inv_vig)
            # a template already staged for publication was also built
            # pre-correction — fix it in place under the ref lock, or the
            # next publish re-installs a stale one
            if not self.sequential:
                with self._ref_lock:
                    if self._pending_ref is not None:
                        tpl, slot_, sid_, aff_, exp_ = self._pending_ref
                        self._pending_ref = (
                            self._pc_resync_template(tpl, inv_resp, inv_vig),
                            slot_, sid_, aff_, exp_)
            self._pc_window_resync = True
        else:
            # later refits: BLEND into the applied correction instead of
            # swapping it — an abrupt LUT change photometrically de-syncs
            # incoming frames from every keyframe image already in the
            # window (template + BA residuals), measurably costing ATE
            a = self._pc_blend
            self._inv_response = (1 - a) * self._inv_response + a * inv_resp
            self._grad_weight = (1 - a) * self._grad_weight + a * grad_w
            self._inv_vignette = (1 - a) * self._inv_vignette + a * inv_vig

    def _complete_tracked(self, shell: Shell, out, raw=None) -> Shell:
        """Finalize one pipelined frame: pull the track result (one host
        round-trip), publish the shell pose, decide keyframe, and hand the
        frame to the mapping thread."""
        cfg = self.cfg
        R_h, t_h, aff_h, ok_h, res_h, flow_h = jax.device_get(
            (out.R, out.t, out.aff, out.ok, out.residuals, out.flow))
        ok = bool(ok_h) and np.isfinite(res_h[0]) and np.all(np.isfinite(t_h))
        if ok:
            self.last_coarse_rmse = np.where(
                np.isnan(res_h), 100.0, np.minimum(res_h, 1e9))
            if self.first_coarse_rmse < 0:
                self.first_coarse_rmse = float(res_h[0])
            T_best = _se3_np(R_h, t_h)
            shell.cam_to_ref = np.linalg.inv(T_best)
            with self._shell_lock:
                shell.cam_to_world = (
                    self.shells[shell.tracking_ref].cam_to_world
                    @ shell.cam_to_ref
                )
            shell.aff = np.asarray(aff_h, np.float64)
            self._last_flow = np.asarray(flow_h)
        else:
            # rare: batched winner rejected — retry with a RESET motion
            # frontier (zero-motion hypotheses from the reference keyframe)
            # through the SAME WARM track_step executable. Critical: feed
            # the staged uint8 `raw` (the dtype the warm executable was
            # traced on), NOT a float32 slice of the pyramid — a dtype
            # change would silently jit a SECOND full fused-tracker
            # executable on the latency-critical recovery path, where the
            # compile stall makes paced input skip and fail in a spiral
            self.n_track_retries += 1
            with self._shell_lock:
                ref_c2w = self.shells[self.ref_shell_id].cam_to_world.copy()
            ref_dev = jnp.asarray(ref_c2w, jnp.float32)
            retry_img = raw if raw is not None else out.pyr[0][..., 0]
            if self.online_photo_calib and self._inv_response is not None:
                out2 = self._track_step_cal(
                    self.template, retry_img, self._inv_response,
                    self._inv_vignette, self._grad_weight, self.calib.value,
                    ref_dev, ref_dev, ref_dev, jnp.bool_(False),
                    jnp.asarray(self.ref_aff, jnp.float32),
                    jnp.float32(self.ref_exposure),
                    jnp.float32(shell.exposure),
                    jnp.asarray(self.ref_aff, jnp.float32),
                    dt_ratio=jnp.float32(1.0),
                )
            else:
                out2 = self._track_step(
                    self.template, retry_img, self.calib.value,
                    ref_dev, ref_dev, ref_dev, jnp.bool_(False),
                    jnp.asarray(self.ref_aff, jnp.float32),
                    jnp.float32(self.ref_exposure),
                    jnp.float32(shell.exposure),
                    jnp.asarray(self.ref_aff, jnp.float32),
                    dt_ratio=jnp.float32(1.0),
                )
            R2, t2, aff2, ok2, res2, flow2 = jax.device_get(
                (out2.R, out2.t, out2.aff, out2.ok, out2.residuals,
                 out2.flow))
            ok = bool(ok2) and np.isfinite(res2[0]) and np.all(np.isfinite(t2))
            if ok:
                self.last_coarse_rmse = np.where(
                    np.isnan(res2), 100.0, np.minimum(res2, 1e9))
                T_best = _se3_np(R2, t2)
                shell.cam_to_ref = np.linalg.inv(T_best)
                with self._shell_lock:
                    shell.cam_to_world = ref_c2w @ shell.cam_to_ref
                shell.aff = np.asarray(aff2, np.float64)
                self._last_flow = np.asarray(flow2)
            else:
                # recovery: BoW+PnP relocalization, else predicted pose
                # ("hope to recover", System.cpp:483-489)
                reloc = self._attempt_relocalization(shell, out.pyr)
                if reloc is not None:
                    self.n_relocs += 1
                    shell.relocalized = True
                    shell.cam_to_world = reloc
                else:
                    shell.pose_valid = False
                    shell.cam_to_world = ref_c2w
                shell.cam_to_ref = (
                    np.linalg.inv(ref_c2w) @ shell.cam_to_world)
                shell.aff = np.asarray(self.ref_aff, np.float64).copy()
                self._last_flow = np.zeros(3)
                ok = True    # reference semantics: not lost unless NaN
            self._frontier_frames = 0
            self._dev_prev = jnp.asarray(shell.cam_to_world, jnp.float32)
            self._dev_prevprev = self._dev_prev
            self._dev_aff = jnp.asarray(shell.aff, jnp.float32)

        if self.online_photo_calib and raw is not None:
            self._pc_ring.append((shell.id, raw))
            if (len(self._pc_ring) == self._pc_ring.maxlen
                    and shell.id % self.photo_calib_every == 0):
                self._photo_calib_step()

        need_kf = self._need_keyframe(shell)
        with self._qcond:
            # Reference handoff (System.cpp:191-198): frames enqueue
            # UNTAGGED; a KF need only raises the NeedNewKFAfter latch.
            # The mapping thread keyframes the freshest frame when the
            # queue drains (Mapping.cpp:169-209) — so under load the map
            # keeps getting keyframes (no starvation) but never burns
            # time on a backlog of stale ones (no death spiral).
            if need_kf and shell.tracking_ref is not None:
                self._need_kf_after = max(self._need_kf_after,
                                          shell.tracking_ref)
            self._queue.append((shell, out.pyr, out.grads))
            self._qcond.notify_all()
        return shell

    # ------------------------------------------------------ mapping thread
    def _mapping_loop(self):
        """Consumer loop over the tracked-frame queue — the reference's
        MappingThread policy verbatim (Mapping.cpp:143-214):

          * the first two tracked frames after init are forced keyframes;
          * while MORE frames wait behind the popped one, it is processed
            as a NON-keyframe (trace only) regardless of KF demand, and in
            catch-up mode (>3 behind) a second frame is dropped outright
            (pose bookkeeping only);
          * the keyframe is made from the FRESHEST frame — the one popped
            with an empty queue — iff the NeedNewKFAfter latch outlives
            the newest window keyframe (Mapping.cpp:197).

        Under sustained load this keeps the map fed with CURRENT keyframes
        instead of either starving it (round-3 backpressure) or burning
        the mapper on a backlog of stale ones."""
        while True:
            with self._qcond:
                while not self._queue and not self._map_stop:
                    self._qcond.wait()
                if self._map_stop and not self._queue:
                    return
                shell, pyr, grads = self._queue.popleft()
                more = len(self._queue)
                self._map_busy = True
            try:
                # a worker-computed loop correction folds in only AFTER
                # any deferred keyframe finalization (the deferred
                # bundle's poses predate the correction), and before the
                # next keyframe/trace step touches the window
                with self._lc_corr_lock:
                    corr_waiting = self._pending_loop_corr is not None
                if corr_waiting:
                    self._finalize_pending_kf()
                    self._apply_pending_loop_corr()
                if more > self.CATCHUP_DRAIN:
                    # severe overload (tracker far outrunning the mapper —
                    # the reference's drop-every-second-frame catch-up
                    # assumes the queue eventually drains; under sustained
                    # overload it never does, no keyframe is ever made,
                    # and the tracking template goes stale until loss).
                    # Fast-forward: drop everything but the FRESHEST frame
                    # (pose bookkeeping only) and let it take the
                    # drained-queue branch below — the latched KF fires on
                    # current data and the template stays fresh.
                    dropped = [(shell, pyr, grads)]
                    with self._qcond:
                        while len(self._queue) > 1:
                            dropped.append(self._queue.popleft())
                        shell, pyr, grads = self._queue.pop()
                        more = len(self._queue)
                    with self._shell_lock:
                        for dsh, _, _ in dropped:
                            if dsh.tracking_ref is not None:
                                dsh.cam_to_world = (
                                    self.shells[dsh.tracking_ref]
                                    .cam_to_world @ dsh.cam_to_ref)
                    self.n_frames_skipped += len(dropped)
                if len(self.kf_shell_ids) <= 2:
                    # forced KFs for the first two tracked frames
                    # (Mapping.cpp:160-167); init gates live -> synchronous
                    self._finalize_pending_kf()
                    t_kf = _time.perf_counter()
                    self._add_keyframe(shell, pyr, grads)
                    self.kf_latencies.append(_time.perf_counter() - t_kf)
                elif more > 0:
                    if more > 3:
                        self._catch_up = True
                    # dispatch the trace FIRST, then fold in a deferred KF
                    # finalization — its bundle pull overlaps this item's
                    # device work
                    self._process_non_kf(shell, pyr)
                    self._finalize_pending_kf()
                    if self._catch_up:
                        # drop every second frame while behind
                        # (Mapping.cpp:177-192)
                        extra = None
                        with self._qcond:
                            if self._queue:
                                extra = self._queue.popleft()
                        if extra is not None:
                            esh = extra[0]
                            with self._shell_lock:
                                if esh.tracking_ref is not None:
                                    esh.cam_to_world = (
                                        self.shells[esh.tracking_ref]
                                        .cam_to_world @ esh.cam_to_ref)
                            self.n_frames_skipped += 1
                else:
                    newest_sid = (self.kf_shell_ids[-1]
                                  if self.kf_shell_ids else -1)
                    if self._need_kf_after >= newest_sid:
                        # the KF host policy reads the previous bundle's
                        # mirrors — finalize it first
                        self._finalize_pending_kf()
                        t_kf = _time.perf_counter()
                        self._add_keyframe(shell, pyr, grads, defer=True)
                        self.kf_latencies.append(
                            _time.perf_counter() - t_kf)
                        self._catch_up = False
                    else:
                        self._process_non_kf(shell, pyr)
                        self._finalize_pending_kf()
            except BaseException as e:   # surfaced on the tracking thread
                self._map_exc = e
            finally:
                with self._qcond:
                    self._map_busy = False
                    self._qcond.notify_all()

    def finish(self, wait_lc: bool = True):
        """BlockUntilMappingIsFinished (Mapping.cpp:216-224): drain the
        mapping queue; with `wait_lc` (default) also the loop-closure
        worker, folding in any pending correction (the mapping thread is
        idle at the barrier, so applying here cannot race a kf_step).
        `wait_lc=False` leaves the LC worker free-running — loop closure
        is an asynchronous background service, not per-frame work, so
        steady-state throughput measurements should not block on it.
        No-op in sequential mode."""
        if self.sequential:
            return
        with self._qcond:
            while self._queue or self._map_busy:
                self._qcond.wait()
        # the mapping thread is parked: fold in a deferred KF finalization
        self._finalize_pending_kf()
        if wait_lc and self._lc_thread is not None:
            with self._lc_cond:
                while self._lc_queue or self._lc_busy:
                    self._lc_cond.wait()
            self._apply_pending_loop_corr()
        if self._map_exc is not None:
            exc, self._map_exc = self._map_exc, None
            if self._lc_exc is not None:   # both failed: chain them
                exc.__context__, self._lc_exc = self._lc_exc, None
            raise exc
        if self._lc_exc is not None:
            exc, self._lc_exc = self._lc_exc, None
            raise exc

    def close(self):
        """Stop the mapping + loop-closure threads (after finish()); flush
        metrics."""
        if self._metrics_f is not None:
            self._metrics_f.close()
            self._metrics_f = None
        # wind the background precompile thread down — a daemon thread
        # still inside an XLA call at interpreter exit aborts the process
        self._precompile_stop = True
        if self._precompile_thread is not None:
            self._precompile_thread.join(timeout=15)
        if self.sequential:
            return
        with self._qcond:
            self._map_stop = True
            self._qcond.notify_all()
        self._map_thread.join(timeout=30)
        if self._lc_thread is not None:
            with self._lc_cond:
                self._lc_stop = True
                self._lc_cond.notify_all()
            self._lc_thread.join(timeout=30)

    _MAP_MAX_PTS = 1024   # decimation cap per map record

    def _emit_map_record(self, b):
        """One "map" JSONL record per keyframe: decimated window point
        cloud (world space, filtered like Display.cpp:409-421) + the
        window keyframe poses for frusta — the live-3D-view feed
        (capability of GUI::UploadKeyFrame, Include/Display.h:126-141).
        Clouds of ALL window KFs ride every record, so BA pose/depth
        updates refresh previously-drawn keyframes (RefreshPC
        semantics, Display.cpp:382-441)."""
        xyz, ok, inten = jax.device_get(self._map_cloud(
            self.window.frames, self.window.points, self.calib.value))
        idx = np.flatnonzero(ok)
        if len(idx) > self._MAP_MAX_PTS:
            idx = idx[:: len(idx) // self._MAP_MAX_PTS + 1]
        pts = np.concatenate(
            [xyz[idx], np.clip(inten[idx], 0, 255)[:, None]], axis=1)
        valid = np.asarray(b.valid)
        kfs = []
        for s in range(self.cfg.max_frames):
            if not valid[s]:
                continue
            kfs.append({
                "kf": int(b.kf_id[s]),
                "R": [round(float(x), 5) for x in np.asarray(b.Rwc[s]).ravel()],
                "t": [round(float(x), 5) for x in np.asarray(b.twc[s])],
            })
        self._emit_metrics(
            t="map", kf_id=int(np.max(np.asarray(b.kf_id))),
            pts=[[round(float(c), 4) for c in p] for p in pts],
            kfs=kfs)

    def _emit_metrics(self, **fields):
        """One JSONL record on the structured metrics stream (no-op unless
        metrics_path was given)."""
        if self._metrics_f is None:
            return
        import json
        self._metrics_f.write(json.dumps(fields) + "\n")
        self._metrics_f.flush()

    # ------------------------------------------------------------ bootstrap
    def _try_initialize(self, shell: Shell, pyr, grads):
        cfg = self.cfg
        if self._init_first is None or self.init_failed:
            self.init_failed = False
            u, v, ptype, valid = self._select_px(
                self.selector_pot, pyr[0], grads, cfg.num_features, shell.id
            )
            self._init_first = dict(
                shell_id=shell.id,
                pyr=[p[..., 0] for p in pyr],
                dir0=pyr[0],
                grads=grads,
                u=u, v=v, valid=valid,
                fails=0,
            )
            return

        first = self._init_first
        ref_pyr = first["pyr"]
        tgt_pyr = [p[..., 0] for p in pyr]
        # KLT + flow statistics in ONE jitted dispatch (un-jitted, this
        # path compiles ~150 single-op executables per init attempt)
        pts, tracked, ok, n_ok_d, mean_flow_d = self._klt_flow(
            tuple(ref_pyr), tuple(tgt_pyr), first["u"], first["v"],
            first["valid"])
        n_ok = int(n_ok_d)
        if n_ok < self.cfg.init_min_matches:
            first["fails"] += 1
            if first["fails"] > 40:
                self._init_first = None
            return

        # stationarity check: mean flow (Initializer.cpp:117-118)
        if float(mean_flow_d) < 0.05 * (self.width + self.height) * 0.5 * 0.1:
            return  # not enough parallax yet

        K = np.array(
            [[float(self.calib.value[0]), 0, float(self.calib.value[2])],
             [0, float(self.calib.value[1]), float(self.calib.value[3])],
             [0, 0, 1.0]], dtype=np.float32,
        )
        res = self._two_view(
            pts, tracked, ok, jnp.asarray(K), jax.random.PRNGKey(shell.id),
        )
        if not bool(res.ok):
            first["fails"] += 1
            if first["fails"] > 40:
                self._init_first = None
            return

        # median-depth normalization to 1 (Initializer.cpp:142-148,1283-1297)
        z = np.asarray(res.points3d[:, 2])
        tri = np.asarray(res.tri_ok)
        med = np.median(z[tri]) if tri.sum() > 0 else 1.0
        scale = 1.0 / max(med, 1e-6)
        t_scaled = np.asarray(res.t) * scale   # firstToNew translation
        R12 = np.asarray(res.R)
        idepth = 1.0 / np.maximum(z * scale, 1e-4)
        cand_ok = tri & (idepth > 0)

        # DirectRefinement: joint photometric polish of pose + idepths with
        # the low-parallax regularizers (Initializer.cpp:1330-2314)
        if self.cfg.init_direct_refine:
            ref = self._init_refine(
                jnp.asarray(first["dir0"]), pyr[0],
                first["u"], first["v"], first["valid"],
                jnp.asarray(idepth, jnp.float32), jnp.asarray(tri),
                jnp.asarray(R12, jnp.float32),
                jnp.asarray(t_scaled, jnp.float32),
                self.calib.value,
            )
            R_h, t_h, id_h, good_h = jax.device_get(
                (ref.R, ref.t, ref.idepth, ref.good))
            if np.all(np.isfinite(t_h)) and np.all(np.isfinite(R_h)):
                R12, t_scaled = R_h.astype(np.float64), t_h.astype(np.float64)
                # refined idepths for triangulated survivors only (the
                # reference writes back videpth for Triangulated features,
                # Initializer.cpp:1393-1399)
                keep = tri & good_h & np.isfinite(id_h)
                idepth = np.where(keep, id_h, idepth)
                cand_ok = tri & good_h & (idepth > 0)

        self._setup_from_init(first, shell, pyr, grads, R12, t_scaled,
                              idepth, cand_ok)

    def _setup_from_init(self, first, shell, pyr, grads, R12, t12,
                         idepth, ok_mask):
        """InitFromInitializer (System.cpp:249-319) + forced first KFs.
        `idepth` (P,) and `ok_mask` (P,) describe the bootstrap points
        (triangulated inliers, photometrically refined when enabled)."""
        cfg = self.cfg

        # first frame shell (may not be shells[-2] if init took several tries)
        first_shell = self.shells[first["shell_id"]]
        first_shell.cam_to_world = np.eye(4)
        first_shell.is_kf = True
        first_shell.kf_id = 0
        self.next_kf_id = 1
        T12 = _se3_np(R12, t12)            # first -> new
        shell.cam_to_world = np.linalg.inv(T12)
        shell.tracking_ref = first_shell.id
        shell.cam_to_ref = shell.cam_to_world.copy()

        # --- KF0 into slot 0 with depth-prior'd active points + indirect
        # keypoint links — the whole numeric seeding is ONE jitted dispatch
        # (ns["_init_seed"]; System.cpp:249-319)
        img0 = first["dir0"]
        u = first["u"]
        v = first["v"]
        self.slot_shell[0] = first_shell.id
        self.kf_shell_ids.append(first_shell.id)

        if cfg.enable_indirect:
            ext = self._extract_feats(img0[..., 0])
        else:
            z1 = jnp.zeros(1, jnp.float32)
            ext = (z1, z1, jnp.zeros(1, jnp.int32), z1,
                   jnp.zeros((1, 8), jnp.uint32), jnp.zeros(1, bool))
        self.window, self.feats, n_pts0_d = self._init_seed(
            self.window, self.feats, img0, u, v, jnp.asarray(ok_mask),
            jnp.asarray(idepth, jnp.float32),
            jnp.float32(first_shell.exposure or 1.0), *ext)
        self.initialized = True
        self._init_first = None

        # seed the host policy mirrors for KF0 (one pull during init only)
        n_pts0 = int(n_pts0_d)
        self._m_valid[:] = False
        self._m_valid[0] = True
        self._m_kfid[:] = -1
        self._m_kfid[0] = 0
        self._m_t[:] = 0.0
        self._m_aff[:] = 0.0
        self._m_exp[:] = 1.0
        self._m_exp[0] = first_shell.exposure or 1.0
        self._m_nact_host[:] = 0
        self._m_nact_host[0] = n_pts0
        self._m_nimm_host[:] = 0
        self._m_n_active = n_pts0

        # the second frame becomes KF 1 through the normal path
        self._add_keyframe(shell, pyr, grads)

    # ------------------------------------------------------------- tracking
    MAX_HYP = 32   # fixed hypothesis batch (31 reference tries + identity pad)
    # mapping-queue depth beyond which the mapper fast-forwards to the
    # freshest frame (see _mapping_loop); the reference's catch-up keeps
    # up only when the mapper runs at >= half the input rate
    CATCHUP_DRAIN = 8
    # selector block sizes the pot adaptation may choose from — a fixed
    # ladder so every selector variant compiles once (a fresh pot value
    # mid-run would stall a keyframe for a full XLA compile)
    _POT_LADDER = (3, 4, 5, 6, 8)

    def _motion_hypotheses(self, anchor: Optional[int] = None):
        """Hypothesis list (System.cpp:347-405) + the initial affine guess.
        Shell poses are read under the shell lock (System.cpp:355-362).
        `anchor` is the id of the frame being tracked (defaults to the
        newest shell) — in pipelined mode later shells are still in flight
        and must not feed the motion model."""
        self._shell_lock.acquire()
        ref_shell = self.shells[self.ref_shell_id]
        if anchor is None:
            anchor = len(self.shells) - 1
        tries = []
        if anchor >= 2 and self.shells[anchor - 1].pose_valid:
            slast = self.shells[anchor - 1]
            sprelast = self.shells[anchor - 2]
            if slast.relocalized or not sprelast.pose_valid:
                # a relocalized (or recovered-from-invalid) pose is a jump,
                # not a velocity — assume the camera is momentarily still
                T_sp = np.eye(4)
            else:
                T_sp = (np.linalg.inv(sprelast.cam_to_world)
                        @ slast.cam_to_world)
                # scale the constant-motion twist by the timestamp-gap
                # ratio: under input skipping the velocity model must
                # cover the true (multi-period) motion (see
                # ops/tracker.motion_hypotheses_device)
                dt_prev = slast.timestamp - sprelast.timestamp
                dt_new = self.shells[anchor].timestamp - slast.timestamp
                if dt_prev > 1e-9 and dt_new > 0:
                    r = float(np.clip(dt_new / dt_prev, 0.1, 32.0))
                    if abs(r - 1.0) > 1e-6:
                        xi_sp = np.asarray(lie.se3_log(
                            jnp.asarray(T_sp[:3, :3]),
                            jnp.asarray(T_sp[:3, 3])))
                        T_sp = _se3_np(*[np.asarray(x) for x in
                                         lie.se3_exp(jnp.asarray(r * xi_sp))])
            T_ls = np.linalg.inv(slast.cam_to_world) @ ref_shell.cam_to_world
            fh2slast = T_sp  # constant motion assumption
            inv = np.linalg.inv
            tries.append(inv(fh2slast) @ T_ls)
            tries.append(inv(fh2slast) @ inv(fh2slast) @ T_ls)
            half = _se3_np(*[np.asarray(x) for x in lie.se3_exp(
                jnp.asarray(0.5 * np.asarray(lie.se3_log(
                    jnp.asarray(fh2slast[:3, :3]), jnp.asarray(fh2slast[:3, 3])
                ))))])
            tries.append(inv(half) @ T_ls)
            tries.append(T_ls)
            tries.append(np.eye(4))
            rot = 0.02
            base = inv(fh2slast) @ T_ls
            for ax in [(rot, 0, 0), (0, rot, 0), (0, 0, rot),
                       (-rot, 0, 0), (0, -rot, 0), (0, 0, -rot),
                       (rot, rot, 0), (0, rot, rot), (rot, 0, rot),
                       (-rot, rot, 0), (0, -rot, rot), (-rot, 0, rot),
                       (rot, -rot, 0), (0, rot, -rot), (rot, 0, -rot),
                       (-rot, -rot, 0), (0, -rot, -rot), (-rot, 0, -rot),
                       (-rot, -rot, -rot), (-rot, -rot, rot), (-rot, rot, -rot),
                       (-rot, rot, rot), (rot, -rot, -rot), (rot, -rot, rot),
                       (rot, rot, -rot), (rot, rot, rot)]:
                pert = np.eye(4)
                q = np.array([1.0, *ax])
                q /= np.linalg.norm(q)
                pert[:3, :3] = np.asarray(
                    lie.quat_to_rot(jnp.asarray([q[1], q[2], q[3], q[0]]))
                )
                tries.append(base @ pert)
            aff_init = self.shells[anchor - 1].aff.copy()
        else:
            tries.append(np.eye(4))
            aff_init = np.zeros(2)
        self._shell_lock.release()
        return tries, aff_init

    def _track_new_coarse(self, shell: Shell, pyr) -> bool:
        """trackNewCoarse (System.cpp:333-500). Default path: all motion
        hypotheses scored at the coarsest level in ONE batched dispatch,
        argmin refined coarse-to-fine in the same call
        (ops/tracker.track_coarse_multi); the reference's serial try-loop
        with achievedRes early-exit remains as the fallback when the
        batched winner is rejected."""
        cfg = self.cfg
        tries, aff_init = self._motion_hypotheses()

        K_pyr = self._K_pyr_cache

        # --- batched path: one dispatch, one host pull
        n = min(len(tries), self.MAX_HYP)
        T_all = np.stack(tries[:n] + [tries[0]] * (self.MAX_HYP - n))
        res, _best_idx = self._track_multi(
            self.template, pyr, K_pyr,
            jnp.asarray(T_all[:, :3, :3], jnp.float32),
            jnp.asarray(T_all[:, :3, 3], jnp.float32),
            jnp.asarray(aff_init, jnp.float32),
            jnp.float32(self.ref_exposure), jnp.float32(shell.exposure),
            jnp.asarray(self.ref_aff, jnp.float32),
        )
        R_h, t_h, aff_h, ok_h, res_h, flow_h = jax.device_get(
            (res.R, res.t, res.aff, res.ok, res.residuals, res.flow))
        if bool(ok_h) and np.isfinite(res_h[0]):
            self.last_coarse_rmse = np.where(
                np.isnan(res_h), 100.0, np.minimum(res_h, 1e9))
            if self.first_coarse_rmse < 0:
                self.first_coarse_rmse = float(res_h[0])
            T_best = _se3_np(R_h, t_h)
            shell.cam_to_ref = np.linalg.inv(T_best)
            shell.tracking_ref = self.ref_shell_id
            shell.cam_to_world = (
                self.shells[self.ref_shell_id].cam_to_world @ shell.cam_to_ref
            )
            shell.aff = np.asarray(aff_h, np.float64)
            self._last_flow = np.asarray(flow_h)
            return bool(np.all(np.isfinite(t_h)))
        return self._track_serial(shell, pyr, tries, aff_init, K_pyr)

    def _track_serial(self, shell: Shell, pyr, tries, aff_init, K_pyr) -> bool:
        """Fallback: the reference's serial try-loop with achievedRes
        early-exit (System.cpp:428-481), then relocalization."""
        cfg = self.cfg
        achieved = np.full(cfg.pyr_levels, np.nan)
        best = None
        have_good = False

        for i, T in enumerate(tries):
            min_abort = jnp.asarray(
                np.where(np.isnan(achieved), np.inf, achieved), jnp.float32
            )
            res = self._track(
                self.template, pyr, K_pyr,
                jnp.asarray(T[:3, :3], jnp.float32),
                jnp.asarray(T[:3, 3], jnp.float32),
                jnp.asarray(aff_init, jnp.float32),
                jnp.float32(self.ref_exposure), jnp.float32(shell.exposure),
                jnp.asarray(self.ref_aff, jnp.float32),
                min_res_for_abort=min_abort,
            )
            r = np.asarray(res.residuals)
            ok = bool(res.ok) and np.isfinite(r[0])
            if ok and (best is None or r[0] < achieved[0] or np.isnan(achieved[0])):
                best = res
                have_good = True
            if have_good:
                cur = np.asarray(best.residuals) if best is res else r
                upd = np.isnan(achieved) | (achieved > r)
                achieved = np.where(upd & np.isfinite(r), r, achieved)
            if have_good and achieved[0] < self.last_coarse_rmse[0] * self.cfg.re_track_threshold:
                break

        if not have_good:
            # first try BoW+PnP relocalization against the reference KF's
            # template (capability beyond the reference, whose only recovery
            # is "take predicted pose and hope", System.cpp:483-489)
            reloc = self._attempt_relocalization(shell, pyr)
            if reloc is not None:
                self.n_relocs += 1
                shell.relocalized = True
                shell.cam_to_world = reloc
                shell.tracking_ref = self.ref_shell_id
                shell.cam_to_ref = (
                    np.linalg.inv(self.shells[self.ref_shell_id].cam_to_world)
                    @ shell.cam_to_world
                )
                shell.aff = aff_init
                self._last_flow = np.zeros(3)
                return True
            shell.pose_valid = False
            T = tries[0]
            shell.cam_to_ref = np.linalg.inv(T)
            shell.tracking_ref = self.ref_shell_id
            shell.cam_to_world = self.shells[self.ref_shell_id].cam_to_world @ shell.cam_to_ref
            shell.aff = aff_init
            self._last_flow = np.zeros(3)
            return True   # reference hopes to recover; not lost unless NaN

        self.last_coarse_rmse = np.where(
            np.isnan(achieved), 100.0, np.minimum(achieved, 1e9)
        )
        if self.first_coarse_rmse < 0:
            self.first_coarse_rmse = float(achieved[0])

        T_best = _se3_np(np.asarray(best.R), np.asarray(best.t))
        shell.cam_to_ref = np.linalg.inv(T_best)
        shell.tracking_ref = self.ref_shell_id
        shell.cam_to_world = (
            self.shells[self.ref_shell_id].cam_to_world @ shell.cam_to_ref
        )
        shell.aff = np.asarray(best.aff)
        self._last_flow = np.asarray(best.flow)
        return np.all(np.isfinite(np.asarray(best.t)))

    def _lift_keypoint_depths(self, u, v, radius_px: float = 3.0):
        """Nearest-template-point inverse depth for keypoints, computed on
        device (one small dispatch; no O(K*T) host matrix). Uses the mapping
        thread's newest template (the one just built for the current KF),
        falling back to the tracking reference."""
        tpl = getattr(self, "_newest_template", None) or self.template
        if tpl is None:
            n = np.asarray(u).shape[0]
            return np.zeros(n, np.float32), np.zeros(n, bool)
        tid, dmin = self._lift_depths(
            jnp.asarray(u), jnp.asarray(v),
            tpl.u[0], tpl.v[0], tpl.idepth[0], tpl.valid[0])
        dmin = np.asarray(dmin)
        return (np.asarray(tid, np.float32),
                dmin <= radius_px * radius_px)

    def _attempt_relocalization(self, shell: Shell, pyr):
        """KLT-free pose recovery: match FAST+rBRIEF descriptors of the
        current frame against the reference keyframe, lift the KF keypoints
        to 3D via the tracker template's inverse depths, and solve PnP
        RANSAC. Returns cam_to_world (4, 4) or None."""
        if self.template is None or self.ref_slot < 0:
            return None
        from ..ops import pnp as pnp_ops

        cur_img = pyr[0][..., 0]
        if self.cfg.enable_indirect:
            # hybrid layer: the reference KF's multi-scale features are
            # already stored (extracted once in kf_step); extract the
            # current frame's and match. Gates are looser than the window
            # matcher's — PnP RANSAC downstream rejects false matches.
            from ..ops import features as ft
            ku = self.feats.u[self.ref_slot]
            kv = self.feats.v[self.ref_slot]
            kval = self.feats.valid[self.ref_slot]
            kdesc = self.feats.desc[self.ref_slot]
            cu, cv, _, _, cdesc, cval = self._extract_feats(cur_img)
            idx, ok = ft.match_pair_jit(kdesc, kval, cdesc, cval,
                                        max_dist=80, ratio=0.9)
        else:
            from ..ops import orb as orb_ops
            from ..ops.pyramid import gaussian_blur7

            ref_img = np.asarray(
                self.window.frames.images[self.ref_slot][..., 0])

            def feats(img):
                score = orb_ops.fast_score(img, float(self.cfg.min_th_fast))
                u, v, valid = orb_ops.grid_nms(score, 8, 512)
                ang = orb_ops.ic_angle(img, u, v)
                return u, v, valid, orb_ops.rbrief(
                    gaussian_blur7(img), u, v, ang)

            ku, kv, kval, kdesc = feats(jnp.asarray(ref_img))
            cu, cv, cval, cdesc = feats(cur_img)
            idx, ok = orb_ops.match_descriptors_jit(kdesc, cdesc,
                                                    valid_a=kval,
                                                    valid_b=cval)
        if int(np.asarray(ok).sum()) < 15:
            return None

        # lift ref keypoints to 3D via nearest template point (<= 3 px),
        # on device (no host distance matrix)
        tpl = self.template
        tid_d, dmin_d = self._lift_depths(
            jnp.asarray(ku), jnp.asarray(kv),
            tpl.u[0], tpl.v[0], tpl.idepth[0], tpl.valid[0])
        ku_np, kv_np = np.asarray(ku), np.asarray(kv)
        has_depth = np.asarray(dmin_d) <= 9.0
        idepth = np.asarray(tid_d)

        fx, fy = float(self.calib.value[0]), float(self.calib.value[1])
        cx, cy = float(self.calib.value[2]), float(self.calib.value[3])
        z = 1.0 / np.maximum(idepth, 1e-6)
        X_cam = np.stack(
            [(ku_np - cx) / fx * z, (kv_np - cy) / fy * z, z], -1
        )
        # to world via the ref KF pose
        T_ref = self.shells[self.ref_shell_id].cam_to_world
        X_w = X_cam @ T_ref[:3, :3].T + T_ref[:3, 3]

        cu_np, cv_np = np.asarray(cu), np.asarray(cv)
        obs = np.stack([cu_np[np.asarray(idx)], cv_np[np.asarray(idx)]], -1)
        valid = np.asarray(ok) & has_depth
        if valid.sum() < 15:
            return None

        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]], np.float32)
        # seed with the last tracked pose prediction (zero motion from the
        # reference) — the DLT samples alone degenerate on planar scenes
        T_pred = np.linalg.inv(T_ref)
        res = pnp_ops.solve_pnp_jit(
            jnp.asarray(X_w, jnp.float32), jnp.asarray(obs, jnp.float32),
            jnp.asarray(valid), jnp.asarray(K),
            jax.random.PRNGKey(shell.id),
            init_R=jnp.asarray(T_pred[:3, :3], jnp.float32),
            init_t=jnp.asarray(T_pred[:3, 3], jnp.float32),
        )
        if not bool(res.ok):
            return None
        Twc = np.eye(4)
        Twc[:3, :3] = np.asarray(res.R)
        Twc[:3, 3] = np.asarray(res.t)
        return np.linalg.inv(Twc)

    def _need_keyframe(self, shell: Shell) -> bool:
        cfg = self.cfg
        if shell.relocalized:
            # re-anchor the map at the recovered pose/appearance immediately:
            # direct tracking against the pre-loss reference keeps failing if
            # the loss was caused by an appearance change (the flow/affine
            # indicators below can't see it — reloc bypasses the tracker)
            return True
        flow = self._last_flow
        a_rel = np.exp(shell.aff[0] - self.ref_aff[0]) * (
            shell.exposure / max(self.ref_exposure, 1e-6)
        )
        wh = self.width + self.height
        metric = (
            cfg.kf_global_weight * cfg.kf_weight_shift_t * np.sqrt(max(flow[0], 0)) / wh
            + cfg.kf_global_weight * cfg.kf_weight_shift_r * np.sqrt(max(flow[1], 0)) / wh
            + cfg.kf_global_weight * cfg.kf_weight_shift_rt * np.sqrt(max(flow[2], 0)) / wh
            + cfg.kf_global_weight * cfg.max_affine_weight * abs(np.log(max(a_rel, 1e-6)))
        )
        return bool(
            metric > 1
            or 2 * self.first_coarse_rmse < self.last_coarse_rmse[0]
        )

    # ------------------------------------------------------------- non-KF
    def _process_non_kf(self, shell: Shell, pyr):
        """ProcessNonKeyframe (System.cpp:231-247): epipolar-trace all
        candidates against this frame — ONE fused dispatch, zero pulls.

        The pose is RECOMPUTED from the tracking reference at mapping time
        under the shell lock (System.cpp:234-238): windowed BA may have
        refined the reference keyframe's pose since this frame was tracked,
        and tracing with the stale tracking-time pose would misplace the
        epipolar search lines by the BA update."""
        with self._shell_lock:
            if shell.tracking_ref is not None:
                shell.cam_to_world = (
                    self.shells[shell.tracking_ref].cam_to_world
                    @ shell.cam_to_ref)
        Tw = np.linalg.inv(shell.cam_to_world)
        self.imm = self._trace_step(
            self.imm, self.window.frames, self.calib.value,
            jnp.asarray(Tw[:3, :3], jnp.float32),
            jnp.asarray(Tw[:3, 3], jnp.float32),
            jnp.asarray(shell.aff, jnp.float32),
            jnp.float32(shell.exposure or 1.0),
            pyr[0],
        )

    # ------------------------------------------------------------- keyframe
    def _add_keyframe(self, shell: Shell, pyr, grads, defer: bool = False):
        """AddKeyframe (Mapping.cpp:12-142): host policy runs on mirrors of
        the previous keyframe's bundle (zero device touches), then the whole
        device pipeline (trace, insert, activation, BA, outlier removal,
        template, point+frame marginalization, new traces) is ONE kf_step
        dispatch followed by ONE small async-staged bundle pull.

        `defer=True` (mapping thread, post-init): the tracker reference is
        published IMMEDIATELY after the dispatch (the template leaves are
        device futures the tracker consumes as they materialize) and the
        bundle-dependent finalization is left pending — the mapping loop
        folds it in around its next item, overlapping the kf_step's device
        execution the pull would otherwise block on. Time-to-fresh-template
        drops to the dispatch latency."""
        cfg = self.cfg
        F = cfg.max_frames
        shell.is_kf = True
        shell.kf_id = self.next_kf_id
        self.next_kf_id += 1
        if shell.tracking_ref is not None:
            # final pose from the (possibly BA-updated) tracking ref,
            # under the shell lock (Mapping.cpp:14-21)
            with self._shell_lock:
                shell.cam_to_world = (
                    self.shells[shell.tracking_ref].cam_to_world
                    @ shell.cam_to_ref
                )

        # first online-calibration fit landed since the last keyframe:
        # re-correct the stored window images + candidate/point colors
        # (this thread owns the window here; see _photo_calib_step)
        if self._pc_window_resync:
            self._pc_window_resync = False
            imgs2, imm_c2, pts_c2 = self._pc_resync_state(
                self.window.frames.images, self.imm.color, self.imm.u,
                self.imm.v, self.window.points.color, self.window.points.u,
                self.window.points.v, self._inv_response,
                self._inv_vignette)
            self.window = self.window._replace(
                frames=self.window.frames._replace(images=imgs2),
                points=self.window.points._replace(color=pts_c2))
            self.imm = self.imm._replace(color=imm_c2)

        # --- host policy (flagFramesForMarginalization + density feedback)
        flagged = self._flag_frames_for_marg(shell)
        flag_mask = np.zeros(F, bool)
        flag_mask[flagged] = True

        free = np.flatnonzero(~self._m_valid)
        assert free.size > 0, "window full"
        slot = int(free[0])

        self._adapt_act_dist()
        n_valid_now = int(self._m_valid.sum()) + 1
        iters = cfg.max_opt_iterations
        if n_valid_now < 3:
            iters = 20
        elif n_valid_now < 4:
            iters = 15

        # --- selector dispatch (separately compiled per ladder pot)
        import os as _os
        _timing = _os.environ.get("HSLAM_KF_TIMING")
        _t0 = _time.perf_counter()
        sel_u, sel_v, sel_type, sel_valid = self._select_px(
            self.selector_pot, pyr[0], grads,
            int(cfg.desired_immature_density), shell.id)
        _t1 = _time.perf_counter()

        # indirect-weight schedule: lean on the geometric terms (up to 3x)
        # when the photometric tracker runs worse than its own baseline on
        # the current reference (see indirect_associate)
        if cfg.indirect_weight_schedule and self.first_coarse_rmse > 0:
            iw_scale = float(np.clip(
                self.last_coarse_rmse[0] / max(self.first_coarse_rmse, 1e-6),
                1.0, 3.0))
        else:
            iw_scale = 1.0

        Twc = np.linalg.inv(shell.cam_to_world)
        window, calib, imm, feats, template, result, bundle = self._kf_step(
            self.window, self.calib, self.imm, self.feats, tuple(pyr),
            jnp.asarray(Twc[:3, :3], jnp.float32),
            jnp.asarray(Twc[:3, 3], jnp.float32),
            jnp.asarray(shell.aff, jnp.float32),
            jnp.float32(shell.exposure or 1.0),
            jnp.int32(slot), jnp.int32(shell.kf_id), jnp.int32(self.ref_slot),
            jnp.asarray(flag_mask),
            jnp.float32(self.current_min_act_dist), jnp.int32(iters),
            sel_u, sel_v, sel_type, sel_valid,
            ind_w_scale=jnp.float32(iw_scale),
        )
        _t2 = _time.perf_counter()
        self.window, self.calib, self.imm = window, calib, imm
        self.feats = feats
        self._K_pyr_cache = self._k_pyr(self.calib.value)
        self.slot_shell[slot] = shell.id
        self.kf_shell_ids.append(shell.id)

        # start the device->host copy of the policy bundle immediately
        _copy_to_host_async(bundle)

        # publish the tracker reference NOW (coarseTracker_forNewKF double
        # buffer, System.cpp:127-133, Mapping.cpp:93-100): the template
        # arrays are futures of the dispatch above — the tracker blocks on
        # them only when it actually warps, so freshness costs dispatch
        # latency, not the full keyframe finalization. The BA-refined
        # affine rides the bundle; until finalize the tracked (pre-BA)
        # affine stands in (refreshed in _finalize_kf).
        self._newest_template = template
        ref = (template, slot, shell.id,
               np.asarray(shell.aff, np.float64).copy(),
               shell.exposure or 1.0)
        if self.sequential:
            (self.template, self.ref_slot, self.ref_shell_id,
             self.ref_aff, self.ref_exposure) = ref
            self.first_coarse_rmse = -1.0
        else:
            with self._ref_lock:
                self._pending_ref = ref

        pending = (shell, slot, flag_mask, bundle, template, pyr,
                   _t0, _t1, _t2, _timing)
        if defer and self.next_kf_id > 4:
            # init gates are closed: finalization may ride the next item
            self._pending_kf_final = pending
        else:
            self._finalize_kf(pending)

    def _finalize_pending_kf(self):
        if self._pending_kf_final is not None:
            pending, self._pending_kf_final = self._pending_kf_final, None
            self._finalize_kf(pending)

    def _finalize_kf(self, pending):
        """Bundle-dependent keyframe finalization: the ONE policy pull,
        init/lost gates, shell pose publication, policy mirrors,
        connectivity, selector adaptation, loop-closure hand-off."""
        cfg = self.cfg
        F = cfg.max_frames
        (shell, slot, flag_mask, bundle, template, pyr,
         _t0, _t1, _t2, _timing) = pending
        b = jax.device_get(bundle)
        rmse = float(b.rmse)
        if _timing:
            import sys as _sys
            _sys.stderr.write(
                f"[kf {shell.kf_id}] sel {1e3*(_t1-_t0):.0f}ms "
                f"dispatch {1e3*(_t2-_t1):.0f}ms "
                f"pull {1e3*(_time.perf_counter()-_t2):.0f}ms pot {self.selector_pot}\n")

        # init-failure gates (Mapping.cpp:68-85)
        nkf = self.next_kf_id
        if ((nkf == 2 and rmse > 20 * cfg.init_slack_factor)
                or (nkf == 3 and rmse > 13 * cfg.init_slack_factor)
                or (nkf == 4 and rmse > 9 * cfg.init_slack_factor)):
            self.init_failed = True
            self._reset()
            return
        if not np.isfinite(rmse):
            self.is_lost = True
            return

        # publish optimized poses to shells (FullSystemOptimize.cpp:530-537),
        # including frames marginalized this step (pre-marg poses survive in
        # the state arrays; only the valid flag is cleared)
        published = b.valid | flag_mask
        with self._shell_lock:
            for s in range(F):
                if not published[s] or self.slot_shell[s] is None:
                    continue
                sh = self.shells[self.slot_shell[s]]
                sh.cam_to_world = np.linalg.inv(_se3_np(b.Rwc[s], b.twc[s]))
                sh.aff = np.asarray(b.aff[s], np.float64).copy()

        # refresh the policy mirrors + marginalization bookkeeping
        self._m_valid = np.asarray(b.valid).copy()
        self._m_kfid = np.asarray(b.kf_id, np.int64)
        self._m_t = np.asarray(b.twc, np.float64)
        self._m_aff = np.asarray(b.aff, np.float64)
        self._m_exp = np.asarray(b.exposure, np.float64)
        self._m_nact_host = np.asarray(b.n_active_host, np.int64)
        self._m_nimm_host = np.asarray(b.n_imm_host, np.int64)
        self._m_n_active = int(b.n_active)
        self.ind_obs_history.append(int(b.n_ind))
        self.kf_full_latencies.append(_time.perf_counter() - _t0)
        self._emit_metrics(
            t="kf", id=shell.id, kf_id=shell.kf_id,
            ba_rmse=float(b.rmse), n_active=int(b.n_active),
            n_ind=int(b.n_ind), n_marg_frames=int(flag_mask.sum()),
            latency_ms=round(1e3 * (_time.perf_counter() - _t0), 2))
        if self._metrics_f is not None:
            self._emit_map_record(b)
        for s in range(F):
            if flag_mask[s]:
                self.slot_shell[s] = None
                self._marg_counts[s] = 0     # slot reused by a new KF
            elif int(b.removed_host[s]):
                self._marg_counts[s] = (self._marg_counts.get(s, 0)
                                        + int(b.removed_host[s]))

        # connectivity map from the device tallies (EnergyFunctional.h:83,
        # insertResidual/marginalizePointsF tallies :377,406-408,566)
        kf_of = np.asarray(b.kf_id)
        ca = np.asarray(b.conn_active)
        cm = np.asarray(b.conn_marg)
        for h_ in range(F):
            for t_ in range(F):
                if h_ == t_:
                    continue
                if ca[h_, t_] > 0:
                    key = (int(kf_of[h_]), int(kf_of[t_]))
                    self.connectivity.setdefault(key, [0, 0])[0] = int(ca[h_, t_])
                if cm[h_, t_] > 0:
                    key = (int(kf_of[h_]), int(kf_of[t_]))
                    self.connectivity.setdefault(key, [0, 0])[1] += int(cm[h_, t_])

        # selector density adaptation across keyframes (sqrt rule of
        # PixelSelector.cpp:118-267, applied cross-frame; pot snapped to the
        # compiled ladder so no new selector variant compiles mid-run)
        if not cfg.use_fast:
            have = max(int(b.sel_count), 1)
            want = cfg.desired_immature_density
            ideal = self.selector_pot * np.sqrt(have / want)
            self.selector_pot = min(self._POT_LADDER,
                                    key=lambda p: abs(p - ideal))

        # refresh the (already published) tracker reference's affine with
        # the BA-refined value — the dispatch-time publish used the
        # tracked affine
        aff_ba = np.asarray(b.aff[slot], np.float64).copy()
        with self._ref_lock:
            if (self._pending_ref is not None
                    and self._pending_ref[2] == shell.id):
                pr = self._pending_ref
                self._pending_ref = (pr[0], pr[1], pr[2], aff_ba, pr[4])
            elif self.ref_shell_id == shell.id:
                self.ref_aff = aff_ba

        # hybrid indirect layer: descriptors + loop closure (optional;
        # the reference links DBoW3/g2o but never exercises them — this is
        # the declared-capability integration, "full hybrid mode")
        if self.enable_loop_closure:
            self._loop_closure_step(slot, shell, pyr, b)

    def _adapt_act_dist(self):
        """Density feedback on currentMinActDist (Mapping.cpp:332-351),
        driven by the mirrored active-point count."""
        n_active = self._m_n_active
        target = self.cfg.desired_point_density
        d = self.current_min_act_dist
        if n_active < target * 0.66:
            d -= 0.8
        if n_active < target * 0.8:
            d -= 0.5
        elif n_active < target * 0.9:
            d -= 0.2
        elif n_active < target:
            d -= 0.1
        if n_active > target * 1.5:
            d += 0.8
        if n_active > target * 1.3:
            d += 0.5
        elif n_active > target * 1.15:
            d += 0.2
        elif n_active > target:
            d += 0.1
        self.current_min_act_dist = float(np.clip(d, 0.0, 4.0))

    # ---------------------------------------------------- loop closure
    def _loop_closure_step(self, slot: int, shell: Shell, pyr, bundle=None):
        """Per-keyframe loop-closure hook. Gathers the (cheap, device-side)
        inputs — descriptors + keypoint depth lift — then runs the heavy
        BoW/PnP/pose-graph work inline (sequential mode) or hands it to the
        dedicated low-priority loop-closure worker (async mode), keeping
        BoW scoring, matching, PnP RANSAC and the pose-graph relax off the
        mapping thread's per-KF latency budget (the reference runs them
        nowhere — this is the declared-capability integration)."""
        if self.cfg.enable_indirect:
            # consume the keyframe's stored multi-scale features (extracted
            # once in kf_step) — small device-side slices
            u = self.feats.u[slot]
            v = self.feats.v[slot]
            valid = self.feats.valid[slot]
            desc = self.feats.desc[slot]
        else:
            from ..ops import orb as orb_ops
            from ..ops.pyramid import gaussian_blur7
            img = pyr[0][..., 0]
            score = orb_ops.fast_score(img, float(self.cfg.min_th_fast))
            u, v, valid = orb_ops.grid_nms(score, 8, 512)
            ang = orb_ops.ic_angle(img, u, v)
            desc = orb_ops.rbrief(gaussian_blur7(img), u, v, ang)

        # keypoint inverse depths (feeds the PnP loop-edge estimation):
        # already computed inside the kf_step dispatch and pulled with the
        # policy bundle — zero extra device round-trips on the KF path
        if bundle is not None and self.cfg.enable_indirect:
            kp_idepth = np.asarray(bundle.kp_idepth, np.float32)
            kp_depth_ok = np.asarray(bundle.kp_depth_ok)
        else:
            kp_idepth, kp_depth_ok = self._lift_keypoint_depths(u, v)
        entry = (shell.kf_id, shell.id, desc, u, v, valid,
                 shell.cam_to_world.copy(), kp_idepth, kp_depth_ok)
        exclude = self._connected_kf_ids(shell.kf_id)

        if self.sequential or self._lc_thread is None:
            corr = self._lc_process(entry, exclude)
            if corr is not None:
                self._apply_loop_correction(corr)
        else:
            with self._lc_cond:
                self._lc_queue.append((entry, exclude))
                self._lc_cond.notify_all()

    def _lc_process(self, entry, exclude_kfs):
        """Vocabulary bootstrap + BoW detect + pose-graph correct for one
        keyframe entry. Returns the correction dict {shell_id: c2w} or
        None. Runs on the mapping thread (sequential) or the LC worker."""
        from ..ops import bow as bow_ops
        from .loop_closure import LoopCloser

        kf_id, sid, desc, u, v, valid, c2w, kp_idepth, kp_depth_ok = entry
        if self.loop_closer is None:
            self._vocab_descs.append(np.asarray(desc)[np.asarray(valid)])
            self._pending_entries.append(entry)
            if len(self._vocab_descs) >= 8:
                pool = np.concatenate(self._vocab_descs)
                doc_ids = np.concatenate([
                    np.full(len(d), i, np.int32)
                    for i, d in enumerate(self._vocab_descs)])
                voc = bow_ops.train_vocabulary(pool, k=8, levels=3, iters=4,
                                               doc_ids=doc_ids)
                self.loop_closer = LoopCloser(voc, min_gap=10,
                                              dist_mesh=self.dist_mesh,
                                              min_loop_error_rel=1.0,
                                              consistency_th=2)
                # backfill the keyframes that fed the vocabulary — without
                # them the revisit has nothing to match against
                for e in self._pending_entries:
                    self.loop_closer.add_keyframe(
                        e[0], e[1], e[2], e[3], e[4], e[5], e[6],
                        kp_idepth=e[7], kp_depth_ok=e[8],
                    )
                self._pending_entries = []
            return None

        self.loop_closer.add_keyframe(
            kf_id, sid, desc, u, v, valid, c2w,
            kp_idepth=kp_idepth, kp_depth_ok=kp_depth_ok,
        )
        K = np.array(
            [[float(self.calib.value[0]), 0, float(self.calib.value[2])],
             [0, float(self.calib.value[1]), float(self.calib.value[3])],
             [0, 0, 1.0]])
        _t_lc = _time.perf_counter()
        loop = self.loop_closer.detect(
            len(self.loop_closer.entries) - 1, K, exclude_kfs=exclude_kfs,
        )
        self.lc_detect_ms.append(1e3 * (_time.perf_counter() - _t_lc))
        if loop is None:
            return None
        corrections = self.loop_closer.correct(loop, fix_scale=False)
        if not corrections:
            return None    # relaxation rejected (divergence gate)
        self.n_loops_closed += 1
        return dict(corrections)

    def _lc_loop(self):
        """Loop-closure worker (async mode): consumes keyframe entries,
        computes corrections, and leaves them in _pending_loop_corr for the
        MAPPING thread to apply between keyframe steps — window/evalPT
        mutation must never race a kf_step dispatch."""
        while True:
            with self._lc_cond:
                while not self._lc_queue and not self._lc_stop:
                    self._lc_cond.wait()
                if self._lc_stop and not self._lc_queue:
                    return
                entry, exclude = self._lc_queue.popleft()
                self._lc_busy = True
            try:
                corr = self._lc_process(entry, exclude)
                if corr is not None:
                    with self._lc_corr_lock:
                        # merge over an unapplied older correction: the new
                        # relaxation already includes its effect (entry
                        # poses were updated by correct())
                        self._pending_loop_corr = corr
            except BaseException as e:   # surfaced at the finish barrier
                self._lc_exc = e
            finally:
                with self._lc_cond:
                    self._lc_busy = False
                    self._lc_cond.notify_all()

    def _apply_pending_loop_corr(self):
        """Called on the mapping thread (or at finish barriers) to fold in
        a worker-computed correction."""
        with self._lc_corr_lock:
            corr, self._pending_loop_corr = self._pending_loop_corr, None
        if corr is not None:
            self._apply_loop_correction(corr)

    def _apply_loop_correction(self, by_shell: dict):
        """Re-anchor trajectory + window after a pose-graph correction.

        The active window gets ONE common gauge transform G — the newest
        window keyframe's correction — applied to every window frame:
        c2w' = G @ c2w, i.e. worldToCam' = worldToCam @ G^-1. A common
        right-composition leaves every relative pose (and the idepths)
        untouched, so the photometric residuals AND the marginalization
        prior HM/bM stay exactly consistent; the absolute shift lives in
        the gauge nullspace the solver orthogonalizes anyway. (Per-KF
        corrections inside the window would move the evalPTs relative to
        each other and silently invalidate HM/bM.)"""
        frames = self.window.frames
        valid_np = np.asarray(frames.valid)
        win_sids = {
            self.slot_shell[s]
            for s in range(self.cfg.max_frames)
            if valid_np[s] and self.slot_shell[s] is not None
        }
        anchor_sid = None
        for sid in sorted(win_sids, reverse=True):
            if sid in by_shell:
                anchor_sid = sid
                break
        if anchor_sid is not None:
            G = by_shell[anchor_sid] @ np.linalg.inv(
                self.shells[anchor_sid].cam_to_world)
        else:
            G = np.eye(4)
        G_inv = np.linalg.inv(G)
        Rg = jnp.asarray(G_inv[:3, :3], jnp.float32)
        tg = jnp.asarray(G_inv[:3, 3], jnp.float32)

        corrected = set()
        for sh in self.shells:
            if sh.id in win_sids:
                sh.cam_to_world = G @ sh.cam_to_world
                corrected.add(sh.id)
            elif sh.id in by_shell:
                sh.cam_to_world = by_shell[sh.id]
                corrected.add(sh.id)
        # non-keyframe shells ride their tracking reference through the
        # correction (cam_to_world = ref_c2w @ cam_to_ref, Frame.h:75-114)
        ref_c2w = {sh.id: sh.cam_to_world for sh in self.shells
                   if sh.id in corrected}
        for sh in self.shells:
            if sh.id not in corrected and sh.tracking_ref in ref_c2w:
                sh.cam_to_world = ref_c2w[sh.tracking_ref] @ sh.cam_to_ref

        # evalPT' = evalPT @ G^-1, batched over valid slots; the per-frame
        # state deltas are relative to evalPT and stay valid
        m = frames.valid[:, None, None]
        new_R = jnp.einsum("fij,jk->fik", frames.evalpt_R, Rg)
        new_t = (jnp.einsum("fij,j->fi", frames.evalpt_R, tg)
                 + frames.evalpt_t)
        frames = frames._replace(
            evalpt_R=jnp.where(m, new_R, frames.evalpt_R),
            evalpt_t=jnp.where(m[:, :, 0], new_t, frames.evalpt_t),
        )
        self.window = self.window._replace(frames=frames)

    # ------------------------------------------------------- KF sub-steps
    def _flag_frames_for_marg(self, new_shell: Shell) -> List[int]:
        """flagFramesForMarginalization (FullSystemMarginalize.cpp:18-103),
        computed purely from the host mirrors of the previous bundle."""
        cfg = self.cfg
        valid = self._m_valid
        slots = [s for s in range(cfg.max_frames) if valid[s]]
        kf_ids = self._m_kfid
        aff = self._m_aff
        exposure = self._m_exp

        flagged: List[int] = []
        newest_aff = new_shell.aff
        newest_exp = new_shell.exposure or 1.0
        for s in slots:
            n_in = int(self._m_nact_host[s] + self._m_nimm_host[s])
            n_out = int(self._marg_counts.get(s, 0))
            e = exposure[s] if exposure[s] else 1.0
            a_rel = np.exp(aff[s, 0] - newest_aff[0]) * (e / newest_exp)
            if (
                (n_in < cfg.min_points_remaining * max(n_in + n_out, 1)
                 or abs(np.log(max(a_rel, 1e-12))) > cfg.max_log_aff_fac_in_window)
                and (len(slots) - len(flagged) > cfg.min_frames)
            ):
                flagged.append(s)

        # distance-score: keep window <= max frames, flagging repeatedly
        # until the post-insertion window fits the slot capacity
        # (reference checks the pre-insertion count, FullSystemMarginalize.cpp:70;
        # the loop guard also covers async KF bursts where several keyframes
        # are inserted before the tracker reference catches up)
        cap = min(cfg.max_kf_frames, cfg.max_frames - 1)
        T = self._m_t
        while len(slots) - len(flagged) >= cap:
            newest_kf = kf_ids[slots].max()
            best_score, best_slot = 1.0, None
            latest_slot = slots[int(np.argmax(kf_ids[slots]))]
            for s in slots:
                if s in flagged or kf_ids[s] > newest_kf - 1 or kf_ids[s] == 0:
                    continue
                dist_score = 0.0
                for s2 in slots:
                    if s2 == s or kf_ids[s2] > newest_kf:
                        continue
                    d = np.linalg.norm(T[s] - T[s2])
                    dist_score += 1.0 / (1e-5 + d)
                dist_score *= -np.sqrt(np.linalg.norm(T[s] - T[latest_slot]))
                if dist_score < best_score:
                    best_score, best_slot = dist_score, s
            if best_slot is None:
                break
            flagged.append(best_slot)
        return flagged

    def _connected_kf_ids(self, kf_id: int) -> set:
        """Keyframes sharing residuals (active or marginalized) with kf_id."""
        out = set()
        for (h, t), (na, nm) in self.connectivity.items():
            if na + nm <= 0:
                continue
            if h == kf_id:
                out.add(t)
            elif t == kf_id:
                out.add(h)
        return out

    def _reset(self):
        """Re-initialize after an init failure (Main/System reset path)."""
        cfg = self.cfg
        self.window = W.empty_window(cfg, self.height, self.width)
        self.imm = KS.empty_imm(cfg)
        from ..ops import features as FT
        self.feats = FT.empty_feats(cfg.max_frames, cfg.max_kf_features)
        self._m_valid[:] = False
        self._m_kfid[:] = -1
        self._m_nact_host[:] = 0
        self._m_nimm_host[:] = 0
        self._m_n_active = 0
        self._marg_counts = {}
        self.connectivity = {}
        self.initialized = False
        self.init_failed = False
        self._init_first = None
        self.slot_shell = [None] * cfg.max_frames
        self.next_kf_id = 0
        self.template = None
        self._newest_template = None
        with self._ref_lock:
            self._pending_ref = None
        self.ref_slot = -1
        self.first_coarse_rmse = -1.0
        self.last_coarse_rmse = np.full(5, 100.0)

    # --------------------------------------------------------------- output
    def trajectory(self):
        """All frame poses (camToWorld) for export."""
        return [
            (s.timestamp, s.cam_to_world[:3, :3], s.cam_to_world[:3, 3])
            for s in self.shells
        ]
