"""The SLAM entry point (the counterpart of
``simpleslam_tpu/run_slam.py``): the per-frame state machine on the host
(``SLAMSystem``), the fused device loop that takes over after its
bootstrap (``run_fused_loop``) and the CLI (``run``, ``main``) over a
dataset read by ``data/dataloader.py``.

Delayed two-view bootstrap -> frame-to-map PnP tracking (widened-window
retry, keyframe relocalisation, global relocalisation, 2D-2D essential
fallback) -> keyframe policy -> KF-pair triangulation -> local bundle
adjustment. Tensors live on the system's device; the map and the decisions
live on the host. Not ported yet (they raise): lens undistortion, loop
closure (also in the fused loop), global BA, resumed and saved state,
localisation-only mode and the live windows (``run`` needs
``--headless``).

Run:  python -m simpleslam_tpu_torch.run_slam --dataset kitti \
          --base_dir <dir> --headless --no_viz3d [--fused] [--device cpu]
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from simpleslam_tpu_torch.config import SLAMConfig
from simpleslam_tpu_torch.core import frontend
from simpleslam_tpu_torch.core.ba import local_bundle_adjustment
from simpleslam_tpu_torch.core.bootstrap import (InitParams,
                                                 bootstrap_two_view_map)
from simpleslam_tpu_torch.core.keyframe import (Keyframe, make_thumb,
                                                select_keyframe)
from simpleslam_tpu_torch.core.loop import place_vector
from simpleslam_tpu_torch.core.map import Map
from simpleslam_tpu_torch.core.triangulate import \
    triangulate_between_kfs_2view
from simpleslam_tpu_torch.core.types import Features, Matches
from simpleslam_tpu_torch.data import Prefetcher, Sequence as Dataset
from simpleslam_tpu_torch.ops import epipolar, pnp, se3
from simpleslam_tpu_torch.tools.trajectory_eval import ate_rmse
from simpleslam_tpu_torch.utils.device import resolve_device
from simpleslam_tpu_torch.utils.profiling import StageTimer
from simpleslam_tpu_torch.viz import Trajectory2D
from simpleslam_tpu_torch.utils.rng import (SITE_ESS, SITE_GRELOC,
                                            SITE_KF_MATCH, SITE_KF_MATCH2,
                                            SITE_PNP, SITE_PREV_MATCH,
                                            SITE_RELOC, TorchKey, frame_key)

logger = logging.getLogger("main")


@dataclass
class BootstrapState:
    """Reference anchor of the delayed bootstrap."""
    ref_idx: int = -1
    ref_feats: Optional[Features] = None
    ref_img: Optional[np.ndarray] = None

    def seed(self, idx: int, feats: Features, img) -> None:
        self.ref_idx, self.ref_feats, self.ref_img = idx, feats, img

    def clear(self) -> None:
        self.ref_idx, self.ref_feats, self.ref_img = -1, None, None

    def refresh_needed(self, n_matches: int, cur_idx: int,
                       min_matches: int = 80, max_age: int = 30) -> bool:
        """Reseed when the pair went stale."""
        return n_matches < min_matches or (cur_idx - self.ref_idx) > max_age


@dataclass
class SLAMResult:
    poses_cw: List[np.ndarray] = field(default_factory=list)
    frame_ids: List[int] = field(default_factory=list)
    n_keyframes: int = 0
    n_landmarks: int = 0
    ate: Optional[float] = None
    fps: float = 0.0
    n_frames: int = 0
    tracking_lost_count: int = 0
    map_compactions: int = 0    # fused-mode eviction passes
    kf_frames: List[int] = field(default_factory=list)  # KF source frame ids
    loop_closures: int = 0      # accepted loop closures (not ported: 0)
    closure_events: List[object] = field(default_factory=list)
    gba_runs: int = 0           # global-BA solves (not ported: 0)


class SLAMSystem:
    """The live pipeline, reusable by the CLI, tests and benchmarks.

    ``device``: None runs on CUDA and raises without it; pass "cpu" to run
    on the CPU. ``key``: the randomness source (``utils/rng.py``; default a
    ``TorchKey`` seeded from ``cfg.seed``). ``weights``: optional
    (aliked_state_dict, lightglue_state_dict); otherwise the trained tree
    (``models/pipeline.py``).

    Counters: ``tracking_lost_count`` (frames not posed) and
    ``local_ba_solves`` (local BAs that ran a solve).
    """

    def __init__(self, cfg: SLAMConfig, K: np.ndarray,
                 D: Optional[np.ndarray] = None,
                 img_hw: Optional[tuple] = None, device=None, key=None,
                 weights: Optional[Tuple[Mapping, Mapping]] = None):
        if D is not None and np.any(np.abs(np.asarray(D)) > 1e-12):
            raise NotImplementedError(
                "lens undistortion is not ported yet (nonzero D)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.K = np.asarray(K, np.float64)
        self._K_t = torch.as_tensor(self.K, dtype=torch.float32,
                                    device=self.device)
        self.timer = StageTimer()
        self.detector, self.matcher = frontend.init_feature_pipeline(
            cfg, device=self.device, weights=weights)
        self.world_map = Map()
        self.kfs: List[Keyframe] = []
        self.last_kf_frame_no = -999
        self.bs = BootstrapState()
        self.initialised = False
        self.tracking_lost_count = 0
        self.local_ba_solves = 0
        self.frame_ids: List[int] = []
        self._snap_cache = None
        self._lost_streak = 0
        self._vel_reset = False
        self._place_vecs: List[np.ndarray] = []
        self._key = key if key is not None else TorchKey(cfg.seed)
        self._base_key = self._key
        self.img_hw = img_hw
        self.init_params = InitParams(
            ransac_px=cfg.ransac_thresh,
            min_posdepth=cfg.bootstrap_min_posdepth,
            min_parallax_deg=cfg.bootstrap_min_parallax_deg,
            score_ratio_H=cfg.bootstrap_score_ratio_h,
            n_hyp=cfg.ransac_hypotheses)

    # ------------------------------------------------------------------ utils
    def _next_key(self):
        self._key, k = self._key.split()
        return k

    def _site_key(self, frame_idx: int, site: int):
        """Per-(frame, site) key: the derivation the fused loop uses."""
        return frame_key(self._base_key, frame_idx, site)

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=self.device)

    def preprocess(self, img):
        """The frame as tracked: undistortion is not ported, and a system
        with nonzero ``D`` refuses to start, so this is the identity."""
        return img

    def extract(self, img) -> Features:
        return frontend.feature_extractor(self.cfg, img, self.detector)

    def match(self, f0: Features, f1: Features, key=None) -> Matches:
        return frontend.match_with_ransac(
            self.cfg, self.matcher, f0, f1,
            key=key if key is not None else self._next_key())

    def _map_snapshot(self):
        """Padded map view on the device, cached until the map changes
        (it changes only at bootstrap and keyframe events)."""
        ver = self.world_map.version
        if self._snap_cache is not None and self._snap_cache[0] == ver:
            return self._snap_cache[1]
        desc = self.kfs[-1].feats.desc if self.kfs else None
        desc_dim = desc.shape[1] if desc is not None else 32
        binary = desc is None or desc.dtype == torch.uint8
        host = self.world_map.snapshot(self.cfg.map_capacity, desc_dim,
                                       np.uint8 if binary else np.float32)
        snap = {k: (torch.as_tensor(v, device=self.device) if k != "pid"
                    else v) for k, v in host.items()}
        self._snap_cache = (ver, snap)
        return snap

    def _refresh_rings(self, snap, assoc, inl, feats) -> None:
        """Write this frame's matched descriptors (PnP inliers) into the
        landmarks' descriptor rings, on the device snapshot in place and in
        the host map (no version bump)."""
        sel_t = torch.nonzero(assoc.valid & inl).flatten()
        if sel_t.numel() == 0:
            return
        descs = feats.desc[assoc.kp_idx[sel_t]]
        nd = snap["n_desc"]
        slots = nd[sel_t] % snap["desc"].shape[1]
        snap["desc"][sel_t, slots] = descs
        nd[sel_t] += 1
        sel = sel_t.cpu().numpy()
        for pid, d in zip(snap["pid"][sel], descs.cpu().numpy()):
            if pid >= 0:
                self.world_map.refresh_ring(int(pid), d)

    # ------------------------------------------------------------ bootstrap
    def _try_bootstrap(self, frame_idx: int, img, feats: Features) -> bool:
        cfg = self.cfg
        if self.bs.ref_feats is None:
            self.bs.seed(frame_idx, feats, img)
            return False
        matches = self.match(self.bs.ref_feats, feats)
        n_m = int(matches.valid.sum())
        if self.bs.refresh_needed(n_m, frame_idx,
                                  cfg.bootstrap_refresh_min_matches,
                                  cfg.bootstrap_refresh_max_age):
            logger.info("[BOOTSTRAP] reseeding reference (matches=%d age=%d)",
                        n_m, frame_idx - self.bs.ref_idx)
            self.bs.seed(frame_idx, feats, img)
            return False
        ok, T0, T1 = bootstrap_two_view_map(
            self.K, self.bs.ref_feats, feats, matches, cfg, self.world_map,
            self.init_params, key=self._next_key())
        if not ok:
            return False
        self.world_map.add_pose(T0, is_keyframe=True)
        self.world_map.add_pose(T1, is_keyframe=True)
        self.frame_ids.extend([self.bs.ref_idx, frame_idx])
        self.kfs.append(Keyframe(0, self.bs.ref_idx, "", self.bs.ref_feats,
                                 T0, make_thumb(self.bs.ref_img)))
        self.kfs.append(Keyframe(1, frame_idx, "", feats, T1,
                                 make_thumb(img)))
        self.last_kf_frame_no = frame_idx
        self.initialised = True
        self.bs.clear()
        logger.info("[BOOTSTRAP] initialised at frame %d (map=%d)",
                    frame_idx, len(self.world_map))
        return True

    # ------------------------------------------------------------- tracking
    def _track(self, frame_idx: int, feats: Features, prev_feats: Features,
               matches_prev: Matches) -> bool:
        """PnP tracking with the recovery chain. Returns success."""
        cfg = self.cfg
        poses = self.world_map.poses
        T_prev = poses[-1]
        T_prevprev = poses[-2] if len(poses) >= 2 else poses[-1]
        if self._vel_reset:
            T_pred = T_prev.copy()
            self._vel_reset = False
        else:
            T_pred = pnp.predict_pose_const_vel(
                self._t(T_prevprev), self._t(T_prev)).cpu().numpy() \
                .astype(np.float64)
        snap = self._map_snapshot()
        H, W = self.img_hw if self.img_hw else (10000, 10000)
        T_pred_t = self._t(T_pred)

        def attempt(radius_px):
            assoc = pnp.reproject_and_match_2d3d(
                snap["positions"], snap["alive"], snap["desc"],
                snap["n_desc"], feats.kpts, feats.desc, feats.valid,
                self._K_t, T_pred_t, img_w=int(W), img_h=int(H),
                radius_px=radius_px, max_hamm=cfg.match_max_hamm,
                max_l2=cfg.match_max_l2, n_rows=len(self.world_map))
            rows = torch.nonzero(assoc.valid).flatten()
            n_cand = rows.numel()
            if n_cand < cfg.pnp_min_inliers:
                return None, f"too few 2D-3D candidates ({n_cand})", assoc
            # PnP on the candidate rows only (the snapshot is mostly padding)
            T_est, inl_c, n_inl, ok = pnp.solve_pnp_ransac(
                self._site_key(frame_idx, SITE_PNP), snap["positions"][rows],
                feats.kpts[assoc.kp_idx[rows]],
                torch.ones_like(rows, dtype=torch.bool), self._K_t,
                cfg.ransac_thresh, Tcw_init=T_pred_t,
                n_hyp=cfg.ransac_hypotheses)
            inl = torch.zeros_like(assoc.valid)
            inl[rows] = inl_c
            n_inl = int(n_inl)
            if bool(ok) and n_inl >= cfg.pnp_min_inliers:
                return (T_est, inl), "", assoc
            return None, (f"PnP rejected (inl={n_inl} < "
                          f"{cfg.pnp_min_inliers})"), assoc

        hit, why, assoc = attempt(cfg.proj_radius)
        wf = float(getattr(cfg, "assoc_wide_factor", 0.0))
        if hit is None and wf > 1.0:
            hit, why2, assoc = attempt(cfg.proj_radius * wf)
            if hit is None:
                why = f"{why}; wide retry: {why2}"

        tracking_lost = True
        if hit is not None:
            T_est, inl = hit
            self.world_map.add_pose(T_est.cpu().numpy().astype(np.float64),
                                    is_keyframe=False)
            self.frame_ids.append(frame_idx)
            self._refresh_rings(snap, assoc, inl, feats)
            tracking_lost = False
        else:
            logger.info("[TRACK] %s", why)

        if tracking_lost and cfg.reloc and self.kfs:
            with self.timer.stage("reloc"):
                if self._relocalize(frame_idx, feats, T_pred):
                    tracking_lost = False
        if (tracking_lost and cfg.global_reloc and self.kfs
                and self._lost_streak + 1 >= cfg.global_reloc_after):
            with self.timer.stage("greloc"):
                if self._global_relocalize(frame_idx, feats):
                    tracking_lost = False
        if tracking_lost:
            self.tracking_lost_count += 1
            self._fallback_2d2d(frame_idx, feats, prev_feats, matches_prev)
        self._lost_streak = self._lost_streak + 1 if tracking_lost else 0
        return not tracking_lost

    def _pnp_against_kf(self, frame_idx: int, feats: Features, kf,
                        T_init: np.ndarray, site: Optional[int] = None):
        """Match the frame against one keyframe and PnP on the landmarks its
        keypoints observe -> (T_cw, n_inliers, n_pairs) or None."""
        cfg = self.cfg
        m = frontend.feature_matcher(cfg, kf.feats, feats, self.matcher)
        kp2pid = {}
        for pid, mp in self.world_map.points.items():
            for (kf_idx, kp_idx, _d) in mp.observations:
                if kf_idx == kf.idx:
                    kp2pid[int(kp_idx)] = pid
        kpts = feats.kpts.cpu().numpy()
        pts3d, pts2d = [], []
        for a, b, v in zip(m.idx0.cpu().numpy(), m.idx1.cpu().numpy(),
                           m.valid.cpu().numpy()):
            pid = kp2pid.get(int(a))
            if v and pid is not None:
                pts3d.append(np.asarray(self.world_map.points[pid].position,
                                        np.float32))
                pts2d.append(kpts[int(b)])
        if len(pts3d) < cfg.pnp_min_inliers:
            return None
        M = len(pts3d)
        Mp = 1 << (max(M, 8) - 1).bit_length()
        P3 = np.zeros((Mp, 3), np.float32)
        P2 = np.zeros((Mp, 2), np.float32)
        val = np.zeros(Mp, bool)
        P3[:M], P2[:M], val[:M] = pts3d, pts2d, True
        T_r, _inl, n_inl, ok = pnp.solve_pnp_ransac(
            self._site_key(frame_idx, SITE_RELOC if site is None else site),
            self._t(P3), self._t(P2),
            torch.as_tensor(val, device=self.device), self._K_t,
            cfg.ransac_thresh, Tcw_init=self._t(T_init),
            n_hyp=cfg.ransac_hypotheses)
        n_inl = int(n_inl)
        if bool(ok) and n_inl >= cfg.pnp_min_inliers:
            return T_r.cpu().numpy().astype(np.float64), n_inl, M
        return None

    def _relocalize(self, frame_idx: int, feats: Features,
                    T_pred: np.ndarray) -> bool:
        """Keyframe 2D-3D relocalisation against the last keyframe."""
        kf = self.kfs[-1]
        hit = self._pnp_against_kf(frame_idx, feats, kf, T_pred)
        if hit is None:
            return False
        T_r, n_inl, M = hit
        self.world_map.add_pose(T_r, is_keyframe=False)
        self.frame_ids.append(frame_idx)
        logger.info("[RELOC] recovered pose via KF %d (inliers=%d/%d)",
                    kf.idx, n_inl, M)
        return True

    def _global_relocalize(self, frame_idx: int, feats: Features) -> bool:
        """Kidnapped-robot recovery: place-vector candidates over ALL
        keyframes, PnP against each with the candidate's pose as the guess.
        A wrong candidate fails the inlier gate and rewrites nothing."""
        cfg = self.cfg
        if self.img_hw is None:
            return False
        while len(self._place_vecs) < len(self.kfs):
            kf = self.kfs[len(self._place_vecs)]
            self._place_vecs.append(place_vector(kf.feats, self.img_hw,
                                                 cfg.loop_grid))
        vec = place_vector(feats, self.img_hw, cfg.loop_grid)
        sims = np.stack(self._place_vecs) @ vec
        for cand in np.argsort(-sims)[: int(cfg.global_reloc_topk)]:
            if sims[cand] < cfg.global_reloc_min_sim:
                break
            kf = self.kfs[int(cand)]
            hit = self._pnp_against_kf(frame_idx, feats, kf,
                                       np.asarray(kf.pose, np.float64),
                                       site=SITE_GRELOC)
            if hit is None:
                continue
            T_r, n_inl, M = hit
            self.world_map.add_pose(T_r, is_keyframe=False)
            self.frame_ids.append(frame_idx)
            self._vel_reset = True
            logger.info("[GRELOC] recovery via KF %d (sim=%.3f, inl=%d/%d)",
                        kf.idx, float(sims[cand]), n_inl, M)
            return True
        return False

    def _fallback_2d2d(self, frame_idx: int, feats: Features,
                       prev_feats: Features, matches: Matches) -> None:
        """Essential-matrix 2D-2D step with const-velocity scale."""
        cfg = self.cfg
        poses = self.world_map.poses
        p0 = prev_feats.kpts[matches.idx0]
        p1 = feats.kpts[matches.idx1]
        E, inl, ok = epipolar.find_essential(
            self._site_key(frame_idx, SITE_ESS), p0, p1, matches.valid,
            self._K_t, cfg.ransac_thresh, n_hyp=cfg.ransac_hypotheses)
        if not bool(ok):
            logger.info("[FALLBACK] essential failed; dead-reckoning")
            self.world_map.add_pose(poses[-1].copy(), is_keyframe=False)
            self.frame_ids.append(frame_idx)
            return
        R, t, _good, _n = epipolar.recover_pose_essential(E, p0, p1, inl,
                                                          self._K_t)
        scale = 0.0
        if len(poses) >= 2:
            T_rel_last = poses[-1] @ np.linalg.inv(poses[-2])
            scale = float(np.linalg.norm(T_rel_last[:3, 3]))
        T_rel = se3.rt_to_T(R, t * scale).cpu().numpy().astype(np.float64)
        self.world_map.add_pose(T_rel @ poses[-1], is_keyframe=False)
        self.frame_ids.append(frame_idx)
        logger.info("[FALLBACK] 2D-2D pose applied (scale=%.3f)", scale)

    # ------------------------------------------------------------ keyframes
    def _maybe_keyframe(self, frame_idx: int, img, feats: Features) -> int:
        """Keyframe policy + triangulation + local BA. Returns #new points."""
        cfg = self.cfg
        n_before = len(self.kfs)
        k_kfm = self._site_key(frame_idx, SITE_KF_MATCH)
        self.kfs, self.last_kf_frame_no = select_keyframe(
            cfg, frame_idx, img, feats, self.world_map.poses[-1],
            lambda a, b: self.match(a, b, key=k_kfm), self.kfs,
            self.last_kf_frame_no)
        if len(self.kfs) == n_before:
            return 0
        self.world_map.keyframe_indices.append(len(self.world_map.poses) - 1)
        new_ids = []
        if len(self.kfs) >= 2:
            with self.timer.stage("triangulate"):
                new_ids = triangulate_between_kfs_2view(
                    cfg, self.K, self.kfs[-2], self.kfs[-1], self.world_map,
                    self.matcher,
                    parallax_min_deg=cfg.triangulation_parallax_min_deg,
                    key=k_kfm)
                if getattr(cfg, "tri_kf2", False) and len(self.kfs) >= 3:
                    used = {self.world_map.points[p].observations[-1][1]
                            for p in new_ids if p in self.world_map.points}
                    new_ids += triangulate_between_kfs_2view(
                        cfg, self.K, self.kfs[-3], self.kfs[-1],
                        self.world_map, self.matcher,
                        parallax_min_deg=cfg.triangulation_parallax_min_deg,
                        key=self._site_key(frame_idx, SITE_KF_MATCH2),
                        exclude_cur_kp=used)
        if len(new_ids) >= cfg.local_ba_min_new_points and len(self.kfs) >= 2:
            try:
                with self.timer.stage("local_ba"):
                    self.local_ba_solves += bool(local_bundle_adjustment(
                        self.world_map, self.K, self.kfs,
                        center_kf_idx=len(self.kfs) - 1,
                        window_size=cfg.local_ba_window,
                        max_points=cfg.local_ba_max_points,
                        max_iters=cfg.local_ba_max_iters))
            except Exception:
                # BA must never kill tracking (the reference's rule)
                logger.exception("[Local BA] failed; tracking continues")
        return len(new_ids)

    # ------------------------------------------------------------ main step
    def process_frame(self, frame_idx: int, img,
                      prev_feats: Optional[Features]) -> Features:
        """One frame of the pipeline; returns this frame's features (the
        caller passes them back as ``prev_feats`` for the next frame)."""
        with self.timer.stage("preprocess"):
            img = self.preprocess(img)
        if self.img_hw is None:
            self.img_hw = tuple(np.shape(img)[:2])
        with self.timer.stage("extract"):
            feats = self.extract(img)
        if prev_feats is None:
            if not self.initialised:
                self.bs.seed(frame_idx, feats, img)
            return feats
        if not self.initialised:
            with self.timer.stage("bootstrap"):
                self._try_bootstrap(frame_idx, img, feats)
            return feats
        with self.timer.stage("match_prev"):
            matches_prev = self.match(
                prev_feats, feats,
                key=self._site_key(frame_idx, SITE_PREV_MATCH))
        with self.timer.stage("track"):
            self._track(frame_idx, feats, prev_feats, matches_prev)
        with self.timer.stage("keyframe"):
            self._maybe_keyframe(frame_idx, img, feats)
        return feats


def build_fused_loop(cfg: SLAMConfig, system: SLAMSystem,
                     prev_feats: Features, n_frames: int):
    """The fused loop's parts for a sequence of ``n_frames`` frames after
    ``system`` bootstrapped: (FusedConfig, step, post-bootstrap state).
    ``prev_feats``: the last host frame's features. Loop closure
    (``cfg.loop_closure``) is not ported: it raises."""
    from simpleslam_tpu_torch.core.fused import (build_fused_step,
                                                 make_fused_config,
                                                 state_from_host)
    if cfg.loop_closure:
        raise NotImplementedError(
            "loop closure in the fused loop (apply_host_correction, "
            "_host_assist_reloc) is not ported yet")
    fc = make_fused_config(cfg, system.img_hw,
                           n_kp=int(prev_feats.kpts.shape[0]),
                           desc_dim=int(prev_feats.desc.shape[1]),
                           log_capacity=1 << max(10, n_frames.bit_length()))
    match_fn = getattr(system.matcher, "fn_fast", None) or system.matcher.fn
    step = build_fused_step(fc, system.K, system.detector.fn, match_fn,
                            system.device)
    return fc, step, state_from_host(system, fc, prev_feats)


def run_fused_loop(cfg: SLAMConfig, system: SLAMSystem, frames: Sequence,
                   prev_feats: Features, start_idx: int, built=None):
    """The fused device loop over ``frames`` (arrays or tensors of frames
    ``start_idx``, ``start_idx + 1``, ...: a sized sequence, whose length
    sizes the log, or with ``built`` any iterable) after ``system``
    bootstrapped on the earlier frames; ``prev_feats``:
    the last host frame's features. One step per frame
    (``core/fused.py``), a read of the pose every ``cfg.fused_sync_every``
    frames, and one sync of the log and the map into ``system`` at the end.
    ``built``: :func:`build_fused_loop`'s result to run instead of building
    one (its state is updated in place).

    Returns (final state, step); ``step.host_reads`` counts the step's
    branch reads. Loop closure (``cfg.loop_closure``) is not ported: it
    raises."""
    from simpleslam_tpu_torch.core.fused import sync_to_host
    fc, step, state = built or build_fused_loop(
        cfg, system, prev_feats, start_idx + len(frames))
    sync_every = int(cfg.fused_sync_every)
    t_warm = None
    n_dispatched = 0
    with system.timer.stage("fused_loop"):
        for img in frames:
            with system.timer.stage("fused_dispatch"):
                state = step(state, torch.as_tensor(img, device=system.device))
            n_dispatched += 1
            if n_dispatched == 10:
                state.Tcw.cpu()
                t_warm = time.perf_counter()
            if sync_every and n_dispatched % sync_every == 0:
                with system.timer.stage("fused_sync"):
                    state.Tcw.cpu()           # observes every step so far
    with system.timer.stage("fused_sync"):
        host = sync_to_host(system, state, fc)
    if t_warm is not None and n_dispatched > 30:
        logger.info("[FUSED] sustained %.2f frames/s over %d post-warm-up "
                    "frames (%s syncs)",
                    (n_dispatched - 10) / (time.perf_counter() - t_warm),
                    n_dispatched - 10, "periodic" if sync_every else "no")
    system.kf_count_override = int(host["kf_count"])
    system._key = state.key
    return state, step


def _run_fused_over(cfg: SLAMConfig, seq: Dataset, system: SLAMSystem,
                    prev_feats: Features, start_idx: int) -> None:
    """:func:`run_fused_loop` over frames ``start_idx`` on of ``seq``:
    decoded and uploaded ahead by a :class:`Prefetcher`, or all staged on
    the device first with ``--stage_all``."""
    dev = system.device
    built = build_fused_loop(cfg, system, prev_feats, len(seq))
    if cfg.stage_all:
        logger.info("[FUSED] staging %d frames on device...",
                    len(seq) - start_idx)
        frames = [torch.as_tensor(seq.frame(i), device=dev)
                  for i in range(start_idx, len(seq))]
        run_fused_loop(cfg, system, frames, prev_feats, start_idx,
                       built=built)
        return
    pf = Prefetcher(seq, depth=max(1, cfg.prefetch), start=start_idx,
                    transform=lambda im: torch.as_tensor(im, device=dev))
    try:
        run_fused_loop(cfg, system, (img for _i, img in pf), prev_feats,
                       start_idx, built=built)
    finally:
        pf.close()


# the paths that ``run`` does not take yet, each with its roadmap item
_NOT_PORTED = (
    ("headless", False, "live windows (the non-headless run) wait for viz, "
                        "ROADMAP A.13; pass --headless"),
    ("loop_closure", True, "loop closure waits for ROADMAP A.7"),
    ("gba_enable", True, "global BA waits for ROADMAP A.8"),
    ("resume", True, "resuming a saved state waits for ROADMAP A.13"),
    ("save_state", True, "saving the state waits for ROADMAP A.13"),
    ("localize_only", True, "localisation-only mode waits for ROADMAP A.13"),
)


def run(cfg: SLAMConfig, device=None) -> SLAMResult:
    """The CLI's run over ``cfg.dataset`` under ``cfg.base_dir``: the host
    pipeline frame by frame, or with ``cfg.fused`` the host bootstrap and
    then the fused device loop. ``device``: None is the GPU (raises without
    one), "cpu" the CPU. Logs the ATE line (against the dataset's ground
    truth), ``done: ...`` and the per-stage breakdown, and tries to save
    ``trajectory_<dataset>.png`` (needs matplotlib; a warning without)."""
    for name, bad, why in _NOT_PORTED:
        if bool(getattr(cfg, name, not bad)) == bad:
            raise NotImplementedError(why)
    device = resolve_device(device)
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s:%(name)s: %(message)s")
    for name in ("main", "two_view_bootstrap", "pnp", "triangulation", "ba"):
        logging.getLogger(name).setLevel(logging.INFO)

    seq = Dataset.load(cfg)
    gt44 = None
    if seq.gt is not None:
        gt44 = np.tile(np.eye(4), (len(seq.gt), 1, 1))
        gt44[:, :3, :4] = seq.gt

    img0 = seq.frame(0)
    system = SLAMSystem(cfg, seq.K, seq.D, img_hw=img0.shape[:2],
                        device=device)
    traj2d = Trajectory2D(gt44, dataset=cfg.dataset)

    def push_poses(frame_idx):
        while len(traj2d.est) < len(system.world_map.poses):
            i = len(traj2d.est)
            fid = (system.frame_ids[i] if i < len(system.frame_ids)
                   else frame_idx)
            traj2d.push(fid, system.world_map.poses[i])

    t_start = time.perf_counter()
    n = len(seq)
    start_idx = 1
    prev_feats = system.process_frame(0, img0, None)
    frame_idx = 0
    if cfg.fused:
        # the host bootstraps, then the fused device loop takes the rest
        for frame_idx in range(start_idx, n):
            with system.timer.stage("frame_load"):
                img = seq.frame(frame_idx)
            prev_feats = system.process_frame(frame_idx, img, prev_feats)
            if system.initialised:
                break
        start_idx = frame_idx + 1
        if system.initialised and start_idx < n:
            _run_fused_over(cfg, seq, system, prev_feats, start_idx)
        if system.initialised and system.world_map.poses:
            push_poses(frame_idx)
        start_idx = n
    for frame_idx in range(start_idx, n):
        with system.timer.stage("frame_load"):
            img = seq.frame(frame_idx)
        prev_feats = system.process_frame(frame_idx, img, prev_feats)
        if system.initialised and system.world_map.poses:
            push_poses(frame_idx)

    dt = time.perf_counter() - t_start
    res = SLAMResult(
        poses_cw=list(system.world_map.poses),
        frame_ids=list(system.frame_ids),
        n_keyframes=getattr(system, "kf_count_override", 0) or len(system.kfs),
        n_landmarks=len(system.world_map),
        fps=(n / dt) if dt > 0 else 0.0,
        n_frames=n,
        tracking_lost_count=system.tracking_lost_count,
        map_compactions=int(getattr(system, "_fused_compactions", 0)),
        kf_frames=[system.frame_ids[i]
                   for i in system.world_map.keyframe_indices
                   if i < len(system.frame_ids)])

    out_png = f"trajectory_{cfg.dataset}.png"
    try:
        traj2d.save(out_png)
        logger.info("saved %s", out_png)
    except Exception as e:
        logger.warning("could not save trajectory png: %s", e)

    if gt44 is not None and len(res.poses_cw) >= 2 and res.frame_ids:
        est = np.stack(res.poses_cw)
        gt_sel = gt44[[min(f, len(gt44) - 1) for f in res.frame_ids]]
        res.ate, stats = ate_rmse(est, gt_sel, align="sim3")
        logger.info("ATE-RMSE (Sim3): %.4f m over %d frames (scale %.3f)",
                    res.ate, stats.get("n", 0), stats.get("scale", 1.0))
        if stats.get("n_nonfinite"):
            logger.warning("ATE computed on the finite subset: %d non-finite "
                           "pose rows dropped (diverged run)",
                           stats["n_nonfinite"])
    logger.info("done: %d frames, %.2f FPS, %d KFs, %d landmarks, %d lost",
                res.n_frames, res.fps, res.n_keyframes, res.n_landmarks,
                res.tracking_lost_count)
    # 'keyframe' wholly contains 'triangulate' and 'local_ba'; 'host-gap'
    # is loop time that no stage accounts for
    accounted = sum(t for nm, t in system.timer.totals.items()
                    if nm not in ("triangulate", "local_ba"))
    system.timer.totals["host-gap"] = max(dt - accounted, 0.0)
    system.timer.counts["host-gap"] = n
    logger.info("per-stage breakdown:\n%s", system.timer.report())
    return res


def main(argv=None, results: Optional[list] = None) -> int:
    """``python -m simpleslam_tpu_torch.run_slam [flags]``: the reference's
    flags (``config.py``) plus ``--device`` (default: the GPU).
    ``results``: a list that receives the run's :class:`SLAMResult`."""
    from simpleslam_tpu_torch.config import build_parser, parse_config
    device = build_parser().parse_args(argv).device
    res = run(parse_config(argv), device=device)
    if results is not None:
        results.append(res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
