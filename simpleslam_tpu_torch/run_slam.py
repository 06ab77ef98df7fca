"""The SLAM entry point (the counterpart of
``simpleslam_tpu/run_slam.py``): the per-frame state machine on the host
(``SLAMSystem``), the fused device loop that takes over after its
bootstrap (``run_fused_loop``) and the CLI (``run``, ``main``) over a
dataset read by ``data/dataloader.py``.

Delayed two-view bootstrap -> frame-to-map PnP tracking (widened-window
retry, keyframe relocalisation, global relocalisation, 2D-2D essential
fallback) -> keyframe policy -> KF-pair triangulation -> local bundle
adjustment -> loop closure (``--loop_closure``: on each new keyframe, or in
the fused loop at periodic syncs, with the host-assisted rescue) -> global
BA (``--gba_enable``: at the ``gba_every`` keyframe milestone and after an
accepted closure). ``--save_state`` writes the map, trajectory and
keyframes at the end of a run (``utils/serialize.py``), ``--resume``
continues from such a file, and ``--resume --localize_only`` tracks against
its map frozen, the first pose from global relocalisation. A lens with
distortion is undistorted on the device: on the host each raw frame before
extraction, in the fused step each grey frame. Tensors live on the system's
device; the map and the decisions live on the host. Without ``--headless``
the host loop shows its windows after each frame (the live trajectory
plot, the keyframe strip, the match overlay and the track trails, the 3-D
viewer where open3d is installed) and polls the keyboard (p pause, n
step, q quit); ``--viz_ba`` adds the local-BA reprojection overlays.

Run:  python -m simpleslam_tpu_torch.run_slam --dataset kitti \
          --base_dir <dir> [--headless] --no_viz3d [--fused] [--device cpu]
"""
from __future__ import annotations

import logging
import signal
import time
from dataclasses import dataclass, field, replace
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from simpleslam_tpu_torch.config import SLAMConfig
from simpleslam_tpu_torch.core import frontend
from simpleslam_tpu_torch.core.ba import (global_bundle_adjustment,
                                          local_bundle_adjustment)
from simpleslam_tpu_torch.core.bootstrap import (InitParams,
                                                 bootstrap_two_view_map)
from simpleslam_tpu_torch.core.keyframe import (Keyframe, make_thumb,
                                                select_keyframe)
from simpleslam_tpu_torch.core.loop import LoopCloser, place_vector
from simpleslam_tpu_torch.core.map import Map
from simpleslam_tpu_torch.core.triangulate import \
    triangulate_between_kfs_2view
from simpleslam_tpu_torch.core.types import Features, Matches
from simpleslam_tpu_torch.data import Prefetcher, Sequence as Dataset
from simpleslam_tpu_torch.ops import epipolar, pnp, projection, se3
from simpleslam_tpu_torch.tools.trajectory_eval import ate_rmse
from simpleslam_tpu_torch.utils.device import resolve_device
from simpleslam_tpu_torch.utils.profiling import StageTimer, torch_trace
from simpleslam_tpu_torch.viz import Trajectory2D, Visualizer3D, VizUI
from simpleslam_tpu_torch.utils.rng import (SITE_ESS, SITE_GRELOC,
                                            SITE_KF_MATCH, SITE_KF_MATCH2,
                                            SITE_LOOP, SITE_PNP,
                                            SITE_PREV_MATCH, SITE_RELOC,
                                            TorchKey, frame_key)

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
    loop_closures: int = 0      # accepted loop closures (--loop_closure)
    # the accepted closures (core/loop.LoopClosure; cur_kf / cand_kf are
    # keyframe sequence ids, scale the measured Sim3 drift)
    closure_events: List[object] = field(default_factory=list)
    gba_runs: int = 0           # completed global-BA solves (--gba_enable)


class SLAMSystem:
    """The live pipeline, reusable by the CLI, tests and benchmarks.

    ``device``: None runs on CUDA and raises without it; pass "cpu" to run
    on the CPU. ``D``: the lens's distortion (k1, k2, p1, p2[, k3]); a
    nonzero ``D`` with ``img_hw`` builds the undistortion maps, and ``K``
    becomes the new camera matrix of the undistorted frames
    (``ops/projection.py``). Without ``img_hw`` the distorted frames are
    tracked as they are, as in the reference. ``key``: the randomness
    source (``utils/rng.py``; default a ``TorchKey`` seeded from
    ``cfg.seed``). ``weights``: optional
    (aliked_state_dict, lightglue_state_dict); otherwise the trained tree
    (``models/pipeline.py``).

    Counters: ``tracking_lost_count`` (frames not posed),
    ``local_ba_solves`` (local BAs that ran a solve) and ``gba_runs``
    (global BAs that ran a solve). ``loop_closer``: the run's
    ``LoopCloser``, made at the first keyframe with ``cfg.loop_closure``.
    """

    def __init__(self, cfg: SLAMConfig, K: np.ndarray,
                 D: Optional[np.ndarray] = None,
                 img_hw: Optional[tuple] = None, device=None, key=None,
                 weights: Optional[Tuple[Mapping, Mapping]] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.K = np.asarray(K, np.float64)
        self._undistort_maps = None
        if (D is not None and np.any(np.abs(np.asarray(D)) > 1e-12)
                and img_hw):
            H, W = img_hw
            K_t = torch.as_tensor(self.K, dtype=torch.float32,
                                  device=self.device)
            D_t = torch.as_tensor(np.asarray(D), dtype=torch.float32,
                                  device=self.device)
            newK = projection.optimal_new_camera_matrix(K_t, D_t, (W, H))
            self._undistort_maps = projection.undistort_rectify_map(
                K_t, D_t, newK, (W, H))
            self.K = newK.cpu().numpy().astype(np.float64)
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
        self.loop_closer: Optional[LoopCloser] = None
        self.gba_runs = 0
        self._last_gba_kf_count = -1   # the gba_every milestone's dedup
        self._lost_streak = 0
        self._vel_reset = False
        self._place_vecs: List[np.ndarray] = []
        self.want_viz = False          # run() sets it for a live run
        self._prev_img = None
        self._last_matches = None      # the match overlay's inputs
        self._trackbook = None
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
        """The frame as tracked: with undistortion maps, ``img`` (a host
        array or tensor, BGR or grey) remapped on the system's device in its
        own dtype (uint8 rounded half to even), before the extractor makes
        it grey; otherwise ``img`` itself."""
        if self._undistort_maps is not None:
            mapx, mapy = self._undistort_maps
            img = projection.remap_bilinear(
                torch.as_tensor(img if torch.is_tensor(img)
                                else np.asarray(img), device=self.device),
                mapx, mapy)
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
        hw = tuple(cfg.kf_thumb_hw)
        thumb0 = (make_thumb(self.bs.ref_img, hw)
                  if self.bs.ref_img is not None else b"")
        thumb1 = make_thumb(img, hw) if img is not None else b""
        self.kfs.append(Keyframe(0, self.bs.ref_idx, "", self.bs.ref_feats,
                                 T0, thumb0))
        self.kfs.append(Keyframe(1, frame_idx, "", feats, T1, thumb1))
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
            if not cfg.localize_only:   # rings are map state: frozen there
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
                poses_before = None
                if cfg.viz_ba:
                    poses_before = {kf.idx: np.array(kf.pose)
                                    for kf in self.kfs}
                with self.timer.stage("local_ba"):
                    self.local_ba_solves += bool(local_bundle_adjustment(
                        self.world_map, self.K, self.kfs,
                        center_kf_idx=len(self.kfs) - 1,
                        window_size=cfg.local_ba_window,
                        max_points=cfg.local_ba_max_points,
                        max_iters=cfg.local_ba_max_iters))
                if cfg.viz_ba:
                    from simpleslam_tpu_torch.viz.visualize_ba import \
                        visualize_ba_window
                    first = max(1, len(self.kfs) - cfg.local_ba_window)
                    visualize_ba_window(
                        self.world_map, self.K, self.kfs,
                        list(range(first, len(self.kfs))), poses_before,
                        show=self.want_viz)
            except Exception:
                # BA must never kill tracking (the reference's rule)
                logger.exception("[Local BA] failed; tracking continues")
        if cfg.loop_closure and len(self.kfs) >= 2:
            with self.timer.stage("loop"):
                lc = self.closer().on_new_keyframe(
                    self.kfs, self.world_map, self.img_hw,
                    self._site_key(frame_idx, SITE_LOOP))
            if lc is not None and cfg.gba_enable:
                # polish the pose-graph rewrite with a full metric BA
                self.run_global_ba()
        return len(new_ids)

    def closer(self) -> LoopCloser:
        """The run's loop closer, made on first use."""
        if self.loop_closer is None:
            self.loop_closer = LoopCloser(self.cfg, self.K, self.matcher,
                                          timer=self.timer)
        return self.loop_closer

    def run_global_ba(self) -> bool:
        """Full-map Schur-LM BA (``--gba_enable``). It writes back keyframe
        poses only, so each trailing non-keyframe pose keeps its relative
        pose to the last keyframe: B_post = B_pre @ A_pre^-1 @ A_post.
        Never with ``--localize_only`` (the map is frozen)."""
        if len(self.kfs) < 2 or self.cfg.localize_only:
            return False
        cfg = self.cfg
        ki = self.world_map.keyframe_indices
        anchor = ki[-1] if ki else None
        T_pre = (np.array(self.world_map.poses[anchor])
                 if anchor is not None and anchor < len(self.world_map.poses)
                 else None)
        try:
            with self.timer.stage("gba"):
                ok = global_bundle_adjustment(
                    self.world_map, self.K, self.kfs,
                    max_points=cfg.gba_max_points,
                    max_iters=cfg.gba_max_iters,
                    fix_first=bool(cfg.gba_fix_first))
        except Exception:
            # BA must never kill tracking (the reference's rule)
            logger.exception("[Global BA] failed; tracking continues")
            return False
        if ok:
            self.gba_runs += 1
            if T_pre is not None:
                corr = np.linalg.inv(T_pre) @ np.asarray(
                    self.world_map.poses[anchor])
                for i in range(anchor + 1, len(self.world_map.poses)):
                    self.world_map.poses[i] = self.world_map.poses[i] @ corr
        return ok

    # ------------------------------------------------------------ main step
    def process_frame(self, frame_idx: int, img,
                      prev_feats: Optional[Features]) -> Features:
        """One frame of the pipeline; returns this frame's features (the
        caller passes them back as ``prev_feats`` for the next frame). With
        ``--localize_only`` no keyframe is made, and until the first pose
        each frame only tries global relocalisation."""
        with self.timer.stage("preprocess"):
            img = self.preprocess(img)
        if self.img_hw is None:
            self.img_hw = tuple(np.shape(img)[:2])
        with self.timer.stage("extract"):
            feats = self.extract(img)
        if self.cfg.localize_only and not self.world_map.poses:
            # a frozen map starts kidnapped: the first pose comes from
            # place recognition, not a bootstrap or a motion model
            with self.timer.stage("greloc"):
                self._global_relocalize(frame_idx, feats)
            return feats
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
            if not self.cfg.localize_only:   # the map is frozen there
                self._maybe_keyframe(frame_idx, img, feats)
        if self.want_viz:
            from simpleslam_tpu_torch.viz.windows import TrackBook
            if self._trackbook is None:
                self._trackbook = TrackBook()
            kp_prev = prev_feats.kpts.cpu().numpy()
            kp_cur = feats.kpts.cpu().numpy()
            i0 = matches_prev.idx0.cpu().numpy()
            i1 = matches_prev.idx1.cpu().numpy()
            mv = matches_prev.valid.cpu().numpy()
            self._trackbook.advance(kp_prev, kp_cur, i0, i1, mv)
            self._last_matches = (self._prev_img, img, kp_prev, kp_cur,
                                  i0, i1, mv)
        self._prev_img = img
        # the global-BA milestone, keyed on the keyframe count with a dedup
        # so frames that add no keyframe never re-solve an unchanged map
        if self.cfg.gba_every and self.cfg.gba_enable and self.initialised:
            kfc = len(self.kfs)
            if (kfc > 0 and kfc % self.cfg.gba_every == 0
                    and kfc != self._last_gba_kf_count):
                self.run_global_ba()
                self._last_gba_kf_count = kfc
        return feats


def _host_assist_reloc(cfg: SLAMConfig, system: SLAMSystem, state, fc,
                       host: dict):
    """The fused loop's rescue after sustained loss, at a loop-closure
    sync: the device's global relocalisation sees only its keyframe ring,
    the host every keyframe and the landmark archive. Relocalise the newest
    synced keyframe that has features against the place-vector candidates
    over all keyframes (PnP on their landmarks, a 2x inlier gate), then put
    the pose and the matched region's landmarks (archived ones included,
    with descriptors from their observing keyframes) into free device map
    rows.

    The new device state is built before the host map is touched, so a
    rescue that raises leaves both as they were. Returns the new
    FusedState, or None if no rescue happened."""
    fl = host["log_flags"]
    n_log = int(host["log_n"])
    after = int(cfg.fused_rescue_after)
    if after <= 0 or n_log == 0:
        return None
    streak = 0
    for i in range(n_log - 1, -1, -1):
        if fl[i, 0] > 0.5:
            break
        streak += 1
    if streak < after:
        return None
    kf_q = next((kf for kf in reversed(system.kfs)
                 if int(kf.feats.valid.sum()) > 0), None)
    if kf_q is None or system.loop_closer is None:
        return None
    wm, lc, dev = system.world_map, system.loop_closer, system.device
    while len(system._place_vecs) < len(system.kfs):
        kf = system.kfs[len(system._place_vecs)]
        system._place_vecs.append(
            place_vector(kf.feats, system.img_hw, cfg.loop_grid))
    vec = place_vector(kf_q.feats, system.img_hw, cfg.loop_grid)
    sims = np.stack(system._place_vecs) @ vec
    order = [c for c in np.argsort(-sims)
             if system.kfs[int(c)].idx != kf_q.idx]
    kpts_q = kf_q.feats.kpts.cpu().numpy()
    for cand in order[: max(4, int(cfg.global_reloc_topk))]:
        if sims[cand] < cfg.global_reloc_min_sim:
            break
        kf_c = system.kfs[int(cand)]
        kp2pid = lc._kp2pid(wm, kf_c.idx)
        if len(kp2pid) < cfg.pnp_min_inliers:
            continue                    # a dead-zone keyframe maps nothing
        m = frontend.feature_matcher(cfg, kf_c.feats, kf_q.feats,
                                     system.matcher)
        pts3d, pts2d = [], []
        for a, b, v in zip(m.idx0.cpu().numpy(), m.idx1.cpu().numpy(),
                           m.valid.cpu().numpy()):
            pid = kp2pid.get(int(a))
            if v and pid is not None:
                pts3d.append(lc._position_of(wm, pid).astype(np.float32))
                pts2d.append(kpts_q[int(b)])
        if len(pts3d) < cfg.pnp_min_inliers:
            continue
        M = len(pts3d)
        Mp = 1 << (max(M, 8) - 1).bit_length()
        P3 = np.zeros((Mp, 3), np.float32)
        P2 = np.zeros((Mp, 2), np.float32)
        val = np.zeros(Mp, bool)
        P3[:M], P2[:M], val[:M] = pts3d, pts2d, True
        T_r, _inl, n_inl, ok = pnp.solve_pnp_ransac(
            system._site_key(kf_q.frame_idx, SITE_GRELOC), system._t(P3),
            system._t(P2), torch.as_tensor(val, device=dev), system._K_t,
            cfg.ransac_thresh, Tcw_init=system._t(kf_c.pose),
            n_hyp=cfg.ransac_hypotheses)
        # a real revisit of a mapped region clears a 2x gate easily; a
        # junk-drift keyframe can pass a marginal PnP
        n_inl = int(n_inl)
        if not bool(ok) or n_inl < 2 * cfg.pnp_min_inliers:
            continue
        new, restore, n_new = _rescue_rows(system, state, fc, host,
                                           int(cand))
        T_r32 = T_r.to(torch.float32)
        new_state = replace(state, Tcw=T_r32.clone(),
                            Tcw_prev=T_r32.clone(),     # zero velocity
                            lost_streak=torch.zeros_like(state.lost_streak),
                            **new)
        # the host map changes only now that the device state is whole
        grey = np.full((3,), 0.7, np.float32)
        for pid, pos, created, obs in restore:
            del wm.archived[pid]
            if wm.upsert_point(pid, pos, colour=grey, keyframe_idx=created):
                mp = wm.points[pid]
                for (k, kp, d) in obs:
                    mp.add_observation(k, kp, d)
        if n_new:
            wm.version += 1
        logger.info(
            "[RESCUE] host-assisted reloc after %d lost frames: KF %d "
            "recovered via KF %d (sim %.3f, %d/%d inliers), %d landmarks "
            "re-injected (%d archived remain)", streak, kf_q.idx, kf_c.idx,
            float(sims[cand]), n_inl, M, n_new, len(wm.archived))
        return new_state
    return None


def _rescue_rows(system: SLAMSystem, state, fc, host: dict, cand: int):
    """The rescue's landmarks: those the keyframes ``cand - 2 .. cand + 2``
    observe that are not alive on the device (archived ones included),
    each with a descriptor of an observing keyframe, in free device rows
    (at most 2048). Returns (the state's new fields, what the host map must
    restore: (pid, position, created_kf, [(kf, kp, desc)]) per archived
    landmark, the number of rows filled); nothing is modified."""
    wm, lc, dev = system.world_map, system.loop_closer, system.device
    n_points = int(host["n_points"])
    dev_alive = {int(p) for p, a in zip(host["pid"][:n_points],
                                        host["alive"][:n_points]) if a}
    inject = {}
    for nb in range(max(0, cand - 2), min(len(system.kfs), cand + 3)):
        kf_n = system.kfs[nb]
        if int(kf_n.feats.valid.sum()) == 0:
            continue
        desc_n = kf_n.feats.desc.cpu().numpy()
        valid_n = kf_n.feats.valid.cpu().numpy()
        for kp, pid in lc._kp2pid(wm, kf_n.idx).items():
            if pid in dev_alive or pid in inject or kp >= len(desc_n) \
                    or not valid_n[kp]:
                continue
            inject[pid] = (lc._position_of(wm, pid), desc_n[kp])
    items = list(inject.items())[: min(fc.map_capacity - n_points, 2048)]
    if not items:
        return {}, [], 0
    n_i = len(items)
    rows = torch.arange(n_points, n_points + n_i, device=dev)

    def put(x, v):
        return x.index_copy(0, rows, v.to(x.dtype).expand(n_i, *x.shape[1:]))

    ring = state.desc_ring.index_select(0, rows)
    ring[:, 0] = torch.as_tensor(np.stack([d for _, (_p, d) in items]),
                                 device=dev).to(ring.dtype)
    one = torch.ones((), device=dev)
    new = dict(
        positions=put(state.positions, torch.as_tensor(
            np.stack([p for _, (p, _d) in items]).astype(np.float32),
            device=dev)),
        alive=put(state.alive, one), n_desc=put(state.n_desc, one),
        desc_ring=state.desc_ring.index_copy(0, rows, ring),
        obs_kf=put(state.obs_kf, -one), obs_n=put(state.obs_n, 0 * one),
        pid=put(state.pid, torch.as_tensor([p for p, _ in items],
                                           device=dev)),
        last_seen=put(state.last_seen, state.frame_no * one),
        n_points=torch.full((), n_points + n_i, dtype=state.n_points.dtype,
                            device=dev))
    restore, kf_desc = [], {}
    for pid, (pos, _d) in items:
        if pid not in wm.archived:
            continue
        _apos, obs_pairs, created = wm.archived[pid]
        obs = []
        for (k, kp) in obs_pairs:
            if k >= len(system.kfs):
                continue
            if k not in kf_desc:
                kf_desc[k] = system.kfs[k].feats.desc.cpu().numpy()
            if kp < len(kf_desc[k]):
                obs.append((k, kp, kf_desc[k][kp]))
        restore.append((pid, np.asarray(pos, np.float64), created, obs))
    return new, restore, n_i


def build_fused_loop(cfg: SLAMConfig, system: SLAMSystem,
                     prev_feats: Features, n_frames: int):
    """The fused loop's parts for a sequence of ``n_frames`` frames after
    ``system`` bootstrapped: (FusedConfig, step, post-bootstrap state).
    ``prev_feats``: the last host frame's features."""
    from simpleslam_tpu_torch.core.fused import (build_fused_step,
                                                 make_fused_config,
                                                 state_from_host)
    fc = make_fused_config(cfg, system.img_hw,
                           n_kp=int(prev_feats.kpts.shape[0]),
                           desc_dim=int(prev_feats.desc.shape[1]),
                           log_capacity=1 << max(10, n_frames.bit_length()))
    match_fn = getattr(system.matcher, "fn_fast", None) or system.matcher.fn
    step = build_fused_step(fc, system.K, system.detector.fn, match_fn,
                            system.device, system._undistort_maps)
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

    With ``cfg.loop_closure`` every ``fused_sync_every or 32`` frames is a
    real sync instead (the keyframes' features must reach the host before
    the ring overwrites them): ``LoopCloser.scan`` over the new keyframes,
    then on a closure global BA (``--gba_enable``) and the rewrite pushed
    to the device (``apply_host_correction``), else the host-assisted
    rescue (``_host_assist_reloc``; a rescue that raises is logged and the
    loop goes on unrescued). A last scan follows the final sync.

    Returns (final state, step); ``step.host_reads`` counts the step's
    branch reads."""
    from simpleslam_tpu_torch.core.fused import (apply_host_correction,
                                                 sync_to_host)
    fc, step, state = built or build_fused_loop(
        cfg, system, prev_feats, start_idx + len(frames))
    sync_every = int(cfg.fused_sync_every)
    loop_on = bool(cfg.loop_closure)
    lc_every = sync_every or 32
    log_consumed = 0
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
            if loop_on and n_dispatched % lc_every == 0:
                with system.timer.stage("fused_sync"):
                    host = sync_to_host(system, state, fc,
                                        from_row=log_consumed)
                    log_consumed = int(host["log_n"])
                with system.timer.stage("loop"):
                    closed = system.closer().scan(
                        system.kfs, system.world_map, system.img_hw,
                        system._site_key(log_consumed, SITE_LOOP))
                    if closed is not None:
                        if cfg.gba_enable:
                            system.run_global_ba()
                        state = apply_host_correction(state, system, fc,
                                                      host)
                    else:
                        # best effort: the device loop may still recover on
                        # its own (the reference's rule)
                        try:
                            rescued = _host_assist_reloc(cfg, system, state,
                                                         fc, host)
                        except Exception:
                            logger.exception("[RESCUE] host-assisted reloc "
                                             "failed; continuing unrescued")
                            rescued = None
                        if rescued is not None:
                            state = rescued
            elif sync_every and n_dispatched % sync_every == 0:
                with system.timer.stage("fused_sync"):
                    state.Tcw.cpu()           # observes every step so far
    with system.timer.stage("fused_sync"):
        host = sync_to_host(system, state, fc, from_row=log_consumed)
    if t_warm is not None and n_dispatched > 30:
        logger.info("[FUSED] sustained %.2f frames/s over %d post-warm-up "
                    "frames (%s syncs)",
                    (n_dispatched - 10) / (time.perf_counter() - t_warm),
                    n_dispatched - 10,
                    "periodic" if (loop_on or sync_every) else "no")
    system.kf_count_override = int(host["kf_count"])
    system._key = state.key
    if loop_on:
        # keyframes after the last periodic sync still get their chance;
        # the rewrite lands in the host map the results come from
        with system.timer.stage("loop"):
            closed = system.closer().scan(
                system.kfs, system.world_map, system.img_hw,
                system._site_key(int(host["log_n"]) + 1, SITE_LOOP))
            if closed is not None and cfg.gba_enable:
                system.run_global_ba()
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


def _show_driver_windows(system: SLAMSystem) -> None:
    """The live run's windows: the keyframe thumbnail strip, the
    previous-to-current match overlay and the track trails."""
    try:
        import cv2
    except ImportError:
        return
    from simpleslam_tpu_torch.viz.tracks import draw_tracks
    from simpleslam_tpu_torch.viz.windows import (build_kf_strip,
                                                  build_match_overlay)
    strip = build_kf_strip(system.kfs)
    if strip is not None:
        cv2.imshow("keyframes", strip)
    if system._last_matches is not None:
        prev_img, cur_img, kp0, kp1, i0, i1, mv = system._last_matches
        if prev_img is not None:
            overlay = build_match_overlay(prev_img, cur_img, kp0, kp1,
                                          i0, i1, mv)
            if overlay is not None:
                cv2.imshow("matches prev->cur", overlay)
        if system._trackbook is not None:
            img = cur_img.cpu().numpy() if torch.is_tensor(cur_img) \
                else np.asarray(cur_img)
            if img.ndim != 3:
                img = cv2.cvtColor(img.astype(np.uint8), cv2.COLOR_GRAY2BGR)
            cv2.imshow("tracks", draw_tracks(img, system._trackbook.tracks))
    cv2.waitKey(1)


def _check_state_flags(cfg: SLAMConfig) -> None:
    """The reference's refusals of flag combinations (ValueError)."""
    if cfg.localize_only and not cfg.resume:
        raise ValueError("--localize_only needs a map: pass --resume <state>")
    if cfg.localize_only and cfg.fused:
        raise ValueError("--localize_only runs the host driver (drop --fused)")
    if cfg.localize_only and cfg.save_state:
        # the run's poses are the localisation trajectory while the
        # keyframes keep the mapping run's frame indices: saved together
        # they would corrupt the keyframe -> frame mapping of a later resume
        raise ValueError("--localize_only does not modify the map; "
                         "drop --save_state (the resumed state is canonical)")


def _resume(cfg: SLAMConfig, seq: Dataset, system: SLAMSystem):
    """Load ``cfg.resume`` into ``system``: -> (prev_feats, start_idx).
    Mapping continues at the frame after the saved ``frame_ids[-1]`` with
    that frame's features re-extracted; ``--localize_only`` keeps the
    landmarks and keyframes, drops the saved trajectory and starts at
    frame 0, kidnapped."""
    from simpleslam_tpu_torch.utils.serialize import load_state
    m, kfs, _cfgd, frame_ids = load_state(cfg.resume, device=system.device)
    system.world_map = m
    system.kfs = kfs
    system.frame_ids = frame_ids
    system.initialised = len(kfs) >= 2
    system.last_kf_frame_no = kfs[-1].frame_idx if kfs else -999
    if cfg.localize_only:
        if not kfs:
            raise ValueError("resumed state has no keyframes to "
                             "localize against")
        m.poses = []
        m.keyframe_indices = []
        system.frame_ids = []
        system.initialised = True
        prev_feats = system.process_frame(0, seq.frame(0), None)
        logger.info("localize-only against %s: %d KFs, %d landmarks "
                    "(map frozen)", cfg.resume, len(kfs), len(m))
        return prev_feats, 1
    last = frame_ids[-1] if frame_ids else 0
    img_last = system.preprocess(seq.frame(last))
    prev_feats = system.extract(img_last)
    system._prev_img = img_last
    logger.info("resumed from %s: %d poses, %d KFs, %d landmarks; "
                "continuing at frame %d", cfg.resume, len(m.poses),
                len(kfs), len(m), last + 1)
    return prev_feats, last + 1


def run(cfg: SLAMConfig, device=None, key=None) -> SLAMResult:
    """The CLI's run over ``cfg.dataset`` under ``cfg.base_dir``: the host
    pipeline frame by frame, or with ``cfg.fused`` the host bootstrap and
    then the fused device loop. ``device``: None is the GPU (raises without
    one), "cpu" the CPU. ``key``: the randomness source (``utils/rng.py``;
    default a ``TorchKey`` of ``cfg.seed``). Logs the ATE line (against the dataset's ground
    truth), ``done: ...`` and the per-stage breakdown, and tries to save
    ``trajectory_<dataset>.png`` (needs matplotlib; a warning without).
    ``cfg.resume``: start from a saved state (:func:`_resume`);
    ``cfg.save_state``: write the state at the end, and stop after the
    frame in flight on SIGINT (the host loop). Without ``cfg.headless``
    the host loop updates the live windows after each frame (a failure
    there is logged as ``viz failed``, as without matplotlib) and stops
    when the keyboard UI quits; the fused loop shows none.
    ``cfg.trace_dir``: record the frame loop under ``torch.profiler`` and
    write its Chrome trace and span summary there
    (``utils/profiling.py::torch_trace``)."""
    _check_state_flags(cfg)
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
                        device=device, key=key)
    headless = cfg.headless
    system.want_viz = not headless
    traj2d = Trajectory2D(gt44, dataset=cfg.dataset, live=not headless)
    viz3d = Visualizer3D(enabled=not (cfg.no_viz3d or headless))
    ui = VizUI(enabled=not headless)

    def push_poses(frame_idx):
        while len(traj2d.est) < len(system.world_map.poses):
            i = len(traj2d.est)
            fid = (system.frame_ids[i] if i < len(system.frame_ids)
                   else frame_idx)
            traj2d.push(fid, system.world_map.poses[i])

    t_start = time.perf_counter()
    n = len(seq)
    if cfg.resume:
        prev_feats, start_idx = _resume(cfg, seq, system)
    else:
        prev_feats, start_idx = system.process_frame(0, img0, None), 1

    # SIGINT: finish the frame in flight, save the state, then report
    stop = []

    def on_sigint(_sig, _frame):
        stop.append(True)
        logger.warning("SIGINT: stopping after this frame; state -> %s",
                       cfg.save_state)
    old_handler = (signal.signal(signal.SIGINT, on_sigint)
                   if cfg.save_state else None)

    with torch_trace(cfg.trace_dir):
        try:
            frame_idx = start_idx - 1
            if cfg.fused:
                # the host bootstraps, then the fused device loop takes
                # the rest
                if not system.initialised:
                    for frame_idx in range(start_idx, n):
                        with system.timer.stage("frame_load"):
                            img = seq.frame(frame_idx)
                        prev_feats = system.process_frame(frame_idx, img,
                                                          prev_feats)
                        if system.initialised:
                            break
                    start_idx = frame_idx + 1
                if system.initialised and start_idx < n:
                    _run_fused_over(cfg, seq, system, prev_feats, start_idx)
                if system.initialised and system.world_map.poses:
                    push_poses(frame_idx)
                start_idx = n
            for frame_idx in range(start_idx, n):
                if stop:
                    break
                with system.timer.stage("frame_load"):
                    img = seq.frame(frame_idx)
                prev_feats = system.process_frame(frame_idx, img, prev_feats)
                if system.initialised and system.world_map.poses:
                    push_poses(frame_idx)
                if not headless:
                    try:
                        viz3d.update(
                            system.world_map.get_point_array(),
                            system.world_map.get_color_array(),
                            np.asarray([-p[:3, :3].T @ p[:3, 3]
                                        for p in system.world_map.poses]))
                        traj2d.draw()
                        _show_driver_windows(system)
                    except Exception as e:
                        logger.warning("viz failed: %s", e)
                    if not ui.poll():
                        break
        finally:
            if old_handler is not None:
                signal.signal(signal.SIGINT, old_handler)
        dt = time.perf_counter() - t_start        # before the trace's export
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
                   if i < len(system.frame_ids)],
        loop_closures=(len(system.loop_closer.closures)
                       if system.loop_closer is not None else 0),
        closure_events=(list(system.loop_closer.closures)
                        if system.loop_closer is not None else []),
        gba_runs=system.gba_runs)

    out_png = f"trajectory_{cfg.dataset}.png"
    try:
        traj2d.save(out_png)
        logger.info("saved %s", out_png)
    except Exception as e:
        logger.warning("could not save trajectory png: %s", e)
    if cfg.save_state:
        try:
            from simpleslam_tpu_torch.utils.serialize import save_state
            save_state(cfg.save_state, system.world_map, system.kfs, cfg,
                       system.frame_ids)
            logger.info("saved pipeline state to %s", cfg.save_state)
        except Exception:
            # the run's result still stands (the reference's rule)
            logger.exception("could not save state to %s", cfg.save_state)
    ui.close()
    viz3d.close()

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
    if cfg.loop_closure:
        logger.info("loop closures accepted: %d; archived landmarks: %d "
                    "(cap %d)", res.loop_closures,
                    len(system.world_map.archived),
                    system.world_map.archive_cap)
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
