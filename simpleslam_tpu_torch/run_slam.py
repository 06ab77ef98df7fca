"""The SLAM system's per-frame state machine on the host (the counterpart of
``simpleslam_tpu/run_slam.py::SLAMSystem``).

Delayed two-view bootstrap -> frame-to-map PnP tracking (widened-window
retry, keyframe relocalisation, global relocalisation, 2D-2D essential
fallback) -> keyframe policy -> KF-pair triangulation -> local bundle
adjustment. Tensors live on the system's device; the map and the decisions
live on the host. Not ported yet (they raise or are absent): lens
undistortion, loop closure, global BA, the fused device loop,
localisation-only mode with a resumed map, the CLI ``run``/``main`` with
its dataloader, and visualisation.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Mapping, Optional, Tuple

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
from simpleslam_tpu_torch.ops import epipolar, pnp, se3
from simpleslam_tpu_torch.utils.device import resolve_device
from simpleslam_tpu_torch.utils.profiling import StageTimer
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


class SLAMSystem:
    """The live pipeline, reusable by tests and benchmarks.

    ``device``: None runs on CUDA and raises without it; pass "cpu" to run
    on the CPU. ``key``: the randomness source (``utils/rng.py``; default a
    ``TorchKey`` seeded from ``cfg.seed``). ``weights``: optional
    (aliked_state_dict, lightglue_state_dict), seeded weights otherwise.

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
        desc_dim = self.kfs[-1].feats.desc.shape[1] if self.kfs else 32
        host = self.world_map.snapshot(self.cfg.map_capacity, desc_dim,
                                       np.float32)
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
                max_l2=cfg.match_max_l2)
            n_cand = int(assoc.valid.sum())
            if n_cand < cfg.pnp_min_inliers:
                return None, f"too few 2D-3D candidates ({n_cand})", assoc
            T_est, inl, n_inl, ok = pnp.solve_pnp_ransac(
                self._site_key(frame_idx, SITE_PNP), snap["positions"],
                feats.kpts[assoc.kp_idx], assoc.valid, self._K_t,
                cfg.ransac_thresh, Tcw_init=T_pred_t,
                n_hyp=cfg.ransac_hypotheses)
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
            except (RuntimeError, ValueError) as e:
                # BA must never kill tracking (the reference's rule)
                logger.warning("[Local BA] failed: %s", e)
        return len(new_ids)

    # ------------------------------------------------------------ main step
    def process_frame(self, frame_idx: int, img,
                      prev_feats: Optional[Features]) -> Features:
        """One frame of the pipeline; returns this frame's features (the
        caller passes them back as ``prev_feats`` for the next frame)."""
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
