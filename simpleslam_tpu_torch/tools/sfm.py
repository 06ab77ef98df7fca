"""Offline incremental structure-from-motion, the batch API (the
counterpart of ``simpleslam_tpu/tools/sfm.py``): a keyframe pre-pass by
match-survival ratio, essential-matrix pose chaining with a baseline
proportional to the frame gap, keyframe-pair triangulation into a Map,
optional global bundle adjustment, ATE/RTE and checkpoint PNGs.

Usage:
    sfm = StructureFromMotion(cfg, K)            # device=None: the GPU
    sfm.add_frames(frames)              # images (arrays or tensors) or paths
    result = sfm.run(gt_T=None, out_dir=None)

With ``mesh=`` (``parallel/mesh.py``) the pre-pass extracts every frame in
one batch split over the mesh's 'dp' axis (``parallel/batch.py``).
RANSAC draws come from ``key`` (default ``TorchKey(cfg.seed)``), split
once per draw in the reference's order. The PNGs need matplotlib.
"""
from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from simpleslam_tpu_torch.core import frontend
from simpleslam_tpu_torch.core.ba import global_bundle_adjustment
from simpleslam_tpu_torch.core.keyframe import Keyframe
from simpleslam_tpu_torch.core.map import Map
from simpleslam_tpu_torch.core.triangulate import \
    triangulate_between_kfs_2view
from simpleslam_tpu_torch.ops import epipolar, se3
from simpleslam_tpu_torch.tools.trajectory_eval import ate_rmse, rte
from simpleslam_tpu_torch.utils.rng import TorchKey
from simpleslam_tpu_torch.viz.trajectory2d import Trajectory2D

logger = logging.getLogger("sfm")


@dataclass
class SfMResult:
    poses_cw: List[np.ndarray] = field(default_factory=list)
    kf_frames: List[int] = field(default_factory=list)
    n_landmarks: int = 0
    ate: Optional[float] = None
    rte_trans: Optional[float] = None
    rte_rot_deg: Optional[float] = None


class StructureFromMotion:
    """Keyframe pre-pass -> E-chained poses -> triangulation -> global BA."""

    def __init__(self, cfg, K, kf_survival: float = 0.55,
                 kf_min_gap: int = 1, kf_max_gap: int = 10, mesh=None,
                 device=None, weights=None, key=None):
        self.cfg = cfg
        self.K = np.asarray(K, np.float64)
        self.detector, self.matcher = frontend.init_feature_pipeline(
            cfg, device=device, weights=weights)
        self.device = self.detector.device
        self.kf_survival = float(kf_survival)
        self.kf_min_gap = int(kf_min_gap)
        self.kf_max_gap = int(kf_max_gap)
        self.mesh = mesh          # a DeviceMesh: split the pre-pass's
                                  # extraction over its 'dp' axis
        self._frames: List = []
        self._key = key if key is not None else TorchKey(cfg.seed)

    def _k(self):
        self._key, k = self._key.split()
        return k

    def add_frames(self, frames) -> None:
        self._frames.extend(frames)

    def _load(self, f):
        if isinstance(f, (np.ndarray, torch.Tensor)):
            return f
        from simpleslam_tpu_torch.data.dataloader import imread_bgr
        return imread_bgr(f)

    # ----------------------------------------------------------- pipeline
    def _extract_all(self):
        """Per-frame features; with a mesh, one batched extraction split
        over the 'dp' axis (frames are independent, so extraction is the
        fan-out axis)."""
        if self.mesh is None:
            return [frontend.feature_extractor(self.cfg, self._load(f),
                                               self.detector)
                    for f in self._frames]

        from simpleslam_tpu_torch.models import aliked as aliked_mod
        from simpleslam_tpu_torch.ops.features import rgb_to_gray
        from simpleslam_tpu_torch.parallel.batch import (
            sharded_extract, sharded_extract_classical)
        from simpleslam_tpu_torch.parallel.mesh import axis_size

        imgs = [torch.as_tensor(self._load(f), device=self.device)
                for f in self._frames]
        grays = torch.stack([rgb_to_gray(im) if im.dim() == 3
                             else im.float() for im in imgs])
        F = grays.shape[0]
        pad = (-F) % (axis_size(self.mesh, "dp")
                      * axis_size(self.mesh, "tp"))
        if pad:
            grays = torch.cat([grays, grays[-1:].expand(pad, -1, -1)])
        if getattr(self.detector, "learned", False):
            self.detector.image_hw = tuple(grays.shape[1:3])  # matcher
            # padded to multiples of 8 as the per-frame path pads them, so
            # both pre-passes see the same images (the reference's batch
            # feeds the frames unpadded, and on a 370x1226 frame its
            # batched keypoints then differ from its per-frame ones)
            images = torch.stack([aliked_mod.preprocess_image(g)
                                  for g in grays])
            fb = sharded_extract(self.detector.model, images, self.mesh,
                                 max_kp=self.detector.max_kp)
        else:
            fb = sharded_extract_classical(self.detector.fn, grays,
                                           self.mesh)
        return [fb.at(i) for i in range(F)]

    def _keyframe_prepass(self):
        """Select keyframes by match-survival ratio against the last
        keyframe."""
        feats = self._extract_all()
        kf_ids = [0]
        last = 0
        n_last = max(int(feats[0].valid.sum()), 1)
        for i in range(1, len(feats)):
            m = frontend.match_with_ransac(self.cfg, self.matcher,
                                           feats[last], feats[i],
                                           key=self._k())
            surv = int(m.valid.sum()) / n_last
            gap = i - last
            if (gap >= self.kf_min_gap
                    and (surv < self.kf_survival or gap >= self.kf_max_gap)):
                kf_ids.append(i)
                last = i
                n_last = max(int(feats[i].valid.sum()), 1)
        if kf_ids[-1] != len(feats) - 1:
            kf_ids.append(len(feats) - 1)
        logger.info("[SfM] keyframe pre-pass: %d/%d frames kept",
                    len(kf_ids), len(feats))
        return kf_ids, feats

    def run(self, gt_T: Optional[np.ndarray] = None,
            out_dir: Optional[str] = None,
            run_gba: bool = True, checkpoint_every: int = 0) -> SfMResult:
        cfg = self.cfg
        Kt = torch.as_tensor(self.K, dtype=torch.float32, device=self.device)
        kf_ids, feats = self._keyframe_prepass()

        world_map = Map()
        kfs: List[Keyframe] = []
        poses = [np.eye(4)]
        world_map.add_pose(poses[0], is_keyframe=True)
        kfs.append(Keyframe(0, kf_ids[0], "", feats[kf_ids[0]], poses[0],
                            b""))

        for n, fid in enumerate(kf_ids[1:], start=1):
            prev = kfs[-1]
            # constant-velocity scale: |t| proportional to the frame gap
            # (E gives the direction only)
            last_baseline = float(fid - kfs[-1].frame_idx)
            m = frontend.match_with_ransac(cfg, self.matcher, prev.feats,
                                           feats[fid], key=self._k())
            p0 = prev.feats.kpts[m.idx0]
            p1 = feats[fid].kpts[m.idx1]
            E, inl, ok = epipolar.find_essential(
                self._k(), p0, p1, m.valid, Kt, cfg.ransac_thresh,
                n_hyp=cfg.ransac_hypotheses)
            if not bool(ok):
                logger.warning("[SfM] E failed at KF %d; keeping last pose",
                               n)
                T_new = poses[-1].copy()
            else:
                R, t, _good, _ = epipolar.recover_pose_essential(
                    E, p0, p1, inl, Kt)
                T_rel = se3.rt_to_T(R, t * last_baseline).cpu().numpy() \
                    .astype(np.float64)
                T_new = T_rel @ prev.pose
            poses.append(T_new)
            world_map.add_pose(T_new, is_keyframe=True)
            kfs.append(Keyframe(n, fid, "", feats[fid], T_new, b""))
            new_ids = triangulate_between_kfs_2view(
                cfg, self.K, kfs[-2], kfs[-1], world_map, self.matcher,
                parallax_min_deg=cfg.triangulation_parallax_min_deg,
                key=self._k())
            logger.info("[SfM] KF %d (frame %d): +%d landmarks (map %d)",
                        n, fid, len(new_ids), len(world_map))

            if checkpoint_every and out_dir and n % checkpoint_every == 0:
                self._save_checkpoint_png(out_dir, n, poses, gt_T)

        if run_gba and len(kfs) >= 3 and len(world_map) >= 30:
            try:
                global_bundle_adjustment(world_map, self.K, kfs,
                                         max_iters=cfg.gba_max_iters,
                                         fix_first=bool(cfg.gba_fix_first))
                poses = [np.asarray(kf.pose) for kf in kfs]
            except Exception as e:
                logger.warning("[SfM] global BA failed: %s", e)

        res = SfMResult(poses_cw=poses, kf_frames=list(kf_ids),
                        n_landmarks=len(world_map))
        if gt_T is not None:
            gt44 = np.tile(np.eye(4), (len(gt_T), 1, 1))
            gt44[:, :3, :4] = np.asarray(gt_T)[:, :3, :4]
            gt_sel = gt44[[min(f, len(gt44) - 1) for f in kf_ids]]
            res.ate, _ = ate_rmse(np.stack(poses), gt_sel, align="sim3")
            te, re_ = rte(np.stack(poses), gt_sel)
            res.rte_trans = float(te.mean()) if len(te) else None
            res.rte_rot_deg = float(re_.mean()) if len(re_) else None
            logger.info("[SfM] ATE %.4f m  RTE %.4f m / %.3f deg",
                        res.ate, res.rte_trans or 0.0, res.rte_rot_deg or 0.0)
        if out_dir:
            self._save_checkpoint_png(out_dir, len(kf_ids), poses, gt_T,
                                      final=True)
        return res

    def _save_checkpoint_png(self, out_dir, n, poses, gt_T, final=False):
        os.makedirs(out_dir, exist_ok=True)
        gt44 = None
        if gt_T is not None:
            gt44 = np.tile(np.eye(4), (len(gt_T), 1, 1))
            gt44[:, :3, :4] = np.asarray(gt_T)[:, :3, :4]
        traj = Trajectory2D(gt44, dataset="sfm")
        for i, T in enumerate(poses):
            traj.push(i, T)
        name = "sfm_final.png" if final else f"sfm_checkpoint_{n:03d}.png"
        traj.save(os.path.join(out_dir, name))
