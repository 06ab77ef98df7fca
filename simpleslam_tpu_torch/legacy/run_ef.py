"""Legacy driver 1: per-frame 2D-2D E-vs-H tracking, no PnP (the
counterpart of ``simpleslam_tpu/legacy/run_ef.py``).

  * match previous <-> current frame and F-RANSAC at 1.0 px; fewer than 8
    matches dead-reckon (the previous pose is kept);
  * estimate E (RANSAC, 3.0 px) and H (RANSAC, 2.0 px) every frame;
  * the median rotation-compensated parallax of each model;
  * a rotation-only update when the homography dominates and the parallax
    is at most 1.2 degrees, else the full R and unit t scaled by the last
    baseline (fixed at 1.0, as in the reference);
  * a pose-only BA each frame when a landmark map exists. The tracker never
    appends to ``kfs``, so that branch never runs, in the reference too.

Run: python -m simpleslam_tpu_torch.legacy.run_ef --dataset kitti \
         --base_dir <dir> --headless [--device cpu]
"""
from __future__ import annotations

import logging
import time
from typing import List

import numpy as np
import torch

from simpleslam_tpu_torch.config import SLAMConfig, build_parser, parse_config
from simpleslam_tpu_torch.core import frontend
from simpleslam_tpu_torch.core.ba import pose_only_ba
from simpleslam_tpu_torch.core.map import Map
from simpleslam_tpu_torch.core.types import Features
from simpleslam_tpu_torch.data import Sequence
from simpleslam_tpu_torch.ops import epipolar, se3
from simpleslam_tpu_torch.ops.maskops import masked_median
from simpleslam_tpu_torch.ops.triangulation import (projection_matrix,
                                                    triangulate_two_view)
from simpleslam_tpu_torch.utils.device import resolve_device
from simpleslam_tpu_torch.utils.precision import highest_precision
from simpleslam_tpu_torch.utils.rng import TorchKey
from simpleslam_tpu_torch.viz import Trajectory2D

logger = logging.getLogger("legacy_ef")

PARALLAX_THR_DEG = 1.2     # the reference's "parallax_thr"


@highest_precision()
def median_parallax_deg(K: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor,
                        R: torch.Tensor, mask: torch.Tensor) -> float:
    """Median rotation-compensated ray angle (degrees) over ``mask``."""
    Kinv = torch.linalg.inv(K.float())
    ones = torch.ones_like(p0[:, :1])
    u0 = torch.cat([p0, ones], 1) @ Kinv.T
    u1 = torch.cat([p1, ones], 1) @ Kinv.T
    u0 = u0 / torch.linalg.norm(u0, dim=1, keepdim=True)
    u1 = u1 / torch.linalg.norm(u1, dim=1, keepdim=True)
    Ru0 = u0 @ R.float().T
    ang = torch.rad2deg(torch.arccos(torch.clamp((Ru0 * u1).sum(1), -1, 1)))
    return float(masked_median(ang, mask))


@highest_precision()
def best_h_decomposition(H: torch.Tensor, K: torch.Tensor, p0: torch.Tensor,
                         p1: torch.Tensor, inl: torch.Tensor):
    """The homography's (R, t) candidate with the most points in front of
    both cameras -> (R, t, count) on the host."""
    Rs, ts, _ = epipolar.decompose_homography(H, K)
    P0 = projection_matrix(K, torch.eye(4, device=K.device))
    counts = []
    for R, t in zip(Rs, ts):
        P1 = projection_matrix(K, se3.rt_to_T(R, t))
        X = triangulate_two_view(P0, P1, p0, p1)
        z1 = (X @ R.T + t)[:, 2]
        counts.append(((X[:, 2] > 0) & (z1 > 0) & inl).sum())
    counts = torch.stack(counts)
    b = int(torch.argmax(counts))
    return Rs[b].cpu().numpy(), ts[b].cpu().numpy(), int(counts[b])


class EFTracker:
    """Frame-sequential E/H tracker (used by the CLI and the tests).
    ``device``: None is the GPU (raises without one), "cpu" the CPU;
    ``key``: the randomness source of the RANSAC draws (``utils/rng.py``;
    default a ``TorchKey`` of ``cfg.seed``). Counters: ``n_rot_only``,
    ``n_full`` and ``n_deadreckon`` updates."""

    def __init__(self, cfg: SLAMConfig, K, device=None, key=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.K = np.asarray(K, np.float64)
        self._K_t = torch.as_tensor(self.K, dtype=torch.float32,
                                    device=self.device)
        self.detector, self.matcher = frontend.init_feature_pipeline(
            cfg, device=self.device)
        self.world_map = Map()
        self.world_map.add_pose(np.eye(4), is_keyframe=True)
        self.kfs: List = []
        self._key = key if key is not None else TorchKey(cfg.seed)
        self.n_rot_only = 0
        self.n_full = 0
        self.n_deadreckon = 0

    def _k(self):
        self._key, k = self._key.split()
        return k

    def _dead_reckon(self) -> None:
        self.world_map.add_pose(self.world_map.poses[-1].copy(), False)
        self.n_deadreckon += 1

    def step(self, frame_idx: int, prev_feats: Features,
             feats: Features) -> None:
        cfg, Kt = self.cfg, self._K_t
        m = frontend.feature_matcher(cfg, prev_feats, feats, self.matcher)
        m = frontend.filter_matches_ransac(prev_feats, feats, m, 1.0,
                                           key=self._k())
        n_m = int(m.valid.sum())
        if n_m < 8:
            logger.warning("[Track] Too few matches for E/F: %d", n_m)
            self._dead_reckon()
            return

        p0 = prev_feats.kpts[m.idx0]
        p1 = feats.kpts[m.idx1]

        E, inlE, okE = epipolar.find_essential(
            self._k(), p0, p1, m.valid, Kt, 3.0, n_hyp=cfg.ransac_hypotheses)
        nE = int(inlE.sum()) if bool(okE) else 0
        R_E = t_E = maskE = None
        if bool(okE) and nE >= 8:
            R_E, t_E, maskE, _ = epipolar.recover_pose_essential(
                E, p0, p1, inlE, Kt)

        Hm, inlH, okH = epipolar.find_homography(
            self._k(), p0, p1, m.valid, 2.0, n_hyp=cfg.ransac_hypotheses)
        nH = int(inlH.sum()) if bool(okH) else 0
        R_H = None
        if bool(okH) and nH >= 4:
            R_H, _t_H, _cnt = best_h_decomposition(Hm, Kt, p0, p1, inlH)

        parE = (median_parallax_deg(Kt, p0, p1, R_E, maskE)
                if R_E is not None else 999.0)
        parH = (median_parallax_deg(Kt, p0, p1, torch.as_tensor(
            R_H, device=self.device), inlH) if R_H is not None else 999.0)
        logger.debug("[Track] inliers E=%d H=%d parE=%.2f parH=%.2f",
                     nE, nH, parE, parH)

        use_rot_only = (
            (nH >= max(30, int(1.1 * nE)) and parH <= PARALLAX_THR_DEG)
            or (R_E is not None and parE <= PARALLAX_THR_DEG
                and nH >= max(20, int(0.8 * nE))))

        if use_rot_only and R_H is not None:
            T_rel = se3.rt_to_T(torch.as_tensor(R_H, dtype=torch.float32),
                                torch.zeros(3)).numpy().astype(np.float64)
            self.n_rot_only += 1
        elif R_E is not None and nE >= 5:
            last_baseline = 1.0        # fixed in the reference
            T_rel = se3.rt_to_T(R_E, t_E * last_baseline
                                ).cpu().numpy().astype(np.float64)
            self.n_full += 1
        else:
            self._dead_reckon()
            return

        self.world_map.add_pose(T_rel @ self.world_map.poses[-1],
                                is_keyframe=False)

        # pose-only BA each frame when a landmark map exists
        if self.kfs and len(self.world_map) >= 10:
            try:
                pose_only_ba(self.world_map, self.K, self.kfs,
                             kf_idx=len(self.kfs) - 1)
            except Exception as e:
                logger.debug("pose-only BA skipped: %s", e)


def _gt44(seq):
    if seq.gt is None:
        return None
    gt44 = np.tile(np.eye(4), (len(seq.gt), 1, 1))
    gt44[:, :3, :4] = seq.gt
    return gt44


def save_trajectory(traj: Trajectory2D, path: str) -> None:
    """Write the trajectory plot; a warning where it cannot (matplotlib
    missing)."""
    try:
        traj.save(path)
        logger.info("saved %s", path)
    except Exception as e:
        logger.warning("could not save trajectory png: %s", e)


def run(cfg: SLAMConfig, device=None, key=None) -> EFTracker:
    """The E/H tracker over ``cfg.dataset`` under ``cfg.base_dir``; writes
    ``trajectory_<dataset>_ef.png`` and logs the counts and frames/s.
    ``device``: None is the GPU (raises without one), "cpu" the CPU."""
    logging.basicConfig(level=logging.INFO)
    logger.setLevel(logging.INFO)
    seq = Sequence.load(cfg)
    tracker = EFTracker(cfg, seq.K, device=device, key=key)
    traj = Trajectory2D(_gt44(seq), dataset=cfg.dataset)
    t0 = time.perf_counter()
    prev = frontend.feature_extractor(cfg, seq.frame(0), tracker.detector)
    traj.push(0, np.eye(4))
    for i in range(1, len(seq)):
        feats = frontend.feature_extractor(cfg, seq.frame(i),
                                           tracker.detector)
        tracker.step(i, prev, feats)
        traj.push(i, tracker.world_map.poses[-1])
        prev = feats
    fps = len(seq) / max(time.perf_counter() - t0, 1e-9)
    save_trajectory(traj, f"trajectory_{cfg.dataset}_ef.png")
    poses = np.stack(tracker.world_map.poses)
    logger.info("legacy E/F done: %d poses (%d finite) (%d rot-only, %d "
                "full, %d dead), %.2f FPS", len(poses),
                int(np.isfinite(poses).all(axis=(1, 2)).sum()),
                tracker.n_rot_only, tracker.n_full, tracker.n_deadreckon, fps)
    return tracker


def main(argv=None) -> int:
    """``python -m simpleslam_tpu_torch.legacy.run_ef [flags]``: the
    reference's flags plus ``--device`` (default: the GPU)."""
    run(parse_config(argv), device=build_parser().parse_args(argv).device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
