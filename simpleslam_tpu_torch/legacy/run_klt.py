"""Legacy driver 2: pyramidal KLT optical-flow tracking (the counterpart of
``simpleslam_tpu/legacy/run_klt.py``).

  * tracked points flow frame to frame by pyramidal LK with
    forward-backward consistency and photometric-error gates;
  * when the live track count drops below a floor, re-seed from fresh
    keypoints;
  * the model per frame by inlier count: the homography wins at
    nH > 1.5 nE, with a rotation-only update, else the full R and unit t;
  * ageing KLT trails through the track overlay (``viz.draw_tracks``).

Run: python -m simpleslam_tpu_torch.legacy.run_klt --dataset kitti \
         --base_dir <dir> --headless [--device cpu]
"""
from __future__ import annotations

import logging
import time
from typing import Dict, List

import numpy as np
import torch

from simpleslam_tpu_torch.config import SLAMConfig, build_parser, parse_config
from simpleslam_tpu_torch.core import frontend
from simpleslam_tpu_torch.core.map import Map
from simpleslam_tpu_torch.data import Sequence
from simpleslam_tpu_torch.legacy.run_ef import (_gt44, best_h_decomposition,
                                                save_trajectory)
from simpleslam_tpu_torch.ops import epipolar, se3
from simpleslam_tpu_torch.ops.features import rgb_to_gray
from simpleslam_tpu_torch.ops.klt import fb_track
from simpleslam_tpu_torch.utils.device import resolve_device
from simpleslam_tpu_torch.utils.rng import TorchKey
from simpleslam_tpu_torch.viz import Trajectory2D, draw_tracks

logger = logging.getLogger("legacy_klt")


class KLTTracker:
    """KLT tracker (used by the CLI and the tests). ``device``: None is the
    GPU (raises without one), "cpu" the CPU; ``key``: the randomness source
    of the RANSAC draws (``utils/rng.py``; default a ``TorchKey`` of
    ``cfg.seed``). Counters: ``n_rot_only``, ``n_full`` updates and
    ``n_reseed`` seedings (the first included)."""

    def __init__(self, cfg: SLAMConfig, K, min_tracks: int = 150,
                 device=None, key=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.K = np.asarray(K, np.float64)
        self._K_t = torch.as_tensor(self.K, dtype=torch.float32,
                                    device=self.device)
        self.min_tracks = min_tracks
        self.detector, self.matcher = frontend.init_feature_pipeline(
            cfg, device=self.device)
        self.world_map = Map()
        self.world_map.add_pose(np.eye(4), is_keyframe=True)
        self.pts: np.ndarray = np.zeros((0, 2), np.float32)
        self.track_ids: np.ndarray = np.zeros((0,), np.int64)
        self._next_tid = 0
        self.trails: Dict[int, List] = {}
        self._key = key if key is not None else TorchKey(cfg.seed)
        self.n_rot_only = 0
        self.n_full = 0
        self.n_reseed = 0

    def _k(self):
        self._key, k = self._key.split()
        return k

    def _gray(self, img) -> torch.Tensor:
        img = torch.as_tensor(img if torch.is_tensor(img) else
                              np.asarray(img), device=self.device)
        return rgb_to_gray(img) if img.dim() == 3 else img.float()

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def seed(self, img) -> None:
        """Replace the tracks by the frame's keypoints."""
        feats = frontend.feature_extractor(self.cfg, img, self.detector)
        v = feats.valid.cpu().numpy()
        self.pts = feats.kpts.cpu().numpy()[v].astype(np.float32)
        self.track_ids = np.arange(self._next_tid,
                                   self._next_tid + len(self.pts))
        self._next_tid += len(self.pts)
        for tid, p in zip(self.track_ids, self.pts):
            self.trails[int(tid)] = [tuple(p)]
        self.n_reseed += 1

    def step(self, img_prev, img_cur) -> None:
        g0 = self._gray(img_prev)
        g1 = self._gray(img_cur)
        if len(self.pts) < 8:
            self.seed(img_prev)
        n = len(self.pts)
        # a power-of-two bucket of at least 256 rows: the padding is part
        # of the RANSAC draws' sample space, as in the reference
        cap = max(256, 1 << (n - 1).bit_length())
        pad = np.zeros((cap, 2), np.float32)
        pad[:n] = self.pts
        p1, good, _err = fb_track(g0, g1, self._t(pad), fb_thresh=1.0,
                                  err_thresh=25.0)
        p1 = p1.cpu().numpy()[:n]
        good = good.cpu().numpy()[:n]

        if good.sum() >= 8:
            q0 = self._t(pad)
            q1 = self._t(np.vstack([p1, np.zeros((cap - n, 2), np.float32)]))
            gmask = self._t(np.concatenate([good, np.zeros(cap - n, bool)]))
            Kt = self._K_t
            E, inlE, okE = epipolar.find_essential(
                self._k(), q0, q1, gmask, Kt, 2.0,
                n_hyp=self.cfg.ransac_hypotheses)
            nE = int(inlE.sum()) if bool(okE) else 0
            Hm, inlH, okH = epipolar.find_homography(
                self._k(), q0, q1, gmask, 2.0,
                n_hyp=self.cfg.ransac_hypotheses)
            nH = int(inlH.sum()) if bool(okH) else 0

            # the homography dominates at nH > 1.5 nE
            if bool(okH) and nH > 1.5 * max(nE, 1):
                R, _t, _ = best_h_decomposition(Hm, Kt, q0, q1, inlH)
                T_rel = se3.rt_to_T(torch.as_tensor(R, dtype=torch.float32),
                                    torch.zeros(3)).numpy().astype(np.float64)
                self.n_rot_only += 1
            elif bool(okE) and nE >= 8:
                R, t, _, _ = epipolar.recover_pose_essential(E, q0, q1, inlE,
                                                             Kt)
                T_rel = se3.rt_to_T(R, t).cpu().numpy().astype(np.float64)
                self.n_full += 1
            else:
                T_rel = np.eye(4)
            self.world_map.add_pose(T_rel @ self.world_map.poses[-1], False)
        else:
            self.world_map.add_pose(self.world_map.poses[-1].copy(), False)

        # carry the surviving tracks forward, with their trails
        self.pts = p1[good].astype(np.float32)
        self.track_ids = self.track_ids[good]
        for tid, p in zip(self.track_ids, self.pts):
            self.trails.setdefault(int(tid), []).append(tuple(p))

        # re-seed when the track pool runs low
        if len(self.pts) < self.min_tracks:
            self.seed(img_cur)

    def overlay(self, img_cur) -> np.ndarray:
        """The live tracks' trails drawn on a BGR copy of ``img_cur``."""
        live = {int(t): self.trails[int(t)] for t in self.track_ids
                if int(t) in self.trails}
        img = (img_cur.cpu().numpy() if torch.is_tensor(img_cur)
               else np.asarray(img_cur))
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=2)
        return draw_tracks(img, live)


def run(cfg: SLAMConfig, device=None, key=None) -> KLTTracker:
    """The KLT tracker over ``cfg.dataset`` under ``cfg.base_dir``; writes
    ``trajectory_<dataset>_klt.png`` and logs the counts and frames/s.
    ``device``: None is the GPU (raises without one), "cpu" the CPU."""
    logging.basicConfig(level=logging.INFO)
    logger.setLevel(logging.INFO)
    seq = Sequence.load(cfg)
    tracker = KLTTracker(cfg, seq.K, device=device, key=key)
    traj = Trajectory2D(_gt44(seq), dataset=cfg.dataset)
    t0 = time.perf_counter()
    tracker.seed(seq.frame(0))
    traj.push(0, np.eye(4))
    prev = seq.frame(0)
    for i in range(1, len(seq)):
        cur = seq.frame(i)
        tracker.step(prev, cur)
        traj.push(i, tracker.world_map.poses[-1])
        prev = cur
    fps = len(seq) / max(time.perf_counter() - t0, 1e-9)
    save_trajectory(traj, f"trajectory_{cfg.dataset}_klt.png")
    poses = np.stack(tracker.world_map.poses)
    logger.info("legacy KLT done: %d poses (%d finite) (%d rot-only, %d "
                "full, %d reseeds), %.2f FPS", len(poses),
                int(np.isfinite(poses).all(axis=(1, 2)).sum()),
                tracker.n_rot_only, tracker.n_full, tracker.n_reseed, fps)
    return tracker


def main(argv=None) -> int:
    """``python -m simpleslam_tpu_torch.legacy.run_klt [flags]``: the
    reference's flags plus ``--device`` (default: the GPU)."""
    run(parse_config(argv), device=build_parser().parse_args(argv).device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
