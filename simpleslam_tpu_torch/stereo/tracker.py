"""Metric-scale stereo visual odometry (the counterpart of
``simpleslam_tpu/stereo/tracker.py``).

Per frame t: detect features on the left image; block-matching disparity
gives each keypoint a depth (disparity-checked) and its metric 3-D point in
camera t. Per frame pair t -> t+1: descriptor-match left t with left t+1,
then PnP-RANSAC of the 3-D points (world frame through T_t) against their
pixels in t+1 gives T_t+1 at the true scale of the stereo baseline.
"""
from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np
import torch

from simpleslam_tpu_torch.config import SLAMConfig
from simpleslam_tpu_torch.core import frontend
from simpleslam_tpu_torch.ops import pnp
from simpleslam_tpu_torch.ops.features import rgb_to_gray
from simpleslam_tpu_torch.ops.stereo import (disparity_block_match,
                                             keypoints_to_3d,
                                             sample_disparity)
from simpleslam_tpu_torch.utils.device import resolve_device
from simpleslam_tpu_torch.utils.rng import TorchKey

logger = logging.getLogger("stereo")


class StereoTracker:
    """Frame-sequential stereo VO. ``device``: None is the GPU (raises
    without one), "cpu" the CPU; ``key``: the randomness source of the
    PnP-RANSAC draws (``utils/rng.py``; default a ``TorchKey`` of
    ``cfg.seed``). ``poses``: T_cw per frame; ``n_tracked`` and ``n_lost``
    count the frames posed by PnP and the frames dead-reckoned."""

    def __init__(self, cfg: SLAMConfig, K: np.ndarray, baseline: float,
                 max_disp: int = 64, device=None, key=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.K = np.asarray(K, np.float64)
        self._K_t = torch.as_tensor(self.K, dtype=torch.float32,
                                    device=self.device)
        self.baseline = float(baseline)
        self.max_disp = int(max_disp)
        self.detector, self.matcher = frontend.init_feature_pipeline(
            cfg, device=self.device)
        self.poses: List[np.ndarray] = [np.eye(4)]
        self._key = key if key is not None else TorchKey(cfg.seed)
        self._prev: Optional[tuple] = None           # (feats, X_cam, has3d)
        self.n_tracked = 0
        self.n_lost = 0

    def _k(self):
        self._key, k = self._key.split()
        return k

    def _gray(self, img) -> torch.Tensor:
        img = torch.as_tensor(img if torch.is_tensor(img) else
                              np.asarray(img), device=self.device)
        return rgb_to_gray(img) if img.dim() == 3 else img.float()

    def _frame_3d(self, left, right):
        """Features, their metric 3-D points (camera frame) and validity."""
        gl = self._gray(left)
        gr = self._gray(right)
        feats = self.detector.fn(gl)
        disp, dvalid = disparity_block_match(gl, gr, max_disp=self.max_disp)
        d_at, ok = sample_disparity(disp, dvalid, feats.kpts)
        X = keypoints_to_3d(feats.kpts, d_at, self._K_t, self.baseline)
        # block matching is trustworthy only in a disparity band: too small
        # (far) means metre-scale depth noise, too large (very near, the
        # oblique floor) slant-biased blocks
        z = X[:, 2]
        z_max = float(self.K[0, 0]) * self.baseline / 8.0   # disp >= 8 px
        has3d = (feats.valid & ok & (d_at > 2.0)
                 & (z > 4.0 * self.baseline) & (z < z_max))
        return feats, X, has3d

    def step(self, left, right) -> bool:
        """Process one stereo pair (host arrays or tensors, BGR or grey);
        True once tracking gives a new pose (the first call initialises)."""
        feats, X_cam, has3d = self._frame_3d(left, right)
        if self._prev is None:
            self._prev = (feats, X_cam, has3d)
            return False

        pf, pX, phas = self._prev
        m = frontend.feature_matcher(self.cfg, pf, feats, self.matcher)
        valid = m.valid & phas[m.idx0]

        # world-frame 3-D of the previous frame's points: X_w = T_cw^-1 x_cam
        T_prev = self.poses[-1]
        T_wc = np.linalg.inv(T_prev)
        Xw = torch.as_tensor(
            pX.cpu().numpy() @ T_wc[:3, :3].T + T_wc[:3, 3],
            dtype=torch.float32, device=self.device)
        pts3d = Xw[m.idx0]
        pts2d = feats.kpts[m.idx1]

        n_cand = int(valid.sum())
        n_min = max(8, self.cfg.pnp_min_inliers // 2)
        if n_cand < n_min:
            logger.info("[stereo] too few 3D-2D pairs (%d); dead-reckon",
                        n_cand)
            self.poses.append(self.poses[-1].copy())
            self.n_lost += 1
            self._prev = (feats, X_cam, has3d)
            return True

        T_est, _inl, n_inl, ok = pnp.solve_pnp_ransac(
            self._k(), pts3d, pts2d, valid, self._K_t, self.cfg.ransac_thresh,
            Tcw_init=torch.as_tensor(T_prev, dtype=torch.float32,
                                     device=self.device),
            n_hyp=self.cfg.ransac_hypotheses)
        if bool(ok) and int(n_inl) >= n_min:
            self.poses.append(T_est.cpu().numpy().astype(np.float64))
            self.n_tracked += 1
        else:
            logger.info("[stereo] PnP failed (inl=%d); dead-reckon",
                        int(n_inl))
            self.poses.append(self.poses[-1].copy())
            self.n_lost += 1
        self._prev = (feats, X_cam, has3d)
        return True
