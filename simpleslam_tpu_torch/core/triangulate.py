"""Keyframe-pair triangulation: grow the map between two keyframes (the
counterpart of ``simpleslam_tpu/core/triangulate.py``).

Match prev_kf <-> cur_kf (+ F-RANSAC), batched DLT triangulation, then the
gates in one batch (parallax, depth window and cheirality in both views,
max reprojection error); survivors go into the map observed by both
keyframes, with rollback of a half-registered landmark.
"""
from __future__ import annotations

import logging
from collections import Counter
from typing import List

import numpy as np
import torch

from simpleslam_tpu_torch.core.frontend import match_with_ransac
from simpleslam_tpu_torch.core.keyframe import Keyframe
from simpleslam_tpu_torch.ops.triangulation import (projection_matrix,
                                                    triangulate_two_view,
                                                    two_view_gates)

logger = logging.getLogger("triangulation")


def triangulate_between_kfs_2view(args, K: np.ndarray, prev_kf: Keyframe,
                                  cur_kf: Keyframe, world_map, matcher, *,
                                  parallax_min_deg: float = 2.0, key=None,
                                  exclude_cur_kp=None) -> List[int]:
    """Triangulate new landmarks between two keyframes; returns their ids.

    ``exclude_cur_kp``: cur-KF keypoint indices that already observe a
    landmark (the --tri_kf2 second pass)."""
    matches = match_with_ransac(args, matcher, prev_kf.feats, cur_kf.feats,
                                key=key)
    mvalid = matches.valid.cpu().numpy()
    n_m = int(mvalid.sum())
    if n_m < 8:
        logger.info("[TRI] too few KF matches (%d)", n_m)
        return []
    dev = prev_kf.feats.kpts.device
    Kt = torch.as_tensor(np.asarray(K), dtype=torch.float32, device=dev)
    T0 = torch.as_tensor(np.asarray(prev_kf.pose), dtype=torch.float32,
                         device=dev)
    T1 = torch.as_tensor(np.asarray(cur_kf.pose), dtype=torch.float32,
                         device=dev)
    uv0 = prev_kf.feats.kpts[matches.idx0]
    uv1 = cur_kf.feats.kpts[matches.idx1]
    X = triangulate_two_view(projection_matrix(Kt, T0),
                             projection_matrix(Kt, T1), uv0, uv1)
    keep, why = two_view_gates(
        X, Kt, T0, T1, uv0, uv1,
        min_depth=float(getattr(args, "min_depth", 0.0)),
        max_depth=float(getattr(args, "max_depth", 1e6)),
        min_parallax_deg=float(parallax_min_deg),
        max_reproj_px=float(getattr(args, "mvt_rep_err",
                                    getattr(args, "ransac_thresh", 2.0))))
    finite = torch.isfinite(X).all(1).cpu().numpy()
    keep = keep.cpu().numpy() & mvalid & finite
    i0_all = matches.idx0.cpu().numpy()
    i1_all = matches.idx1.cpu().numpy()
    if exclude_cur_kp is not None and len(exclude_cur_kp):
        keep &= ~np.isin(i1_all, np.fromiter(exclude_cur_kp, np.int64))

    reasons = Counter()
    for name, mask in why.items():
        reasons[f"fail_{name}"] = int((~mask.cpu().numpy() & mvalid
                                       & finite).sum())
    reasons["fail_nonfinite"] = int((~finite & mvalid).sum())
    logger.info("[TRI] matches=%d kept=%d rejects=%s", n_m, int(keep.sum()),
                dict(reasons))
    sel = np.flatnonzero(keep)
    if sel.size == 0:
        return []
    Xh = X.cpu().numpy()[sel]
    i0, i1 = i0_all[sel], i1_all[sel]
    desc0 = prev_kf.feats.desc.cpu().numpy()
    desc1 = cur_kf.feats.desc.cpu().numpy()
    new_ids = world_map.add_points(Xh, np.full((sel.size, 3), 0.7, np.float32),
                                   keyframe_idx=prev_kf.idx)
    done: List[int] = []
    for pid, a, b in zip(new_ids, i0, i1):
        try:
            world_map.points[pid].add_observation(prev_kf.idx, int(a),
                                                  desc0[a])
            world_map.points[pid].add_observation(cur_kf.idx, int(b),
                                                  desc1[b])
            done.append(pid)
        except (KeyError, ValueError, IndexError):
            world_map.points.pop(pid, None)
    return done
