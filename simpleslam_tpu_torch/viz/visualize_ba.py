"""Before/after local-BA reprojection overlays (the counterpart of
``simpleslam_tpu/viz/visualize_ba.py``): for each keyframe of a window,
the measured keypoints (white), their landmarks reprojected under the
pose before BA (red) and after (green), with red-to-green arrows; the
mean reprojection error before and after is logged per keyframe.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger("ba")


def _reproj(K, Tcw, X):
    Xc = X @ Tcw[:3, :3].T + Tcw[:3, 3]
    z = np.maximum(Xc[:, 2:3], 1e-9)
    uv = (Xc / z) @ K.T
    return uv[:, :2], Xc[:, 2]


def collect_kf_residuals(world_map, K, kf, poses_before: Dict[int, np.ndarray]
                         ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                             np.ndarray]]:
    """(measured uv, uv under the pre-BA pose, uv under the current pose)
    of the landmarks keyframe ``kf`` observes, or None if it observes
    none."""
    meas, pts = [], []
    kpts = None
    for mp in world_map.points.values():
        for f, kp_idx, _ in mp.observations:
            if f != kf.idx:
                continue
            if kpts is None:
                kpts = kf.feats.kpts.cpu().numpy()
            meas.append(kpts[kp_idx])
            pts.append(np.asarray(mp.position))
    if not meas:
        return None
    meas = np.asarray(meas, np.float64)
    pts = np.asarray(pts, np.float64)
    T_before = poses_before.get(kf.idx, np.asarray(kf.pose))
    uv_before, _ = _reproj(np.asarray(K), np.asarray(T_before), pts)
    uv_after, _ = _reproj(np.asarray(K), np.asarray(kf.pose), pts)
    return meas, uv_before, uv_after


def visualize_ba_window(world_map, K, kfs: Sequence, kf_indices: List[int],
                        poses_before: Dict[int, np.ndarray],
                        images: Optional[Dict[int, np.ndarray]] = None,
                        show: bool = False) -> Dict[int, np.ndarray]:
    """The overlay of each keyframe in ``kf_indices`` (keyed by its index),
    drawn on ``images[k]``, else on its thumbnail, else on black; with
    ``show`` each goes to a window. Logs the mean reprojection error
    before and after per keyframe (also without cv2, which draws)."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    from simpleslam_tpu_torch.core.keyframe import decode_thumb

    out: Dict[int, np.ndarray] = {}
    for k in kf_indices:
        kf = kfs[k]
        res = collect_kf_residuals(world_map, K, kf, poses_before)
        if res is None:
            continue
        meas, before, after = res
        e_b = float(np.linalg.norm(before - meas, axis=1).mean())
        e_a = float(np.linalg.norm(after - meas, axis=1).mean())
        logger.info("[BA viz] KF %d: mean reproj %.2f px -> %.2f px",
                    k, e_b, e_a)
        if cv2 is None:
            continue
        if images and k in images:
            img = images[k].copy()
        else:
            img = decode_thumb(kf.thumb)
        if img is None:
            H = int(max(meas[:, 1].max(), 1) + 20)
            W = int(max(meas[:, 0].max(), 1) + 20)
            img = np.zeros((H, W, 3), np.uint8)
        for m_, b_, a_ in zip(meas, before, after):
            pm = tuple(int(v) for v in m_)
            pb = tuple(int(v) for v in b_)
            pa = tuple(int(v) for v in a_)
            cv2.circle(img, pm, 2, (255, 255, 255), -1)
            cv2.circle(img, pb, 2, (0, 0, 255), -1)
            cv2.circle(img, pa, 2, (0, 255, 0), -1)
            cv2.arrowedLine(img, pb, pa, (0, 180, 255), 1, tipLength=0.3)
        out[k] = img
        if show:
            cv2.imshow(f"BA KF {k}", img)
            cv2.waitKey(1)
    return out
