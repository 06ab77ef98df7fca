"""Keyframes + keyframe insertion policy (the counterpart of
``simpleslam_tpu/core/keyframe.py``).

``Keyframe.thumb`` is the reference's thumbnail: the frame resized to
``cfg.kf_thumb_hw``, JPEG at quality 70, then the port's LZ4 container
(``native.py``). cv2 is imported only there; without it the thumbnail is
``b""`` (and :func:`decode_thumb` gives None), as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from simpleslam_tpu_torch import native
from simpleslam_tpu_torch.core.types import Features, Matches


@dataclass
class Keyframe:
    """One keyframe: metadata, padded features, 4x4 T_cw pose, thumbnail."""
    idx: int                 # keyframe sequence id (0-based)
    frame_idx: int           # source frame number
    path: str                # "" for in-memory frames
    feats: Features
    pose: np.ndarray         # 4x4 T_cw
    thumb: bytes = b""

    @property
    def kps(self) -> np.ndarray:
        """(N_valid, 2) pixel coordinates of the valid keypoints."""
        f = self.feats.numpy()
        return f["kpts"][f["valid"]]

    @property
    def desc(self) -> np.ndarray:
        f = self.feats.numpy()
        return f["desc"][f["valid"]]


def make_thumb(bgr, hw: Tuple[int, int] = (640, 360)) -> bytes:
    """Resize to ``hw`` (width, height), JPEG q70, LZ4 (the reference's
    bytes); ``b""`` without cv2 or when cv2 cannot encode the frame."""
    try:
        import cv2
    except ImportError:
        return b""
    img = bgr.cpu().numpy() if torch.is_tensor(bgr) else np.asarray(bgr)
    try:
        th = cv2.resize(img, tuple(hw))
        ok, enc = cv2.imencode(".jpg", th, [int(cv2.IMWRITE_JPEG_QUALITY), 70])
    except cv2.error:
        return b""
    return native.compress(enc.tobytes()) if ok else b""


def decode_thumb(blob: bytes) -> Optional[np.ndarray]:
    """The inverse of :func:`make_thumb`: a BGR uint8 array, or None for an
    empty or undecodable thumbnail or without cv2 (the reference's rule)."""
    if not blob:
        return None
    try:
        import cv2
        jpeg = native.decompress(blob)
        return cv2.imdecode(np.frombuffer(jpeg, np.uint8), cv2.IMREAD_COLOR)
    except Exception:
        return None


def rot_deg_between(Tcw_prev: np.ndarray, Tcw_curr: np.ndarray) -> float:
    """Angular change between two T_cw poses in degrees."""
    R = np.asarray(Tcw_curr)[:3, :3] @ np.asarray(Tcw_prev)[:3, :3].T
    c = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    return float(np.degrees(np.arccos(c)))


def keyframe_signals(kf_feats: Features, cur_feats: Features,
                     matches: Matches):
    """(n_inliers, inlier_ratio, median_flow_px) of a padded match set; the
    ratio's denominator is the keyframe's keypoint count."""
    m = matches.valid
    n_inl = m.sum()
    n_ref = torch.clamp(kf_feats.valid.sum(), min=1)
    ratio = n_inl.float() / n_ref.float()
    d = cur_feats.kpts[matches.idx1] - kf_feats.kpts[matches.idx0]
    disp = torch.hypot(d[:, 0], d[:, 1])
    s = torch.sort(torch.where(m, disp, torch.full_like(disp,
                                                        float("inf")))).values
    k = torch.clamp(n_inl, min=1)
    lo = s[torch.clamp((k - 1) // 2, min=0)]
    hi = s[torch.clamp(k // 2, min=0)]
    med = torch.where(n_inl > 0, 0.5 * (lo + hi), torch.zeros_like(lo))
    return n_inl, ratio, med


def is_new_keyframe(frame_no: int, n_matches: int, median_flow_px: float,
                    n_kf_kpts: int, rot_deg: float, *, kf_cooldown: int = 5,
                    kf_min_inliers: float = 125, kf_min_ratio: float = 0.35,
                    kf_max_disp: float = 30.0, kf_min_rot_deg: float = 8.0,
                    last_kf_frame_no: int = -999) -> bool:
    """Promotion decision, the reference's trigger order: age past the
    cooldown ALWAYS promotes (its "pessimistic cooldown" quirk), then a weak
    track, a large median flow, or a rotation above the threshold."""
    if frame_no - last_kf_frame_no > kf_cooldown:
        return True
    ratio = n_matches / max(1, n_kf_kpts)
    weak_track = (n_matches < kf_min_inliers) or (ratio < kf_min_ratio)
    return bool(weak_track or median_flow_px > kf_max_disp
                or rot_deg > kf_min_rot_deg)


MatchFn = Callable[[Features, Features], Matches]


def select_keyframe(cfg, frame_no: int, img2, feats2: Features,
                    Tcw_curr: Optional[np.ndarray], match_fn: MatchFn,
                    kfs: List[Keyframe], last_kf_frame_no: int,
                    path: str = "") -> Tuple[List[Keyframe], int]:
    """Maybe promote frame ``frame_no`` to a keyframe. Inside the cooldown
    and below the rotation gate the KF<->frame matching is skipped."""
    if not kfs:
        return kfs, last_kf_frame_no
    prev_kf = kfs[-1]
    rot = 0.0
    if prev_kf.pose is not None and Tcw_curr is not None:
        rot = rot_deg_between(prev_kf.pose, Tcw_curr)
    if (frame_no - last_kf_frame_no) <= cfg.kf_cooldown \
            and rot < cfg.kf_min_rot_deg:
        return kfs, last_kf_frame_no
    matches = match_fn(prev_kf.feats, feats2)
    n_inl, _ratio, med = keyframe_signals(prev_kf.feats, feats2, matches)
    n_kf = int(prev_kf.feats.valid.sum())
    if is_new_keyframe(frame_no, int(n_inl), float(med), n_kf, rot,
                       kf_cooldown=cfg.kf_cooldown,
                       kf_min_inliers=cfg.kf_min_inliers,
                       kf_min_ratio=cfg.kf_min_ratio,
                       kf_max_disp=cfg.kf_max_disp,
                       kf_min_rot_deg=cfg.kf_min_rot_deg,
                       last_kf_frame_no=last_kf_frame_no):
        thumb = (make_thumb(img2, tuple(cfg.kf_thumb_hw))
                 if img2 is not None else b"")
        kfs.append(Keyframe(len(kfs), frame_no, path, feats2,
                            np.asarray(Tcw_curr) if Tcw_curr is not None
                            else np.eye(4), thumb))
        last_kf_frame_no = frame_no
    return kfs, last_kf_frame_no
