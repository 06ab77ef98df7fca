"""The live run's HighGUI windows (the counterpart of
``simpleslam_tpu/viz/windows.py``): the keyframe thumbnail strip, the
previous-to-current match overlay and the feature-track book behind the
trail window. Every function returns a BGR array (or None without cv2), so
it runs headless; the caller decides whether to ``cv2.imshow`` it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from simpleslam_tpu_torch.core.keyframe import decode_thumb


def build_kf_strip(kfs, max_n: int = 6, height: int = 120
                   ) -> Optional[np.ndarray]:
    """The last ``max_n`` keyframe thumbnails side by side (decoded through
    the LZ4 codec), newest on the right, each labelled with its keyframe
    and frame numbers."""
    try:
        import cv2
    except ImportError:
        return None
    tiles: List[np.ndarray] = []
    for kf in kfs[-max_n:]:
        img = decode_thumb(kf.thumb)
        if img is None:
            continue
        w = int(round(img.shape[1] * height / img.shape[0]))
        tile = cv2.resize(img, (w, height))
        cv2.putText(tile, f"KF{kf.idx} f{kf.frame_idx}", (4, 16),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.45, (0, 255, 255), 1,
                    cv2.LINE_AA)
        tiles.append(tile)
    if not tiles:
        return None
    return np.concatenate(tiles, axis=1)


def _host(a) -> np.ndarray:
    """A host array of a tensor or array."""
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def build_match_overlay(img_prev, img_cur, kpts_prev, kpts_cur, idx0, idx1,
                        valid, max_draw: int = 120) -> Optional[np.ndarray]:
    """The previous and the current frame side by side with up to
    ``max_draw`` match lines (grey frames become BGR)."""
    try:
        import cv2
    except ImportError:
        return None

    def _bgr(im):
        im = _host(im)
        if im.ndim == 2:
            im = cv2.cvtColor(im.astype(np.uint8), cv2.COLOR_GRAY2BGR)
        return im

    a, b = _bgr(img_prev), _bgr(img_cur)
    kpts_prev, kpts_cur = _host(kpts_prev), _host(kpts_cur)
    idx0, idx1 = _host(idx0), _host(idx1)
    H = max(a.shape[0], b.shape[0])
    canvas = np.zeros((H, a.shape[1] + b.shape[1], 3), np.uint8)
    canvas[:a.shape[0], :a.shape[1]] = a
    canvas[:b.shape[0], a.shape[1]:] = b
    off = a.shape[1]
    for i in np.flatnonzero(_host(valid))[:max_draw]:
        p = kpts_prev[int(idx0[i])]
        q = kpts_cur[int(idx1[i])]
        p = (int(p[0]), int(p[1]))
        q = (int(q[0]) + off, int(q[1]))
        cv2.circle(canvas, p, 2, (0, 255, 0), -1)
        cv2.circle(canvas, q, 2, (0, 255, 0), -1)
        cv2.line(canvas, p, q, (0, 180, 255), 1, cv2.LINE_AA)
    return canvas


class TrackBook:
    """Keypoint tracks across frames for the trail overlay
    (``viz.tracks.draw_tracks``): a match carries the previous keypoint's
    track on to the current keypoint; tracks not continued end."""

    def __init__(self, max_len: int = 12):
        self.max_len = max_len
        self._by_kp: Dict[int, int] = {}     # previous kp index -> track id
        self.tracks: Dict[int, List[Tuple[float, float]]] = {}
        self._next = 0

    def advance(self, kpts_prev, kpts_cur, idx0, idx1, valid) -> None:
        kpts_prev, kpts_cur = _host(kpts_prev), _host(kpts_cur)
        idx0, idx1 = _host(idx0), _host(idx1)
        new_by_kp: Dict[int, int] = {}
        live: Dict[int, List[Tuple[float, float]]] = {}
        for i in np.flatnonzero(_host(valid)):
            k0, k1 = int(idx0[i]), int(idx1[i])
            tid = self._by_kp.get(k0)
            if tid is None:
                tid = self._next
                self._next += 1
                pts = [tuple(map(float, kpts_prev[k0]))]
            else:
                pts = self.tracks.get(tid, [])
            pts = (pts + [tuple(map(float, kpts_cur[k1]))])[-self.max_len:]
            live[tid] = pts
            new_by_kp[k1] = tid
        self._by_kp = new_by_kp
        self.tracks = live
