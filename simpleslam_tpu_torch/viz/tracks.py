"""Feature-track overlay (the counterpart of
``simpleslam_tpu/viz/tracks.py``): fading polylines of recent keypoint
tracks, with caps on the tracks drawn and their length."""
from __future__ import annotations

from typing import Dict, List, Tuple


def draw_tracks(img, tracks: Dict[int, List[Tuple[float, float]]],
                max_tracks: int = 300, max_len: int = 10):
    """Draw fading polylines onto a copy of a BGR frame and return it;
    without cv2 the frame itself. ``tracks``: track id -> (x, y) positions,
    oldest first."""
    try:
        import cv2
    except ImportError:
        return img
    out = img.copy()
    for n, pts in enumerate(tracks.values()):
        if n >= max_tracks:
            break
        pts = pts[-max_len:]
        for i in range(1, len(pts)):
            a = (1 + i) / (len(pts) + 1)          # older = dimmer
            col = (0, int(255 * a), int(80 * a))
            p0 = tuple(int(v) for v in pts[i - 1])
            p1 = tuple(int(v) for v in pts[i])
            cv2.line(out, p0, p1, col, 1, cv2.LINE_AA)
        if pts:
            cv2.circle(out, tuple(int(v) for v in pts[-1]), 2, (0, 255, 0), -1)
    return out
