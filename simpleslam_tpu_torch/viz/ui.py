"""Pause/step/quit keyboard UI (the counterpart of
``simpleslam_tpu/viz/ui.py``): p pauses and resumes, n steps one frame
while paused, q or Esc quits. It polls cv2's HighGUI through a 1x1 ghost
window; without cv2, or where the window cannot be made, it is a no-op.
(Without a display some cv2 builds abort the process in ``namedWindow``
instead of raising, which no ``except`` catches: a run without
``--headless`` needs a display or a cv2 without a GUI backend.)"""
from __future__ import annotations


class VizUI:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.paused = False
        self.quit = False
        self._cv2 = None
        if enabled:
            try:
                import cv2
                import numpy as np
                self._cv2 = cv2
                cv2.namedWindow("ui", cv2.WINDOW_NORMAL)
                cv2.resizeWindow("ui", 1, 1)
                cv2.imshow("ui", np.zeros((1, 1), np.uint8))
            except Exception:
                self._cv2 = None

    def poll(self) -> bool:
        """Process keys; blocks while paused. False once quitting."""
        if not self._cv2 or self.quit:
            return not self.quit
        cv2 = self._cv2
        while True:
            k = cv2.waitKey(1) & 0xFF
            if k in (ord("q"), 27):
                self.quit = True
                return False
            if k == ord("p"):
                self.paused = not self.paused
            if self.paused:
                if k == ord("n"):
                    return True       # one step
                cv2.waitKey(30)
                continue
            return True

    def close(self) -> None:
        if self._cv2:
            try:
                self._cv2.destroyWindow("ui")
            except Exception:
                pass
