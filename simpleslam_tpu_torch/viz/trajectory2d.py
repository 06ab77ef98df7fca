"""2-D x-z trajectory plot against ground truth (the counterpart of
``simpleslam_tpu/viz/trajectory2d.py``).

``push(frame_idx, T_cw)`` stores the camera centre ``-R^T t`` and the
ground-truth centre of that frame. The plotted estimate uses the
reference's default fixed "alignment" (s = 2, R = I, t = 0); with
``umeyama=True`` it is the Umeyama Sim(3) fit to the ground truth once ten
poses are paired. ``live=True`` redraws the figure in a window at each
``draw`` (a non-headless run). ``draw`` and ``save`` import matplotlib
when called; without it they raise ``ImportError``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def umeyama_sim3(src: np.ndarray, dst: np.ndarray):
    """Similarity (s, R, t) minimising ||dst - (s R src + t)||^2
    (Umeyama)."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = dc.T @ sc / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (sc ** 2).sum() / len(src)
    s = np.trace(np.diag(D) @ S) / max(var_s, 1e-12)
    t = mu_d - s * R @ mu_s
    return s, R, t


class Trajectory2D:
    def __init__(self, gt_T: Optional[np.ndarray] = None, dataset: str = "",
                 live: bool = False, umeyama: bool = False):
        self.gt_T = gt_T            # (N,4,4) or None
        self.dataset = dataset
        self.live = live
        self.umeyama = umeyama
        self.est: list = []
        self.gt: list = []
        self.s, self.R, self.t = 2.0, np.eye(3), np.zeros(3)
        self.align_ok = True
        self._fig = None

    def push(self, frame_idx: int, T_cw: np.ndarray) -> None:
        R = np.asarray(T_cw)[:3, :3]
        t = np.asarray(T_cw)[:3, 3]
        self.est.append(-R.T @ t)
        if self.gt_T is not None and frame_idx < len(self.gt_T):
            self.gt.append(np.asarray(self.gt_T[frame_idx])[:3, 3])

    def _aligned_est(self) -> np.ndarray:
        est = np.asarray(self.est)
        if (self.umeyama and len(self.est) >= 10
                and len(self.gt) == len(self.est)):
            self.s, self.R, self.t = umeyama_sim3(est, np.asarray(self.gt))
        return (self.s * (est @ self.R.T)) + self.t

    def draw(self, block: bool = False) -> None:
        import matplotlib.pyplot as plt

        if self._fig is None:
            self._fig, self._ax = plt.subplots(
                num="Trajectory 2D (x-z)", figsize=(6, 6))
        ax = self._ax
        ax.clear()
        pts = []
        if self.est:
            e = self._aligned_est()
            ax.plot(e[:, 0], e[:, 2], "b-", lw=1.2, label="estimate")
            ax.plot(e[-1, 0], e[-1, 2], "bo", ms=4)
            pts.append(e[:, [0, 2]])
        if self.gt:
            g = np.asarray(self.gt)
            ax.plot(g[:, 0], g[:, 2], "r--", lw=1.0, label="ground truth")
            pts.append(g[:, [0, 2]])
        ax.set_xlabel("x [m]")
        ax.set_ylabel("z [m]")
        ax.set_title(f"Trajectory 2D (x-z) {self.dataset}")
        ax.legend(loc="upper left", fontsize=8)
        ax.set_aspect("equal", adjustable="datalim")
        if pts:
            allp = np.concatenate(pts)
            c = allp.mean(0)
            r = max(float(np.abs(allp - c).max()) * 1.1, 1.0)
            ax.set_xlim(c[0] - r, c[0] + r)
            ax.set_ylim(c[1] - r, c[1] + r)
        ax.text(0.02, 0.02, f"frames: {len(self.est)}",
                transform=ax.transAxes, fontsize=8,
                bbox=dict(fc="w", alpha=0.6, ec="none"))
        if self.live:
            self._fig.canvas.draw_idle()
            plt.pause(0.001)

    def save(self, path: str) -> None:
        self.draw()
        self._fig.savefig(path, dpi=120, bbox_inches="tight")
