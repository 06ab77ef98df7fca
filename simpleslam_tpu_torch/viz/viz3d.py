"""3-D map and trajectory viewer (the counterpart of
``simpleslam_tpu/viz/viz3d.py``). Open3D is optional: without it (the
port's machines have none) the viewer is a no-op and the pipeline runs
without it. With it, points are coloured by an axis or their first
principal component through matplotlib's turbo map, the trajectory is a
blue line set, and W/S, A/D, Q/E fly the camera.

One deliberate divergence: the colour scale divides by ``np.ptp(v)``
where the reference calls ``v.ptp()``, which numpy 2 removed."""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np

try:
    import open3d as o3d  # pragma: no cover

    _HAS_O3D = True
except Exception:
    o3d = None
    _HAS_O3D = False


class Visualizer3D:
    def __init__(self, enabled: bool = True, color_mode: str = "z"):
        self.enabled = enabled and _HAS_O3D
        self.color_mode = color_mode
        self._lock = threading.Lock()
        if self.enabled:  # pragma: no cover - needs open3d and a display
            self._vis = o3d.visualization.VisualizerWithKeyCallback()
            self._vis.create_window("map", 960, 720)
            self._pcd = o3d.geometry.PointCloud()
            self._traj = o3d.geometry.LineSet()
            self._added = False
            self._register_nav_callbacks(self._vis)

    def _register_nav_callbacks(self, vis, step: float = 0.5) -> None:
        """W/S forward/back, A/D left/right, Q/E up/down along the view
        camera's own axes."""
        moves = {"W": (0.0, 0.0, step), "S": (0.0, 0.0, -step),
                 "A": (-step, 0.0, 0.0), "D": (step, 0.0, 0.0),
                 "Q": (0.0, step, 0.0), "E": (0.0, -step, 0.0)}

        def make_cb(dx, dy, dz):
            def cb(v):  # pragma: no cover - needs a live GL window
                vc = v.get_view_control()
                vc.camera_local_translate(forward=dz, right=dx, up=dy)
                return False
            return cb

        self.nav_keys = {}
        for key, (dx, dy, dz) in moves.items():
            cb = make_cb(dx, dy, dz)
            self.nav_keys[key] = cb
            vis.register_key_callback(ord(key), cb)

    @staticmethod
    def _colors_by_axis(pts: np.ndarray, mode: str) -> np.ndarray:
        from matplotlib import cm

        if len(pts) == 0:
            return np.zeros((0, 3))
        if mode == "pca":
            c = pts - pts.mean(0)
            ax = np.linalg.svd(c, full_matrices=False)[2][0]
            v = c @ ax
        else:
            v = pts[:, 2]
        v = (v - v.min()) / max(np.ptp(v), 1e-9)
        return cm.turbo(v)[:, :3]

    def update(self, points: np.ndarray, colors: Optional[np.ndarray],
               centers: np.ndarray, new_ids=None) -> None:
        if not self.enabled:  # no-op without open3d
            return
        with self._lock:  # pragma: no cover - needs open3d and a display
            self._pcd.points = o3d.utility.Vector3dVector(points)
            cols = (colors if colors is not None
                    else self._colors_by_axis(points, self.color_mode))
            self._pcd.colors = o3d.utility.Vector3dVector(cols)
            if len(centers) >= 2:
                self._traj.points = o3d.utility.Vector3dVector(centers)
                lines = [[i, i + 1] for i in range(len(centers) - 1)]
                self._traj.lines = o3d.utility.Vector2iVector(lines)
                self._traj.colors = o3d.utility.Vector3dVector(
                    np.tile([[0.1, 0.3, 1.0]], (len(lines), 1)))
            if not self._added:
                self._vis.add_geometry(self._pcd)
                self._vis.add_geometry(self._traj)
                self._added = True
            else:
                self._vis.update_geometry(self._pcd)
                self._vis.update_geometry(self._traj)
            self._vis.poll_events()
            self._vis.update_renderer()

    def close(self) -> None:
        if self.enabled:  # pragma: no cover
            self._vis.destroy_window()
