"""Camera calibration: Zhang's method with a joint Levenberg-Marquardt
refinement (the counterpart of ``simpleslam_tpu/tools/calibrate.py``).

Per-view homographies by the port's DLT, Zhang's closed-form intrinsics
from the B-matrix constraints and extrinsics from each H (numpy), then a
joint LM refinement of the intrinsics, the distortion and every view's pose
that minimises the total reprojection error, on the caller's device.
Chessboard corner detection is image IO and uses cv2 where it is installed;
known corners can be passed directly. The output pickle ``(K, D, rms)`` is
what the ``custom`` dataset's ``load_calibration`` reads.

CLI: python -m simpleslam_tpu_torch.tools.calibrate --images 'dir/*.png' \
         --pattern 9 6 --square 0.024 --out calibration.pkl [--device cpu]
"""
from __future__ import annotations

import argparse
import glob
import pickle
from typing import List, Optional, Tuple

import numpy as np
import torch

from simpleslam_tpu_torch.ops import se3
from simpleslam_tpu_torch.ops.epipolar import fit_homography
from simpleslam_tpu_torch.utils.device import resolve_device
from simpleslam_tpu_torch.utils.precision import highest_precision


def chessboard_object_points(cols: int, rows: int,
                             square: float) -> np.ndarray:
    """(N, 3) planar board points, z = 0."""
    g = np.mgrid[0:cols, 0:rows].T.reshape(-1, 2)
    return np.concatenate([g * square, np.zeros((g.shape[0], 1))],
                          axis=1).astype(np.float64)


def find_chessboard_corners(img, pattern: Tuple[int, int]
                            ) -> Optional[np.ndarray]:
    """Sub-pixel chessboard corners (N, 2) by cv2, or None (not found, or
    no cv2)."""
    try:
        import cv2
    except ImportError:
        return None
    gray = img if img.ndim == 2 else cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    ok, corners = cv2.findChessboardCorners(gray, pattern, None)
    if not ok:
        return None
    corners = cv2.cornerSubPix(
        gray, corners, (11, 11), (-1, -1),
        (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 0.001))
    return corners.reshape(-1, 2).astype(np.float64)


# --------------------------------------------------------------------------- #
# Zhang closed form (numpy)
# --------------------------------------------------------------------------- #

def _vij(H, i, j):
    return np.array([
        H[0, i] * H[0, j],
        H[0, i] * H[1, j] + H[1, i] * H[0, j],
        H[1, i] * H[1, j],
        H[2, i] * H[0, j] + H[0, i] * H[2, j],
        H[2, i] * H[1, j] + H[1, i] * H[2, j],
        H[2, i] * H[2, j]])


def zhang_intrinsics(Hs: List[np.ndarray]) -> np.ndarray:
    """Closed-form K from >= 3 view homographies (Zhang 2000)."""
    V = []
    for H in Hs:
        V.append(_vij(H, 0, 1))
        V.append(_vij(H, 0, 0) - _vij(H, 1, 1))
    V = np.asarray(V)
    _, _, Vt = np.linalg.svd(V)
    b11, b12, b22, b13, b23, b33 = Vt[-1]
    v0 = (b12 * b13 - b11 * b23) / (b11 * b22 - b12 ** 2)
    lam = b33 - (b13 ** 2 + v0 * (b12 * b13 - b11 * b23)) / b11
    alpha = np.sqrt(lam / b11)
    beta = np.sqrt(lam * b11 / (b11 * b22 - b12 ** 2))
    gamma = -b12 * alpha ** 2 * beta / lam
    u0 = gamma * v0 / beta - b13 * alpha ** 2 / lam
    return np.array([[alpha, 0.0, u0], [0.0, beta, v0], [0.0, 0.0, 1.0]])


def extrinsics_from_h(H: np.ndarray, K: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-view (R, t) with the board plane z = 0."""
    Kinv = np.linalg.inv(K)
    h1, h2, h3 = H[:, 0], H[:, 1], H[:, 2]
    lam = 1.0 / max(np.linalg.norm(Kinv @ h1), 1e-12)
    r1 = lam * (Kinv @ h1)
    r2 = lam * (Kinv @ h2)
    r3 = np.cross(r1, r2)
    R = np.stack([r1, r2, r3], axis=1)
    U, _, Vt = np.linalg.svd(R)                # project onto SO(3)
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R = -R
    t = lam * (Kinv @ h3)
    if t[2] < 0:
        t = -t
        R[:, :2] = -R[:, :2]
    return R, t


# --------------------------------------------------------------------------- #
# Joint refinement (LM over intrinsics, distortion and view poses)
# --------------------------------------------------------------------------- #

@highest_precision()
def _reproject_all(params: torch.Tensor, obj_pts: torch.Tensor,
                   n_views: int) -> torch.Tensor:
    """params: [fx, fy, cx, cy, k1, k2, p1, p2, k3] + 6 per view (an se(3)
    twist) -> (V, N, 2) pixels. Scalars are taken as (1,) slices: forward-
    mode AD would promote a 0-d tangent mixed with a Python number to
    float64."""
    fx, fy, cx, cy, k1, k2, p1, p2, k3 = (params[i:i + 1] for i in range(9))
    T = se3.se3_exp(params[9:9 + 6 * n_views].reshape(n_views, 6))
    pc = torch.einsum("vij,nj->vni", T[:, :3, :3], obj_pts) \
        + T[:, None, :3, 3]
    x = pc[..., 0] / pc[..., 2]
    y = pc[..., 1] / pc[..., 2]
    r2 = x * x + y * y
    rad = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return torch.stack([fx * xd + cx, fy * yd + cy], -1)


@highest_precision()
def calibrate_camera(obj_pts: np.ndarray, img_pts: np.ndarray,
                     refine_iters: int = 20, fix_k3: bool = True,
                     device=None):
    """Zhang initialisation and ``refine_iters`` LM steps (the damping
    halved after a step that lowers the squared error, else multiplied by
    4 and the step refused), on ``device`` (None is the GPU and raises
    without one, "cpu" the CPU).

    obj_pts: (N, 3) planar board points; img_pts: (V, N, 2) detections.
    Returns (K (3, 3), D (5,), rms_px, T_views (V, 4, 4)), numpy float64.
    """
    dev = resolve_device(device)
    V = img_pts.shape[0]

    def t32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    Hs = [fit_homography(t32(obj_pts[:, :2]), t32(img_pts[v]))
          .cpu().numpy().astype(np.float64) for v in range(V)]
    K0 = zhang_intrinsics(Hs)

    params = [K0[0, 0], K0[1, 1], K0[0, 2], K0[1, 2], 0, 0, 0, 0, 0]
    for v in range(V):
        R, t = extrinsics_from_h(Hs[v], K0)
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = t
        params.extend(se3.se3_log(t32(T)).cpu().numpy())
    params = t32(params)

    obs = t32(img_pts)
    obj = t32(obj_pts)
    n_par = params.shape[0]
    free = torch.ones(n_par, device=dev)
    if fix_k3:
        free[8] = 0.0

    def residuals(p):
        return (_reproject_all(p, obj, V) - obs).reshape(-1)

    eye = torch.eye(n_par, device=dev)
    lam = torch.full((), 1e-3, device=dev)
    for _ in range(refine_iters):
        J = torch.func.jacfwd(residuals)(params) * free[None, :]
        r = residuals(params)
        H = J.T @ J + lam * eye
        dp = -torch.linalg.solve_ex(H, (J.T @ r)[:, None])[0][:, 0]
        p_new = params + dp * free
        better = (residuals(p_new) ** 2).sum() < (r ** 2).sum()
        params = torch.where(better, p_new, params)
        lam = torch.where(better, lam * 0.5, lam * 4.0)

    p = params.cpu().numpy().astype(np.float64)
    K = np.array([[p[0], 0, p[2]], [0, p[1], p[3]], [0, 0, 1.0]])
    D = np.array([p[4], p[5], p[6], p[7], p[8]])
    r = residuals(params).cpu().numpy()
    rms = float(np.sqrt(np.mean(r ** 2)))
    Ts = se3.se3_exp(params[9:].reshape(V, 6)).cpu().numpy().astype(
        np.float64)
    return K, D, rms, Ts


def main(argv=None) -> int:
    p = argparse.ArgumentParser("calibrate")
    p.add_argument("--images", required=True, help="glob of board images")
    p.add_argument("--pattern", type=int, nargs=2, default=[9, 6])
    p.add_argument("--square", type=float, default=0.024)
    p.add_argument("--out", default="calibration.pkl")
    p.add_argument("--fit_k3", action="store_true",
                   help="fit the 6th-order radial term (cv2.calibrateCamera "
                        "does; needs strong distortion + wide field coverage)")
    p.add_argument("--refine_iters", type=int, default=40)
    p.add_argument("--device", default=None,
                   help="where the refinement runs (default: the GPU; "
                        "'cpu' for the CPU)")
    a = p.parse_args(argv)

    import cv2
    objp = chessboard_object_points(a.pattern[0], a.pattern[1], a.square)
    img_pts = []
    for path in sorted(glob.glob(a.images)):
        img = cv2.imread(path)
        c = find_chessboard_corners(img, tuple(a.pattern))
        if c is not None:
            img_pts.append(c)
    if len(img_pts) < 3:
        print(f"need >= 3 usable views, got {len(img_pts)}")
        return 1
    K, D, rms, _Ts = calibrate_camera(objp, np.stack(img_pts),
                                      refine_iters=a.refine_iters,
                                      fix_k3=not a.fit_k3, device=a.device)
    print(f"K=\n{K}\nD={D}\nrms={rms:.3f} px over {len(img_pts)} views")
    # the layout the dataloader's custom loader reads: (camera_matrix, ...)
    with open(a.out, "wb") as f:
        pickle.dump((K, D, rms), f)
    print(f"wrote {a.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
