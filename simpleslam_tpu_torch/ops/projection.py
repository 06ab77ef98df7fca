"""Pinhole projection and lens distortion (the counterpart of
``simpleslam_tpu/ops/projection.py``).

The Brown-Conrady model (k1, k2, p1, p2[, k3]) replaces the reference's cv2
camera calls: :func:`distort_points`, :func:`undistort_points`
(``cv2.undistortPoints``), :func:`optimal_new_camera_matrix`
(``cv2.getOptimalNewCameraMatrix``, alpha=0 style),
:func:`undistort_rectify_map` (``cv2.initUndistortRectifyMap``) and
:func:`remap_bilinear` (``cv2.remap``, INTER_LINEAR, BORDER_CONSTANT=0).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from simpleslam_tpu_torch.utils.precision import highest_precision

_EPS = 1e-12


@highest_precision()
def project_points(X_w: torch.Tensor, T_cw: torch.Tensor, K: torch.Tensor,
                   eps: float = 1e-9
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """World points (..., N, 3) -> (uv (..., N, 2), depth z (..., N),
    in_front (..., N) = z > eps)."""
    R = T_cw[..., :3, :3]
    t = T_cw[..., :3, 3]
    Xc = X_w @ R.transpose(-1, -2) + t[..., None, :]
    z = Xc[..., 2]
    in_front = z > eps
    zs = torch.where(z.abs() < eps, torch.full_like(z, eps), z)
    xn = Xc[..., 0] / zs
    yn = Xc[..., 1] / zs
    fx = K[..., 0, 0][..., None]
    fy = K[..., 1, 1][..., None]
    cx = K[..., 0, 2][..., None]
    cy = K[..., 1, 2][..., None]
    return torch.stack([fx * xn + cx, fy * yn + cy], -1), z, in_front


def pixels_to_normalized(uv: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixel coords (..., N, 2) -> normalised image coords (K^-1 lift)."""
    fx = K[..., 0, 0][..., None]
    fy = K[..., 1, 1][..., None]
    cx = K[..., 0, 2][..., None]
    cy = K[..., 1, 2][..., None]
    return torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], -1)


def normalized_to_pixels(xy: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    fx = K[..., 0, 0][..., None]
    fy = K[..., 1, 1][..., None]
    cx = K[..., 0, 2][..., None]
    cy = K[..., 1, 2][..., None]
    return torch.stack([xy[..., 0] * fx + cx, xy[..., 1] * fy + cy], -1)


def _pad5(D: torch.Tensor) -> torch.Tensor:
    """(k1, k2, p1, p2, k3): ``D`` flattened, zero-padded or cut to 5."""
    D = D.reshape(-1)
    return torch.nn.functional.pad(D, (0, max(0, 5 - D.shape[0])))[:5]


def _distort_normalized(xy: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """Apply Brown-Conrady distortion (k1,k2,p1,p2[,k3]) to normalised
    coords (..., 2)."""
    k1, k2, p1, p2, k3 = _pad5(D).unbind()
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], -1)


@highest_precision()
def distort_points(uv: torch.Tensor, K: torch.Tensor,
                   D: torch.Tensor) -> torch.Tensor:
    """Ideal (undistorted) pixels -> distorted pixels."""
    return normalized_to_pixels(
        _distort_normalized(pixels_to_normalized(uv, K), D), K)


@highest_precision()
def undistort_points(uv: torch.Tensor, K: torch.Tensor,
                     D: Optional[torch.Tensor] = None,
                     P: Optional[torch.Tensor] = None,
                     iters: int = 8) -> torch.Tensor:
    """``cv2.undistortPoints``: distorted pixels -> normalised coords, or
    pixels through ``P``'s intrinsics if given. A fixed-point iteration of
    the inverse distortion, ``iters`` times; with ``D=None`` a plain K^-1
    lift."""
    xy_d = pixels_to_normalized(uv, K)
    xy = xy_d
    if D is not None:
        k1, k2, p1, p2, k3 = _pad5(torch.as_tensor(
            D, dtype=torch.float32, device=uv.device)).unbind()
        for _ in range(iters):
            x, y = xy[..., 0], xy[..., 1]
            r2 = x * x + y * y
            radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
            dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
            dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
            div = torch.clamp(radial, min=_EPS)
            xy = torch.stack([(xy_d[..., 0] - dx) / div,
                              (xy_d[..., 1] - dy) / div], -1)
    if P is not None:
        xy = normalized_to_pixels(xy, P[..., :3, :3] if P.shape[-1] == 4
                                  else P)
    return xy


@highest_precision()
def optimal_new_camera_matrix(K: torch.Tensor, D: torch.Tensor,
                              size_wh: Tuple[int, int]) -> torch.Tensor:
    """Alpha=0-style new camera matrix: ``K`` scaled so that the
    undistorted image's valid inner rectangle fills the frame (32 samples
    per border side of the distorted image, undistorted, inner bounds)."""
    w, h = size_wh
    n = 32
    xs = torch.linspace(0.0, w - 1.0, n, device=K.device)
    ys = torch.linspace(0.0, h - 1.0, n, device=K.device)
    zero = torch.zeros(n, device=K.device)
    border = torch.cat([
        torch.stack([xs, zero], -1),
        torch.stack([xs, torch.full((n,), h - 1.0, device=K.device)], -1),
        torch.stack([zero, ys], -1),
        torch.stack([torch.full((n,), w - 1.0, device=K.device), ys], -1)])
    und = undistort_points(border, K, D, P=K)
    top = und[:n, 1].max()
    bot = und[n:2 * n, 1].min()
    left = und[2 * n:3 * n, 0].max()
    right = und[3 * n:, 0].min()
    sx = (w - 1.0) / torch.clamp(right - left, min=1.0)
    sy = (h - 1.0) / torch.clamp(bot - top, min=1.0)
    newK = K.clone()
    newK[0, 0] = K[0, 0] * sx
    newK[1, 1] = K[1, 1] * sy
    newK[0, 2] = (K[0, 2] - left) * sx
    newK[1, 2] = (K[1, 2] - top) * sy
    return newK


@highest_precision()
def undistort_rectify_map(K: torch.Tensor, D: torch.Tensor,
                          new_K: torch.Tensor, size_wh: Tuple[int, int]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``cv2.initUndistortRectifyMap``: for each destination pixel
    (through ``new_K``), the source (distorted) pixel to sample, as
    (mapx, mapy), each (h, w)."""
    w, h = size_wh
    vv, uu = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=K.device),
        torch.arange(w, dtype=torch.float32, device=K.device),
        indexing="ij")
    uv = torch.stack([uu, vv], -1).reshape(-1, 2)
    xy = pixels_to_normalized(uv, new_K)
    src = normalized_to_pixels(_distort_normalized(
        xy, torch.as_tensor(D, dtype=torch.float32, device=K.device)), K)
    return src[:, 0].reshape(h, w), src[:, 1].reshape(h, w)


@highest_precision()
def remap_bilinear(img: torch.Tensor, mapx: torch.Tensor,
                   mapy: torch.Tensor) -> torch.Tensor:
    """``cv2.remap`` (INTER_LINEAR, BORDER_CONSTANT=0): ``img`` (H, W) or
    (H, W, C) sampled at the (H', W') source coordinates ``mapx``,
    ``mapy``. Each of the four taps outside the image reads 0 on its own.
    A uint8 image comes back uint8, rounded half to even; any other dtype
    comes back in its own dtype (a float64 image is sampled in float64)."""
    H, W = img.shape[0], img.shape[1]
    chan = img.dim() == 3
    imgf = img if img.dtype == torch.float64 else img.float()
    imgf = imgf if chan else imgf[..., None]
    x0 = torch.floor(mapx)
    y0 = torch.floor(mapy)
    fx = (mapx - x0)[..., None]
    fy = (mapy - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()

    def gather(yi, xi):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        vals = imgf[yi.clamp(0, H - 1), xi.clamp(0, W - 1)]
        return torch.where(valid[..., None], vals, torch.zeros_like(vals))

    v00 = gather(y0i, x0i)
    v01 = gather(y0i, x0i + 1)
    v10 = gather(y0i + 1, x0i)
    v11 = gather(y0i + 1, x0i + 1)
    out = (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
           + v10 * (1 - fx) * fy + v11 * fx * fy)
    if img.dtype == torch.uint8:
        out = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    else:
        out = out.to(img.dtype)
    return out if chan else out[..., 0]
