"""Plain counterparts of the cv2 calls that the reference's photograph
paths make (``simpleslam_tpu/tools/synth.py::PhotoScene``,
``simpleslam_tpu/models/train.py::PhotoPairPool``,
``simpleslam_tpu/tools/real_eval.py``), in numpy and PyTorch:

* :func:`get_perspective_transform` -- ``cv2.getPerspectiveTransform``:
  the 8x8 system in float64, its products of coordinates taken in float32
  as cv2 takes them from ``Point2f``;
* :func:`get_rotation_matrix_2d` -- ``cv2.getRotationMatrix2D``'s closed
  form;
* :func:`warp_perspective` -- ``cv2.warpPerspective`` (INTER_LINEAR,
  BORDER_CONSTANT 0): ``dst(p) = src(M^-1 p)`` through
  ``ops/projection.py::remap_bilinear``, uint8, float32 or float64;
* :func:`gaussian_blur` -- ``cv2.GaussianBlur(src, (0, 0), sigma)`` on
  float32 or float64: cv2's kernel size from sigma (``round(8 sigma + 1)
  | 1``), its kernel in the image's precision, BORDER_REFLECT_101;
* :func:`imread_gray` -- ``cv2.imread(path, IMREAD_GRAYSCALE)``: PNG
  through ``utils/png.py``, colour made grey as cv2's PNG decoder makes it
  (libpng's ``(9797 R + 19234 G + 3737 B) >> 15``); any other file
  (JPEG) through cv2, imported at call time;
* :func:`resize_area_u8` -- ``cv2.resize(..., INTER_AREA)`` of a uint8
  image, shrinking, over ``utils/resize.py::resize_area``.

Nothing here imports cv2 at module level.
"""
from __future__ import annotations

import math
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from simpleslam_tpu_torch.ops.projection import remap_bilinear
from simpleslam_tpu_torch.utils.png import SIGNATURE, decode_png
from simpleslam_tpu_torch.utils.precision import highest_precision
from simpleslam_tpu_torch.utils.resize import resize_area

# libpng's png_set_rgb_to_gray(png_ptr, 1, 0.299, 0.587) in 1/32768ths: the
# red and green weights truncated, blue the rest
_PNG_GREY = (9797, 19234, 32768 - 9797 - 19234)
# cv2's fixed-point warp resolution (1 << INTER_BITS steps a pixel)
_INTER_TAB = 32.0


def get_perspective_transform(src, dst) -> np.ndarray:
    """(3, 3) float64 homography taking the four ``src`` points to ``dst``
    ((4, 2) each, as float32 like cv2's ``Point2f``)."""
    s = np.asarray(src, np.float32).reshape(4, 2)
    d = np.asarray(dst, np.float32).reshape(4, 2)
    a = np.zeros((8, 8), np.float64)
    b = np.zeros(8, np.float64)
    for i in range(4):
        a[i, 0] = a[i + 4, 3] = s[i, 0]
        a[i, 1] = a[i + 4, 4] = s[i, 1]
        a[i, 2] = a[i + 4, 5] = 1.0
        a[i, 6] = -s[i, 0] * d[i, 0]              # float32 products, as cv2
        a[i, 7] = -s[i, 1] * d[i, 0]
        a[i + 4, 6] = -s[i, 0] * d[i, 1]
        a[i + 4, 7] = -s[i, 1] * d[i, 1]
        b[i] = d[i, 0]
        b[i + 4] = d[i, 1]
    return np.append(np.linalg.solve(a, b), 1.0).reshape(3, 3)


def get_rotation_matrix_2d(center: Tuple[float, float], angle: float,
                           scale: float) -> np.ndarray:
    """(2, 3) float64 rotation by ``angle`` degrees (counter-clockwise in
    the image) and scaling about ``center`` (float32, like ``Point2f``)."""
    cx, cy = (float(np.float32(c)) for c in center)
    ang = angle * math.pi / 180.0
    alpha = math.cos(ang) * scale
    beta = math.sin(ang) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def warp_perspective(img, M, dsize: Tuple[int, int]) -> torch.Tensor:
    """``img`` (H, W) uint8, float32 or float64 (tensor or array) warped by
    the homography ``M`` into a (dsize[1], dsize[0]) image on ``img``'s
    device, in its dtype; source taps outside the image read 0. As cv2 5
    does, uint8 and float32 images are sampled at the exact source point
    and float64 ones at the point rounded to 1/32 pixel (``INTER_BITS``,
    half to even)."""
    src = img if torch.is_tensor(img) else torch.from_numpy(np.asarray(img))
    W, H = int(dsize[0]), int(dsize[1])
    Minv = torch.as_tensor(np.linalg.inv(np.asarray(M, np.float64)),
                           device=src.device)
    yy, xx = torch.meshgrid(
        torch.arange(H, dtype=torch.float64, device=src.device),
        torch.arange(W, dtype=torch.float64, device=src.device),
        indexing="ij")
    q = torch.stack([xx, yy, torch.ones_like(xx)], -1) @ Minv.T
    w = q[..., 2]
    w = torch.where(w == 0, torch.full_like(w, float("inf")), w)
    mapx, mapy = q[..., 0] / w, q[..., 1] / w
    if src.dtype == torch.float64:
        mapx = torch.round(mapx * _INTER_TAB) / _INTER_TAB
        mapy = torch.round(mapy * _INTER_TAB) / _INTER_TAB
    else:
        mapx, mapy = mapx.float(), mapy.float()
    # a point at infinity or far outside samples nothing
    far = ~(torch.isfinite(mapx) & torch.isfinite(mapy)) \
        | (mapx.abs() > 1e7) | (mapy.abs() > 1e7)
    mapx = torch.where(far, torch.full_like(mapx, -2.0), mapx)
    mapy = torch.where(far, torch.full_like(mapy, -2.0), mapy)
    return remap_bilinear(src, mapx, mapy)


def gaussian_kernel(sigma: float, dtype=np.float32) -> np.ndarray:
    """cv2's Gaussian kernel for a float image and ``ksize`` 0:
    ``getGaussianKernel(round(8 sigma + 1) | 1, sigma, ktype)``, ``ktype``
    float32 for a float32 image and float64 for a float64 one."""
    n = int(np.rint(sigma * 4 * 2 + 1)) | 1
    x = np.arange(n, dtype=np.float64) - (n - 1) * 0.5
    t = np.exp(-0.5 / (sigma * sigma) * x * x).astype(dtype)
    s = 1.0 / float(np.sum(t.astype(np.float64)))
    return (t.astype(np.float64) * s).astype(dtype)


def reflect101(idx: np.ndarray, n: int) -> np.ndarray:
    """BORDER_REFLECT_101 indices (cv2's ``borderInterpolate``, repeated
    for offsets past one image length)."""
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    m = np.mod(idx, period)
    return np.where(m < n, m, period - m)


@highest_precision()
def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """``cv2.GaussianBlur(img, (0, 0), sigmaX=sigma)`` of an (H, W) float32
    or float64 tensor, in its dtype: the separable kernel along rows, then
    columns."""
    x = img if img.dtype == torch.float64 else img.float()
    k = gaussian_kernel(sigma, np.float64 if x.dtype == torch.float64
                        else np.float32)
    r = len(k) // 2
    kt = torch.as_tensor(k, device=img.device)
    H, W = img.shape
    kt = kt.reshape(1, 1, -1)
    cols = torch.as_tensor(reflect101(np.arange(-r, W + r), W),
                           device=img.device)
    xr = F.conv1d(x[:, cols][:, None], kt)[:, 0]              # (H, W)
    rows = torch.as_tensor(reflect101(np.arange(-r, H + r), H),
                           device=img.device)
    return F.conv1d(xr[rows].T.contiguous()[:, None], kt)[:, 0].T.contiguous()


def png_to_gray(px: np.ndarray) -> np.ndarray:
    """A decoded PNG (grey, grey+alpha as BGRA, BGR or BGRA) as cv2's
    IMREAD_GRAYSCALE gives it: alpha dropped, colour weighted by libpng's
    integer rule."""
    if px.ndim == 2:
        return px
    b, g, r = (px[..., i].astype(np.int64) for i in range(3))
    cr, cg, cb = _PNG_GREY
    return ((cr * r + cg * g + cb * b) >> 15).astype(np.uint8)


def imread_gray(path: str) -> Optional[np.ndarray]:
    """``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``: (H, W) uint8, or None
    where the file is missing or cannot be decoded. PNG is decoded here;
    other formats (JPEG) need cv2, imported at this call, and raise
    ImportError naming the file without it."""
    if not os.path.isfile(path):
        return None
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(SIGNATURE):
        try:
            return png_to_gray(decode_png(data))
        except ValueError:
            pass                       # 16-bit, palette, interlaced: cv2
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{path}: reading this image needs cv2 (only PNG "
                          "is decoded without it)") from e
    return cv2.imread(path, cv2.IMREAD_GRAYSCALE)


def resize_area_u8(img: np.ndarray, out_hw: Sequence[int]) -> np.ndarray:
    """``cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA)`` of an
    (H, W) uint8 image, shrinking: the area means rounded as cv2 rounds
    them, half up where both axes halve exactly (its 2x2 integer path),
    else half to even (within one level of cv2 off whole factors)."""
    Hi, Wi = img.shape[:2]
    Ho, Wo = int(out_hw[0]), int(out_hw[1])
    out = resize_area(torch.from_numpy(np.asarray(img, np.float32)), (Ho, Wo))
    halves = Hi == 2 * Ho and Wi == 2 * Wo
    out = torch.floor(out + 0.5) if halves else torch.round(out)
    return torch.clamp(out, 0, 255).to(torch.uint8).numpy()
