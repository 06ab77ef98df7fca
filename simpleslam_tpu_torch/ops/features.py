"""Classical feature front-end: ORB-style oriented FAST + steered BRIEF over
an image pyramid (the counterpart of ``simpleslam_tpu/ops/features.py``),
dense tensor work on the image's device.

* FAST-16 for every pixel at once: the 16 circle taps as shifted views,
  the ">= 9 contiguous" arc test as a running count over the circle;
* Harris response (Sobel gradients, Gaussian window) ranks the corners;
* 3x3 non-maximum suppression, a border mask and a per-level top-k (ties
  to the lower pixel index, as ``lax.top_k``) into a fixed-size set;
* orientation by intensity centroid (radius 15) and 256-bit steered BRIEF
  sampled from the blurred image, packed LSB-first into (N, 32) uint8;
* a 1.2 pyramid (``jax.image.resize``'s antialiased linear,
  ``utils/resize.py::resize_linear_like_jax``), coordinates at level 0.

The BRIEF pattern and its 30 rotated bilinear sampling tables are the
reference's numpy arrays, bit for bit. The reference samples through one
dense (N, 1024) x (1024, 30 x 512) product and keeps one bin's columns;
here each keypoint gathers its bin's four bilinear taps per pattern point
(the same nonzero terms, 1/30 of the arithmetic, another summation order).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from simpleslam_tpu_torch.core.types import Features
from simpleslam_tpu_torch.utils.precision import highest_precision
from simpleslam_tpu_torch.utils.resize import resize_linear_like_jax

# 16-pixel Bresenham circle of radius 3 (FAST-16 tap layout), (dx, dy)
_FAST_OFFSETS = np.array([
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
], np.int32)

_N_BITS = 256
_PATCH_R = 15          # orientation / descriptor patch radius
_BORDER = 19           # keypoints are rejected closer than this to the edge
_N_ANGLE_BINS = 30     # orientation quantised to 30 x 12 degrees
_PATCH_SIDE = 2 * _PATCH_R + 2   # +1 ring for bilinear corners


def _brief_pattern(seed: int = 7) -> np.ndarray:
    """(256, 2, 2) sampling pairs ~ N(0, (patch/2.2)^2), kept inside the
    disc of radius patch-1 so every rotation stays inside the patch."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, _PATCH_R / 2.2, size=(_N_BITS * 2, 2))
    nrm = np.linalg.norm(pts, axis=1, keepdims=True)
    lim = _PATCH_R - 1.0
    pts = pts * np.minimum(1.0, lim / np.maximum(nrm, 1e-9))
    return pts.reshape(_N_BITS, 2, 2).astype(np.float32)


def _bilinear_taps(b: int):
    """Bin ``b``'s rotated pattern: (512, 4) flat patch indices and float64
    weights of its bilinear corners, in ascending index order."""
    pat = _brief_pattern().reshape(-1, 2)
    B, P = _N_ANGLE_BINS, _PATCH_SIDE
    a = -np.pi + 2.0 * np.pi * b / B
    c, s = np.cos(a), np.sin(a)
    px = np.clip(c * pat[:, 0] - s * pat[:, 1] + _PATCH_R, 0.0, P - 1.001)
    py = np.clip(s * pat[:, 0] + c * pat[:, 1] + _PATCH_R, 0.0, P - 1.001)
    x0 = np.floor(px).astype(int)
    y0 = np.floor(py).astype(int)
    fx, fy = px - x0, py - y0
    idx = np.stack([y0 * P + x0, y0 * P + x0 + 1, (y0 + 1) * P + x0,
                    (y0 + 1) * P + x0 + 1], axis=1)
    w = np.stack([(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy,
                  fx * fy], axis=1)
    return idx, w


def _brief_weight_tables() -> np.ndarray:
    """(BINS, 512, PATCH_SIDE^2) float32 bilinear sampling matrices, one
    per quantised rotation (the reference's dense tables)."""
    P = _PATCH_SIDE
    W = np.zeros((_N_ANGLE_BINS, 2 * _N_BITS, P * P), np.float32)
    rows = np.arange(2 * _N_BITS)
    for b in range(_N_ANGLE_BINS):
        idx, w = _bilinear_taps(b)
        for t in range(4):
            np.add.at(W[b], (rows, idx[:, t]), w[:, t])
    return W


@functools.lru_cache(maxsize=None)
def _brief_taps_np() -> Tuple[np.ndarray, np.ndarray]:
    """(BINS, 512, 4) tap indices and float32 weights: the nonzero entries
    of :func:`_brief_weight_tables`, whose single adds round the same
    float64 weights to float32."""
    taps = [_bilinear_taps(b) for b in range(_N_ANGLE_BINS)]
    return (np.stack([t[0] for t in taps]).astype(np.int64),
            np.stack([t[1] for t in taps]).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> Dict[str, torch.Tensor]:
    """The constant tensors on ``device``, made once (a copy from the host
    waits for the device): the BRIEF taps ``idx``/``w``, the orientation
    moment weights ``wx``/``wy`` and the filter kernels."""
    idx, w = _brief_taps_np()
    r, P = _PATCH_R, _PATCH_SIDE
    dy, dx = np.mgrid[-r:r + 1, -r:r + 1]
    disc = (dx * dx + dy * dy) <= r * r
    wx = np.zeros((P, P), np.float32)
    wy = np.zeros((P, P), np.float32)
    wx[:2 * r + 1, :2 * r + 1] = np.where(disc, dx, 0)
    wy[:2 * r + 1, :2 * r + 1] = np.where(disc, dy, 0)
    t = {name: torch.as_tensor(a, device=device) for name, a in (
        ("idx", idx), ("w", w), ("wx", wx.reshape(-1)),
        ("wy", wy.reshape(-1)),
        ("sobel", np.array([-1.0, 0.0, 1.0], np.float32)),
        ("smooth", np.array([1.0, 2.0, 1.0], np.float32)))}
    t["smooth"] = t["smooth"] / 4.0
    t["g_harris"] = _gaussian_kernel(1.5, 3, device)
    t["g_blur"] = _gaussian_kernel(2.0, 4, device)
    return t


def _shifted(img: torch.Tensor, offsets) -> torch.Tensor:
    """(len(offsets), H, W): out[i, y, x] = img[y + dy_i, x + dx_i] for
    each (dx_i, dy_i), zero padded (one pad, then views)."""
    H, W = img.shape
    r = max(max(abs(int(dx)), abs(int(dy))) for dx, dy in offsets)
    p = F.pad(img, (r, r, r, r))
    return torch.stack([p[r + int(dy):r + int(dy) + H,
                          r + int(dx):r + int(dx) + W]
                        for dx, dy in offsets])


def _shift2d(img: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """``out[..., y, x] = img[..., y + dy, x + dx]``, zero padded (the
    reference's ``_shift2d``, over any leading dimensions)."""
    H, W = img.shape[-2:]
    r = max(abs(dx), abs(dy))
    p = F.pad(img, (r, r, r, r))
    return p[..., r + dy:r + dy + H, r + dx:r + dx + W]


def _grad(img: torch.Tensor):
    """Central-difference gradients (gx, gy), zero padded."""
    gx = 0.5 * (_shift2d(img, 1, 0) - _shift2d(img, -1, 0))
    gy = 0.5 * (_shift2d(img, 0, 1) - _shift2d(img, 0, -1))
    return gx, gy


def _conv_rows(x4: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """Correlate along H with a 1-D kernel, zero padded to the same size."""
    k = kern.shape[0]
    return F.conv2d(F.pad(x4, (0, 0, k // 2, k // 2)), kern.view(1, 1, k, 1))


def _conv_cols(x4: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    k = kern.shape[0]
    return F.conv2d(F.pad(x4, (k // 2, k // 2, 0, 0)), kern.view(1, 1, 1, k))


def _sep_conv(img: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """Separable 2-D correlation (same size, zero padded): rows, then
    columns."""
    return _conv_cols(_conv_rows(img[None, None], kern), kern)[0, 0]


def _gaussian_kernel(sigma: float, radius: int, device=None) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def harris_response(img: torch.Tensor) -> torch.Tensor:
    """Dense Harris corner response (Sobel gradients + Gaussian window)."""
    f = img.float()[None, None]
    t = _tables(f.device)
    sobel, smooth, g = t["sobel"], t["smooth"], t["g_harris"]
    gx = _conv_rows(_conv_cols(f, sobel), smooth)[0, 0]
    gy = _conv_rows(_conv_cols(f, smooth), sobel)[0, 0]
    Ixx = _sep_conv(gx * gx, g)
    Iyy = _sep_conv(gy * gy, g)
    Ixy = _sep_conv(gx * gy, g)
    return (Ixx * Iyy - Ixy * Ixy) - 0.04 * (Ixx + Iyy) ** 2


def fast_score_map(img: torch.Tensor, thresh: float = 20.0,
                   harris: torch.Tensor = None) -> torch.Tensor:
    """(H, W) float32: -inf where the FAST-16 arc test (>= 9 contiguous
    circle pixels all brighter or all darker by ``thresh``) fails, the
    Harris response where it passes."""
    f = img.float()
    taps = _shifted(f, _FAST_OFFSETS)                           # (16, H, W)

    def arc9(m):
        # a run of 9 set positions on the circle: count over the circle
        # unrolled by 8, any window of 9 that sums to 9
        c = torch.cumsum(torch.cat([m, m[:8]]).to(torch.int32), 0)
        c = torch.cat([torch.zeros_like(c[:1]), c])
        return ((c[9:25] - c[:16]) == 9).any(0)

    corner = arc9(taps > (f + thresh)[None]) | arc9(taps < (f - thresh)[None])
    if harris is None:
        harris = harris_response(img)
    return torch.where(corner, harris, torch.full_like(harris, -math.inf))


def _gather2d(a: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor):
    """``a[ys, xs]`` with JAX's index rules: negative indices wrap once,
    indices past the end clamp."""
    H, W = a.shape
    ys = torch.where(ys < 0, ys + H, ys).clamp(0, H - 1)
    xs = torch.where(xs < 0, xs + W, xs).clamp(0, W - 1)
    return a[ys, xs]


def _subpixel_offsets(smooth_score: torch.Tensor, xs: torch.Tensor,
                      ys: torch.Tensor):
    """Quadratic-fit subpixel offsets at integer maxima of the (ungated)
    Harris response, clamped to [-0.5, 0.5]."""
    def g(dy, dx):
        return _gather2d(smooth_score, ys + dy, xs + dx)

    def axis_off(m, c, p):
        denom = m - 2.0 * c + p
        small = denom.abs() < 1e-9
        off = 0.5 * (m - p) / torch.where(small, torch.full_like(denom, 1e-9),
                                          denom)
        return torch.clamp(torch.where(small, torch.zeros_like(off), off),
                           -0.5, 0.5)

    return (axis_off(g(0, -1), g(0, 0), g(0, 1)),
            axis_off(g(-1, 0), g(0, 0), g(1, 0)))


def _nms3(score: torch.Tensor) -> torch.Tensor:
    """Keep only strict 3x3 local maxima (neighbours outside are 0)."""
    neigh = _shifted(score, [(dx, dy) for dx in (-1, 0, 1)
                             for dy in (-1, 0, 1) if (dx, dy) != (0, 0)])
    return torch.where(score > neigh.amax(0), score,
                       torch.full_like(score, -math.inf))


def _extract_patches(img_blur: torch.Tensor, xs: torch.Tensor,
                     ys: torch.Tensor) -> torch.Tensor:
    """(N, P, P) keypoint patches, each window's start clamped into the
    image as ``lax.dynamic_slice`` clamps it."""
    H, W = img_blur.shape
    r, P = _PATCH_R, _PATCH_SIDE
    ar = torch.arange(P, device=img_blur.device)
    y0 = torch.clamp(ys - r, 0, H - P)[:, None] + ar
    x0 = torch.clamp(xs - r, 0, W - P)[:, None] + ar
    return img_blur[y0[:, :, None], x0[:, None, :]]


def _orientation_from_patches(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation per keypoint (radius-15 disc)."""
    t = _tables(patches.device)
    pflat = patches.reshape(patches.shape[0], -1)
    return torch.atan2(pflat @ t["wy"], pflat @ t["wx"])


def _brief_from_patches(patches: torch.Tensor, theta: torch.Tensor
                        ) -> torch.Tensor:
    """Steered BRIEF-256 -> (N, 32) uint8, bits LSB-first."""
    t = _tables(patches.device)
    idx_t, w_t = t["idx"], t["w"]
    B = _N_ANGLE_BINS
    bins = torch.round((theta + math.pi) * B / (2.0 * math.pi)).long() % B
    n = patches.shape[0]
    pflat = patches.reshape(n, -1)
    vals = torch.gather(pflat, 1, idx_t[bins].reshape(n, -1)) \
        .reshape(n, 2 * _N_BITS, 4) * w_t[bins]
    sel = ((vals[..., 0] + vals[..., 1]) + vals[..., 2]) + vals[..., 3]
    bits = (sel[:, 0::2] < sel[:, 1::2]).to(torch.uint8).reshape(n, 32, 8)
    shifts = torch.arange(8, dtype=torch.uint8, device=patches.device)
    return (bits << shifts).sum(-1, dtype=torch.uint8)


def _top_k_stable(x: torch.Tensor, k: int):
    """The ``k`` largest values and their indices, ties to the lower index
    (``lax.top_k``; ``approx_max_k`` is exact on the CPU)."""
    v, i = torch.sort(x, descending=True, stable=True)
    return v[:k], i[:k]


def pad_rows(n: int, kpts, desc, top_v, valid):
    """The final top-k's rows padded to ``n``: zero keypoints and
    descriptors, ``-inf`` scores, invalid."""
    pad = n - kpts.shape[0]
    if pad <= 0:
        return kpts, desc, top_v, valid

    def padded(a, fill=0):
        return torch.cat([a, torch.full((pad,) + a.shape[1:], fill,
                                        dtype=a.dtype, device=a.device)])
    return padded(kpts), padded(desc), padded(top_v, -math.inf), padded(valid)


@highest_precision()
def orb_detect_and_describe(img: torch.Tensor, max_kp: int = 1024,
                            n_levels: int = 8, scale: float = 1.2,
                            fast_thresh: float = 20.0) -> Features:
    """ORB on one grey image -> padded :class:`Features` on its device:
    level-0 keypoint coordinates, (max_kp, 32) uint8 descriptors, the
    per-level budgets split geometrically as cv2.ORB does."""
    img = img.float()
    dev = img.device
    inv = [scale ** (-i) for i in range(n_levels)]
    total = sum(inv)
    budgets = [max(8, int(round(max_kp * v / total))) for v in inv]
    budgets[0] += max_kp - sum(budgets)

    xs_all, ys_all, sc_all, ds_all = [], [], [], []
    level_img = img
    g_blur = _tables(dev)["g_blur"]
    for lvl in range(n_levels):
        Hl, Wl = level_img.shape
        if min(Hl, Wl) < 2 * _BORDER + 4:
            break
        harris = harris_response(level_img)
        score = _nms3(fast_score_map(level_img, fast_thresh, harris=harris))
        yy = torch.arange(Hl, device=dev)[:, None]
        xx = torch.arange(Wl, device=dev)[None, :]
        inb = ((xx >= _BORDER) & (xx < Wl - _BORDER)
               & (yy >= _BORDER) & (yy < Hl - _BORDER))
        score = torch.where(inb, score, torch.full_like(score, -math.inf))

        top_v, top_i = _top_k_stable(score.reshape(-1), budgets[lvl])
        ys, xs = top_i // Wl, top_i % Wl
        sub_dx, sub_dy = _subpixel_offsets(harris, xs, ys)
        blur = _sep_conv(_sep_conv(level_img, g_blur).T, g_blur).T
        patches = _extract_patches(blur, xs, ys)
        theta = _orientation_from_patches(patches)
        desc = _brief_from_patches(patches, theta)

        s = scale ** lvl
        xs_all.append((xs.float() + sub_dx) * s)
        ys_all.append((ys.float() + sub_dy) * s)
        sc_all.append(top_v)
        ds_all.append(desc)
        if lvl + 1 < n_levels:
            level_img = resize_linear_like_jax(
                level_img, (int(round(Hl / scale)), int(round(Wl / scale))))

    xs, ys = torch.cat(xs_all), torch.cat(ys_all)
    sc, ds = torch.cat(sc_all), torch.cat(ds_all)
    top_v, top_i = _top_k_stable(sc, min(max_kp, sc.shape[0]))
    valid = torch.isfinite(top_v)
    kpts = torch.stack([xs[top_i], ys[top_i]], dim=-1)
    kpts, desc, top_v, valid = pad_rows(max_kp, kpts, ds[top_i], top_v, valid)
    return Features(kpts=kpts, desc=desc,
                    scores=torch.where(valid, top_v, torch.zeros_like(top_v)),
                    valid=valid)


def rgb_to_gray(img_bgr: torch.Tensor) -> torch.Tensor:
    """BGR (H, W, 3) -> float32 grey (ITU-R 601, like cv2), summed in the
    reference's order."""
    img = img_bgr.float()
    return 0.114 * img[..., 0] + 0.587 * img[..., 1] + 0.299 * img[..., 2]
