"""AKAZE-style front-end (the counterpart of
``simpleslam_tpu/ops/features_akaze.py``): a nonlinear scale space by
Fast Explicit Diffusion, scale-normalised Hessian extrema and a rotated
M-LDB binary descriptor, dense tensor work on the image's device.

* Scale space: Perona-Malik g2 conductivity ``1 / (1 + |grad Ls|^2 / k^2)``
  with the contrast ``k`` at the 70th percentile of the smoothed gradient
  magnitudes (``torch.quantile``, linear interpolation, as
  ``jnp.percentile``), evolved by FED cycles between the sub-levels'
  evolution times; each octave is the last level halved by
  ``jax.image.resize``'s antialiased linear resize (``F.interpolate``'s
  bilinear with ``antialias=True``). The FED step sizes are the
  reference's numpy float32 values, unrolled in Python as there.
* Detection: per-level scale-normalised determinant of Hessian, 3x3
  non-maximum suppression, a per-level budget taken by an exact top-k
  (the reference's ``approx_max_k`` is exact on the CPU; ties to the
  lower index), then a top-k over the levels, coordinates at level 0.
* Description: M-LDB over 2x2, 3x3 and 4x4 cell grids of (intensity, dx,
  dy) cell means, 486 bits packed LSB-first into 64 bytes (pad bits zero).
  The cell means are the reference's rotated sampling tables (``_MLDB_W``,
  built in numpy at import) applied to the keypoint's patch for its
  orientation bin, in float32 with TF32 off.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from simpleslam_tpu_torch.core.types import Features
from simpleslam_tpu_torch.ops.features import (_PATCH_R, _PATCH_SIDE,
                                               _extract_patches,
                                               _gaussian_kernel, _grad,
                                               _nms3,
                                               _orientation_from_patches,
                                               _sep_conv, _shift2d,
                                               _top_k_stable, pad_rows)
from simpleslam_tpu_torch.utils.precision import highest_precision

_TAU_MAX = 0.25
_N_ANGLE_BINS = 30
_DESC_BYTES = 64            # 486 M-LDB bits -> 512-bit container
_GRIDS = (2, 3, 4)          # M-LDB cell grids
_MLDB_R = 12.0              # descriptor patch radius (level pixels)


def _fed_tau(n: int, T: float) -> np.ndarray:
    """FED step sizes for one cycle of n steps covering total time T."""
    j = np.arange(n)
    tau = _TAU_MAX / (4.0 * np.cos(np.pi * (2 * j + 1) / (4 * n + 2)) ** 2)
    return (tau * (T / tau.sum())).astype(np.float32)


def _fed_cycle_steps(T: float) -> int:
    """Number of FED steps needed to cover time T stably."""
    n = int(np.ceil(0.5 * (np.sqrt(1.0 + 12.0 * T / _TAU_MAX) - 1.0)))
    return max(n, 1)


def _diffuse(L: torch.Tensor, g: torch.Tensor, taus: np.ndarray
             ) -> torch.Tensor:
    """Explicit diffusion steps d L/dt = div(g grad L) (half-point
    fluxes)."""
    gE = 0.5 * (g + _shift2d(g, 1, 0))
    gW = 0.5 * (g + _shift2d(g, -1, 0))
    gS = 0.5 * (g + _shift2d(g, 0, 1))
    gN = 0.5 * (g + _shift2d(g, 0, -1))
    for tau in taus:
        fE = gE * (_shift2d(L, 1, 0) - L)
        fW = gW * (_shift2d(L, -1, 0) - L)
        fS = gS * (_shift2d(L, 0, 1) - L)
        fN = gN * (_shift2d(L, 0, -1) - L)
        L = L + float(tau) * (fE + fW + fS + fN)
    return L


def _hessian_response(L: torch.Tensor, sigma: float) -> torch.Tensor:
    """Scale-normalised determinant of Hessian."""
    Lx, Ly = _grad(L)
    Lxx, Lxy = _grad(Lx)
    _, Lyy = _grad(Ly)
    return (sigma ** 2) ** 2 * (Lxx * Lyy - Lxy * Lxy)


def _mldb_tables() -> np.ndarray:
    """(BINS, N_CELLS, PATCH_SIDE^2) rotated cell-mean sampling matrices
    (the reference's numpy construction)."""
    P = _PATCH_SIDE
    n_cells = sum(g * g for g in _GRIDS)
    W = np.zeros((_N_ANGLE_BINS, n_cells, P * P), np.float32)
    # sample each cell on a 4x4 sub-grid of points
    sub = (np.arange(4) + 0.5) / 4.0
    for b in range(_N_ANGLE_BINS):
        a = -np.pi + 2.0 * np.pi * b / _N_ANGLE_BINS
        c, s = np.cos(a), np.sin(a)
        ci = 0
        for gdiv in _GRIDS:
            cell = 2.0 * _MLDB_R / gdiv
            for gy in range(gdiv):
                for gx in range(gdiv):
                    x0 = -_MLDB_R + gx * cell
                    y0 = -_MLDB_R + gy * cell
                    pts = np.stack(np.meshgrid(x0 + sub * cell,
                                               y0 + sub * cell), -1)
                    pts = pts.reshape(-1, 2)
                    rx = c * pts[:, 0] - s * pts[:, 1]
                    ry = s * pts[:, 0] + c * pts[:, 1]
                    px = np.clip(rx + _PATCH_R, 0, P - 1.001)
                    py = np.clip(ry + _PATCH_R, 0, P - 1.001)
                    x0i = np.floor(px).astype(int)
                    y0i = np.floor(py).astype(int)
                    fx, fy = px - x0i, py - y0i
                    w = 1.0 / len(pts)
                    np.add.at(W[b, ci], y0i * P + x0i, w * (1 - fx) * (1 - fy))
                    np.add.at(W[b, ci], y0i * P + x0i + 1, w * fx * (1 - fy))
                    np.add.at(W[b, ci], (y0i + 1) * P + x0i, w * (1 - fx) * fy)
                    np.add.at(W[b, ci], (y0i + 1) * P + x0i + 1, w * fx * fy)
                    ci += 1
    return W


_MLDB_W = _mldb_tables()


def _mldb_pairs() -> np.ndarray:
    """(162, 2) within-grid cell index pairs (x 3 channels = 486 bits)."""
    pairs = []
    off = 0
    for gdiv in _GRIDS:
        n = gdiv * gdiv
        for i in range(n):
            for j in range(i + 1, n):
                pairs.append((off + i, off + j))
        off += n
    return np.asarray(pairs, np.int32)


_MLDB_PAIRS = _mldb_pairs()


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    """The M-LDB tables and pairs on ``device``, copied once."""
    pairs = torch.as_tensor(_MLDB_PAIRS.astype(np.int64), device=device)
    return torch.as_tensor(_MLDB_W, device=device), pairs[:, 0], pairs[:, 1]


def _mldb_describe(patches_l: torch.Tensor, patches_gx: torch.Tensor,
                   patches_gy: torch.Tensor, theta: torch.Tensor
                   ) -> torch.Tensor:
    """(N, 64) uint8 M-LDB descriptors from the shared patches."""
    B = _N_ANGLE_BINS
    Wt, pi_, pj_ = _tables(patches_l.device)
    bins = torch.round((theta + math.pi) * B / (2.0 * math.pi)).long() % B
    Wb = Wt[bins]                                      # (N, C, P^2)

    def cell_means(patches):
        pflat = patches.reshape(patches.shape[0], -1, 1)
        with highest_precision():
            return torch.bmm(Wb, pflat)[..., 0]        # (N, C)

    mi = cell_means(patches_l)
    mx = cell_means(patches_gx)
    my = cell_means(patches_gy)
    # rotate the gradient means into the keypoint frame
    cth = torch.cos(theta)[:, None]
    sth = torch.sin(theta)[:, None]
    mdx = cth * mx + sth * my
    mdy = -sth * mx + cth * my
    bits = torch.cat([mi[:, pi_] > mi[:, pj_], mdx[:, pi_] > mdx[:, pj_],
                      mdy[:, pi_] > mdy[:, pj_]], 1).to(torch.uint8)
    bits = F.pad(bits, (0, _DESC_BYTES * 8 - bits.shape[1]))
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    return (bits.reshape(-1, _DESC_BYTES, 8) << shifts).sum(
        -1, dtype=torch.uint8)


def resize_half(L: torch.Tensor) -> torch.Tensor:
    """``jax.image.resize(L, (H // 2, W // 2), "linear")``: the antialiased
    bilinear halving of one level."""
    H, W = L.shape
    return F.interpolate(L[None, None], size=(H // 2, W // 2),
                         mode="bilinear", align_corners=False,
                         antialias=True)[0, 0]


def nonlinear_scale_space(img: torch.Tensor, n_octaves: int = 4,
                          n_sublevels: int = 4, sigma0: float = 1.6):
    """The FED nonlinear scale space: a list of (L, sigma, octave) per
    evolution level; octave o's images are 2^o-downsampled."""
    img = img.float() / 255.0
    g1 = _gaussian_kernel(1.0, 2, img.device)

    def smooth(a):
        return _sep_conv(_sep_conv(a, g1).T, g1).T

    base = smooth(img)
    gx, gy = _grad(base)
    gmag = torch.sqrt(gx * gx + gy * gy)
    k = torch.clamp(torch.quantile(gmag.reshape(-1), 0.7,
                                   interpolation="linear"), min=1e-4)

    levels = []
    L = base
    t_prev = 0.5 * sigma0 ** 2
    for o in range(n_octaves):
        for s_ in range(n_sublevels):
            sigma = sigma0 * (2.0 ** (o + s_ / n_sublevels))
            t = 0.5 * sigma ** 2
            # evolution time in this octave's pixel grid
            dt = (t - t_prev) / (4.0 ** o)
            if dt > 1e-6:
                gxl, gyl = _grad(smooth(L))
                g = 1.0 / (1.0 + (gxl * gxl + gyl * gyl) / (k * k))
                n = _fed_cycle_steps(float(dt))
                L = _diffuse(L, g, _fed_tau(n, float(dt)))
            levels.append((L, float(sigma), o))
            t_prev = t
        if o + 1 < n_octaves:
            L = resize_half(L)
    return levels


@highest_precision()
def akaze_detect_and_describe(img: torch.Tensor, max_kp: int = 1024,
                              n_octaves: int = 4, n_sublevels: int = 4,
                              thresh: float = 1e-5) -> Features:
    """AKAZE on one grey image (0-255) -> padded :class:`Features` on its
    device: level-0 keypoint coordinates, (max_kp, 64) uint8 M-LDB
    descriptors."""
    levels = nonlinear_scale_space(img, n_octaves, n_sublevels)
    dev = levels[0][0].device
    budget = max(8, max_kp // len(levels))
    border = _PATCH_R + 2

    xs_all, ys_all, sc_all, ds_all = [], [], [], []
    for (L, sigma, o) in levels:
        Hl, Wl = L.shape
        if min(Hl, Wl) < 2 * border + 4:
            break
        resp = _hessian_response(L, sigma / (2.0 ** o))
        ninf = torch.full_like(resp, -math.inf)
        resp = _nms3(torch.where(resp > thresh, resp, ninf))
        yy = torch.arange(Hl, device=dev)[:, None]
        xx = torch.arange(Wl, device=dev)[None, :]
        inb = ((xx >= border) & (xx < Wl - border)
               & (yy >= border) & (yy < Hl - border))
        resp = torch.where(inb, resp, ninf)
        v, idx = _top_k_stable(resp.reshape(-1), budget)
        ys, xs = idx // Wl, idx % Wl

        gx, gy = _grad(L)
        p_l = _extract_patches(L, xs, ys)
        theta = _orientation_from_patches(p_l)
        desc = _mldb_describe(p_l, _extract_patches(gx, xs, ys),
                              _extract_patches(gy, xs, ys), theta)

        s = 2.0 ** o
        xs_all.append(xs.float() * s)
        ys_all.append(ys.float() * s)
        sc_all.append(v)
        ds_all.append(desc)

    xs, ys = torch.cat(xs_all), torch.cat(ys_all)
    sc, ds = torch.cat(sc_all), torch.cat(ds_all)
    top_v, top_i = _top_k_stable(sc, min(max_kp, sc.shape[0]))
    valid = torch.isfinite(top_v)
    kpts = torch.stack([xs[top_i], ys[top_i]], -1)
    kpts, desc, top_v, valid = pad_rows(max_kp, kpts, ds[top_i], top_v, valid)
    return Features(kpts=kpts, desc=desc,
                    scores=torch.where(valid, top_v, torch.zeros_like(top_v)),
                    valid=valid)
