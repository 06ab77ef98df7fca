"""SIFT-style detector and descriptor (the counterpart of
``simpleslam_tpu/ops/features_sift.py``), dense tensor work on the image's
device.

* a Gaussian scale space per octave and its differences (DoG); each blur
  is the reference's ``_gauss``: a separable 2-D blur applied twice, the
  second time around a transpose, so it is sqrt(2) wider than ``sigma``;
* extrema against the 26 scale-space neighbours at once, the scale
  neighbours taken modulo the number of scales and the first and last
  scale dropped, with the contrast and Hessian edge-ratio gates;
* a per-octave top-k (ties to the lower index, as ``lax.top_k``), then a
  top-k over the octaves, coordinates at level 0, padded rows invalid;
* orientation from a 36-bin gradient histogram (a scatter-add, smoothed,
  its first peak);
* a 128-d descriptor (4 x 4 cells x 8 orientations) sampled on a rotated
  grid at the nearest pixel (round half to even, as ``jnp.round``), soft
  binned in orientation, L2-normalised, clipped at 0.2 and renormalised.

The reference's arithmetic is kept step for step; only float sums run in
another order (the histograms' scatter-adds above all).
"""
from __future__ import annotations

import math

import torch

from simpleslam_tpu_torch.core.types import Features
from simpleslam_tpu_torch.ops.features import (_gaussian_kernel, _grad,
                                               _sep_conv, _shift2d,
                                               _top_k_stable, pad_rows)
from simpleslam_tpu_torch.utils.precision import highest_precision

_BORDER = 16


def _gauss(img: torch.Tensor, sigma: float) -> torch.Tensor:
    r = max(2, int(3 * sigma))
    k = _gaussian_kernel(sigma, r, img.device)
    return _sep_conv(_sep_conv(img, k).T, k).T


def _dog_stack(img: torch.Tensor, n_scales: int = 4, sigma0: float = 1.6):
    """Gaussian stack (S+1, H, W) and DoG stack (S, H, W) of one octave."""
    kfac = 2.0 ** (1.0 / max(n_scales - 1, 1))
    G = torch.stack([_gauss(img, sigma0 * (kfac ** s))
                     for s in range(n_scales + 1)])
    return G, G[1:] - G[:-1]


def _extrema_mask(dog: torch.Tensor, contrast_thresh: float = 0.015,
                  edge_ratio: float = 10.0) -> torch.Tensor:
    """(S, H, W) bool: 26-neighbour extrema with the contrast and edge
    gates; the first and last scale are excluded."""
    hi = lo = None
    for ds in (-1, 0, 1):
        # scale neighbour s + ds, modulo S
        rolled = torch.roll(dog, -ds, 0)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if (ds, dy, dx) == (0, 0, 0):
                    continue
                n = _shift2d(rolled, dx, dy)
                hi = n if hi is None else torch.maximum(hi, n)
                lo = n if lo is None else torch.minimum(lo, n)
    ext = (((dog > hi) & (dog > contrast_thresh))
           | ((dog < lo) & (dog < -contrast_thresh)))
    ext[0] = False
    ext[-1] = False

    dxx = _shift2d(dog, 1, 0) + _shift2d(dog, -1, 0) - 2 * dog
    dyy = _shift2d(dog, 0, 1) + _shift2d(dog, 0, -1) - 2 * dog
    dxy = (_shift2d(dog, 1, 1) + _shift2d(dog, -1, -1)
           - _shift2d(dog, 1, -1) - _shift2d(dog, -1, 1)) * 0.25
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = edge_ratio
    edge_ok = (det > 0) & (tr * tr * r < (r + 1) ** 2 * det)
    return ext & edge_ok


def _window(a: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
            radius: int) -> torch.Tensor:
    """(N, 2r+1, 2r+1) windows centred on the keypoints, each start
    clamped into the image as ``lax.dynamic_slice`` clamps it."""
    H, W = a.shape
    side = 2 * radius + 1
    ar = torch.arange(side, device=a.device)
    y0 = torch.clamp(ys - radius, 0, H - side)[:, None] + ar
    x0 = torch.clamp(xs - radius, 0, W - side)[:, None] + ar
    return a[y0[:, :, None], x0[:, None, :]]


def _orientations(gx, gy, xs, ys, radius: int = 8) -> torch.Tensor:
    """Dominant gradient orientation per keypoint: the first peak of a
    smoothed 36-bin histogram of Gaussian-weighted magnitudes."""
    dev = gx.device
    ar = torch.arange(-radius, radius + 1, device=dev)
    dy, dx = torch.meshgrid(ar, ar, indexing="ij")
    w_g = torch.exp(-(dx * dx + dy * dy).float()
                    / (2.0 * (radius / 1.5) ** 2))
    px = _window(gx, xs, ys, radius)
    py = _window(gy, xs, ys, radius)
    mag = torch.sqrt(px * px + py * py) * w_g
    ang = torch.atan2(py, px)
    bins = torch.floor((ang + math.pi) / (2 * math.pi) * 36).long() % 36
    n = xs.shape[0]
    hist = torch.zeros((n, 36), device=dev).scatter_add_(
        1, bins.reshape(n, -1), mag.reshape(n, -1))
    hist = (torch.roll(hist, 1, 1) + hist + torch.roll(hist, -1, 1)) / 3.0
    peak = torch.argmax(hist, 1)
    return (peak.float() + 0.5) / 36.0 * 2 * math.pi - math.pi


def _descriptors(gx, gy, xs, ys, theta, patch: int = 16) -> torch.Tensor:
    """(N, 128) descriptors: 4 x 4 cells x 8 orientation bins on a grid
    rotated by ``theta``."""
    dev = gx.device
    H, W = gx.shape
    half = patch // 2
    ar = torch.arange(-half, half, device=dev, dtype=torch.float32) + 0.5
    dy, dx = torch.meshgrid(ar, ar, indexing="ij")
    gxs, gys = dx.reshape(-1), dy.reshape(-1)                   # (256,)
    rows = torch.arange(patch, device=dev)
    cell = ((rows[:, None] // (patch // 4)) * 4
            + rows[None, :] // (patch // 4)).reshape(-1)
    c, s = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
    # grid @ R^T + (x, y) with R = [[c, -s], [s, c]]
    ptx = (gxs * c + gys * -s) + xs.float()[:, None]
    pty = (gxs * s + gys * c) + ys.float()[:, None]
    xi = torch.clamp(torch.round(ptx), 0, W - 1).long()
    yi = torch.clamp(torch.round(pty), 0, H - 1).long()
    px = gx[yi, xi]
    py = gy[yi, xi]
    mag = torch.sqrt(px * px + py * py)
    ang = torch.atan2(py, px) - theta[:, None]
    ob = (ang + 3 * math.pi) / (2 * math.pi) * 8.0
    fl = torch.floor(ob)
    o0 = fl.long() % 8
    o1 = (o0 + 1) % 8
    f = ob - fl
    n = xs.shape[0]
    d = torch.zeros((n, 128), device=dev)
    d.scatter_add_(1, cell * 8 + o0, mag * (1 - f))
    d.scatter_add_(1, cell * 8 + o1, mag * f)
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=1, keepdim=True),
                        min=1e-8)
    d = torch.clamp(d, max=0.2)
    return d / torch.clamp(torch.linalg.vector_norm(d, dim=1, keepdim=True),
                           min=1e-8)


@highest_precision()
def sift_detect_and_describe(img: torch.Tensor, max_kp: int = 1024,
                             n_octaves: int = 3) -> Features:
    """SIFT on one grey image (0-255) -> padded :class:`Features` on its
    device: level-0 keypoint coordinates, (max_kp, 128) float32
    descriptors."""
    img = img.float() / 255.0
    dev = img.device
    xs_all, ys_all, sc_all, ds_all = [], [], [], []
    level = img
    for o in range(n_octaves):
        Hl, Wl = level.shape
        if min(Hl, Wl) < 2 * _BORDER + 8:
            break
        k = max(32, max_kp // (2 ** o) // 2)
        G, dog = _dog_stack(level)
        ext = _extrema_mask(dog)
        ninf = torch.full_like(dog, -math.inf)
        score = torch.where(ext, dog.abs(), ninf)
        yy = torch.arange(Hl, device=dev)[None, :, None]
        xx = torch.arange(Wl, device=dev)[None, None, :]
        inb = ((xx >= _BORDER) & (xx < Wl - _BORDER)
               & (yy >= _BORDER) & (yy < Hl - _BORDER))
        score = torch.where(inb, score, ninf)
        top_v, top_i = _top_k_stable(score.reshape(-1), k)
        rem = top_i % (Hl * Wl)
        ys, xs = rem // Wl, rem % Wl

        gx, gy = _grad(G[1])
        theta = _orientations(gx, gy, xs, ys)
        desc = _descriptors(gx, gy, xs, ys, theta)

        sf = 2.0 ** o
        xs_all.append(xs.float() * sf)
        ys_all.append(ys.float() * sf)
        sc_all.append(top_v)
        ds_all.append(desc)
        if o + 1 < n_octaves:
            level = level[::2, ::2]

    xs, ys = torch.cat(xs_all), torch.cat(ys_all)
    sc, ds = torch.cat(sc_all), torch.cat(ds_all)
    top_v, top_i = _top_k_stable(sc, min(max_kp, sc.shape[0]))
    valid = torch.isfinite(top_v)
    kpts = torch.stack([xs[top_i], ys[top_i]], -1)
    desc = ds[top_i]
    kpts, desc, top_v, valid = pad_rows(max_kp, kpts, desc, top_v, valid)
    return Features(kpts=kpts, desc=desc,
                    scores=torch.where(valid, top_v, torch.zeros_like(top_v)),
                    valid=valid)
