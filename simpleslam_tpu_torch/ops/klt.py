"""Pyramidal Lucas-Kanade optical flow (the counterpart of
``simpleslam_tpu/ops/klt.py``), the replacement of
``cv2.calcOpticalFlowPyrLK`` with forward-backward gating.

Batched over points: per pyramid level the window gradients, the 2x2
normal matrices and the iterative updates are computed for all tracked
points at once (N x win^2 bilinear gathers and closed-form 2x2 solves).
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from simpleslam_tpu_torch.utils.precision import highest_precision

_EPS = 1e-9


@highest_precision()
def build_pyramid(img: torch.Tensor, n_levels: int = 4
                  ) -> List[torch.Tensor]:
    """Binomial 5-tap blur (zero padding) and 2x decimation per level."""
    k = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], device=img.device) / 16.0
    levels = [img.float()]
    cur = levels[0]
    for _ in range(n_levels - 1):
        x = F.conv2d(cur[None, None], k.reshape(1, 1, 5, 1), padding=(2, 0))
        x = F.conv2d(x, k.reshape(1, 1, 1, 5), padding=(0, 2))
        cur = x[0, 0, ::2, ::2]
        levels.append(cur)
    return levels


def _sample_bilinear(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """img (H, W); xy (..., 2) -> (...,) bilinear samples, the coordinates
    clamped to [0, W - 1.001] x [0, H - 1.001]."""
    H, W = img.shape
    x = torch.clamp(xy[..., 0], 0.0, W - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    fx = x - x0
    fy = y - y0
    return (img[y0, x0] * (1 - fx) * (1 - fy)
            + img[y0, x0 + 1] * fx * (1 - fy)
            + img[y0 + 1, x0] * (1 - fx) * fy
            + img[y0 + 1, x0 + 1] * fx * fy)


@highest_precision()
def lk_track(img0: torch.Tensor, img1: torch.Tensor, pts0: torch.Tensor,
             *, win: int = 21, iters: int = 10, n_levels: int = 4,
             min_eig: float = 1e-4
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Track ``pts0`` (N, 2) from ``img0`` to ``img1`` (H, W).

    Returns (pts1 (N, 2), status (N,) bool, err (N,) mean |residual|), as
    ``cv2.calcOpticalFlowPyrLK``: status is False where the final window
    leaves the image or a level's normal matrix is degenerate
    (its smaller eigenvalue at most ``min_eig * win * win``)."""
    pyr0 = build_pyramid(img0, n_levels)
    pyr1 = build_pyramid(img1, n_levels)
    dev = pts0.device
    r = win // 2
    dy, dx = torch.meshgrid(torch.arange(-r, r + 1, device=dev),
                            torch.arange(-r, r + 1, device=dev),
                            indexing="ij")
    offs = torch.stack([dx.reshape(-1), dy.reshape(-1)], -1).float()
    ex = torch.tensor([1.0, 0.0], device=dev)
    ey = torch.tensor([0.0, 1.0], device=dev)

    pts0 = pts0.float()
    N = pts0.shape[0]
    flow = torch.zeros((N, 2), device=dev)
    ok = torch.ones((N,), dtype=torch.bool, device=dev)

    for lvl in range(n_levels - 1, -1, -1):
        I0, I1 = pyr0[lvl], pyr1[lvl]
        p0 = pts0 * 0.5 ** lvl
        coords0 = p0[:, None, :] + offs[None, :, :]           # (N, W2, 2)
        T = _sample_bilinear(I0, coords0)
        gx = 0.5 * (_sample_bilinear(I0, coords0 + ex)
                    - _sample_bilinear(I0, coords0 - ex))
        gy = 0.5 * (_sample_bilinear(I0, coords0 + ey)
                    - _sample_bilinear(I0, coords0 - ey))
        Gxx = (gx * gx).sum(1)
        Gxy = (gx * gy).sum(1)
        Gyy = (gy * gy).sum(1)
        det = Gxx * Gyy - Gxy * Gxy
        tr = Gxx + Gyy
        eig_min = 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det,
                                                     min=0.0)))
        solvable = eig_min > min_eig * (win * win)
        det_s = torch.where(det.abs() < _EPS, torch.full_like(det, _EPS),
                            det)
        for _ in range(iters):
            coords1 = (p0 + flow)[:, None, :] + offs[None, :, :]
            rsd = T - _sample_bilinear(I1, coords1)             # (N, W2)
            bx = (gx * rsd).sum(1)
            by = (gy * rsd).sum(1)
            du = (Gyy * bx - Gxy * by) / det_s
            dv = (Gxx * by - Gxy * bx) / det_s
            d = torch.stack([du, dv], -1)
            flow = flow + torch.where(solvable[:, None], d,
                                      torch.zeros_like(d))
        ok = ok & solvable
        if lvl > 0:
            flow = flow * 2.0

    pts1 = pts0 + flow
    H0, W0 = pyr0[0].shape
    Iw = _sample_bilinear(pyr1[0], pts1[:, None, :] + offs[None, :, :])
    T0 = _sample_bilinear(pyr0[0], pts0[:, None, :] + offs[None, :, :])
    err = (T0 - Iw).abs().mean(1)
    inb = ((pts1[:, 0] >= r) & (pts1[:, 0] < W0 - r)
           & (pts1[:, 1] >= r) & (pts1[:, 1] < H0 - r))
    return pts1, ok & inb, err


def fb_track(img0: torch.Tensor, img1: torch.Tensor, pts0: torch.Tensor,
             *, win: int = 21, iters: int = 10, n_levels: int = 4,
             fb_thresh: float = 1.0, err_thresh: float = 20.0):
    """Forward-backward consistent tracking: track 0 -> 1, track back
    1 -> 0, and keep the points whose round trip lands within
    ``fb_thresh`` px and whose photometric error stays below
    ``err_thresh``. Returns (pts1, good (N,) bool, err)."""
    pts1, st_f, err = lk_track(img0, img1, pts0, win=win, iters=iters,
                               n_levels=n_levels)
    pts0b, st_b, _ = lk_track(img1, img0, pts1, win=win, iters=iters,
                              n_levels=n_levels)
    fb = torch.linalg.norm(pts0b - pts0, dim=1)
    good = st_f & st_b & (fb < fb_thresh) & (err < err_thresh)
    return pts1, good, err
