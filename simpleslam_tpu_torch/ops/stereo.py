"""Stereo disparity by block matching (the counterpart of
``simpleslam_tpu/ops/stereo.py``).

One dense cost volume: for each candidate disparity the SAD cost is a
shifted subtraction and a box filter (separable cumsum), the (H, W, D)
volume built in one pass. Winner-take-all with a uniqueness ratio,
parabolic subpixel refinement and a left-right consistency check.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from simpleslam_tpu_torch.utils.precision import highest_precision


def _edge_pad(a: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    n = a.shape[axis]
    return torch.cat([a.narrow(axis, 0, 1).expand(
        *[lo if i == axis else s for i, s in enumerate(a.shape)]),
        a, a.narrow(axis, n - 1, 1).expand(
        *[hi if i == axis else s for i, s in enumerate(a.shape)])], axis)


def _box_filter(x: torch.Tensor, k: int, axes: Tuple[int, int] = (0, 1)
                ) -> torch.Tensor:
    """k x k box sum over ``axes`` by separable cumsums of the edge-padded
    float32 input (same size)."""
    pad = k // 2

    def along(a, axis):
        c = torch.cumsum(_edge_pad(a, axis, pad + 1, pad), dim=axis)
        n = c.shape[axis]
        return c.narrow(axis, k, n - k) - c.narrow(axis, 0, n - k)

    return along(along(x, axes[0]), axes[1])


def _shifted_costs(A: torch.Tensor, B: torch.Tensor, max_disp: int,
                   block: int, right: bool) -> torch.Tensor:
    """(H, W, D) box-filtered |A - B shifted by d| for d < ``max_disp``:
    ``B(x - d)`` zero-filled on the left, or with ``right`` ``B(x + d)``
    zero-filled on the right."""
    H, W = A.shape
    cols = torch.arange(W, device=A.device)
    d = torch.arange(max_disp, device=A.device)[:, None]
    src = cols[None, :] + d if right else cols[None, :] - d     # (D, W)
    inside = (src >= 0) & (src < W)
    Bs = torch.where(inside[:, None, :], B[:, src.clamp(0, W - 1)]
                     .permute(1, 0, 2), torch.zeros((), device=A.device))
    return _box_filter((A[None] - Bs).abs(), block, (1, 2)).permute(1, 2, 0)


@highest_precision()
def disparity_block_match(left: torch.Tensor, right: torch.Tensor,
                          max_disp: int = 64, block: int = 9,
                          uniqueness: float = 0.95, lr_thresh: float = 1.5
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SAD block-matching disparity of a rectified pair.

    left/right: (H, W). Returns (disp (H, W) float32, valid (H, W) bool).
    Invalid pixels: failed left-right check, weak uniqueness, a winner at
    either end of the range, or within ``max_disp`` of the left border."""
    H, W = left.shape
    L = left.float()
    R = right.float()
    D = max_disp
    costs = _shifted_costs(L, R, D, block, right=False)          # (H, W, D)
    cbest, best = torch.min(costs, -1)
    # uniqueness: the best must beat the second best (outside +-1) by the
    # ratio
    didx = torch.arange(D, device=L.device)
    near = (didx[None, None, :] - best[..., None]).abs() <= 1
    second = torch.where(near, torch.full_like(costs, float("inf")),
                         costs).min(-1).values
    unique = cbest <= uniqueness * second
    # parabolic subpixel around the winner
    c0 = costs.gather(-1, (best - 1).clamp(0, D - 1)[..., None])[..., 0]
    c2 = costs.gather(-1, (best + 1).clamp(0, D - 1)[..., None])[..., 0]
    denom = c0 - 2 * cbest + c2
    off = torch.where(denom.abs() > 1e-9, 0.5 * (c0 - c2) / denom,
                      torch.zeros_like(denom))
    disp = best.float() + torch.clamp(off, -0.5, 0.5)
    del costs
    # left-right consistency: match from the right image and compare
    best_r = torch.argmin(_shifted_costs(R, L, D, block, right=True), -1)
    xx = torch.arange(W, device=L.device)[None, :]
    dr = best_r.gather(1, (xx - best).clamp(0, W - 1))
    lr_ok = (best - dr).abs() <= lr_thresh
    valid = unique & lr_ok & (xx >= max_disp) & (best > 0) & (best < D - 1)
    return torch.where(valid, disp, torch.zeros_like(disp)), valid


def depth_from_disparity(disp: torch.Tensor, fx: float, baseline: float,
                         valid: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Z = fx * b / d (0 where invalid)."""
    z = fx * baseline / torch.clamp(disp, min=1e-6)
    if valid is not None:
        z = torch.where(valid & (disp > 0), z, torch.zeros_like(z))
    return z


def sample_disparity(disp: torch.Tensor, valid: torch.Tensor,
                     kpts: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Disparity and validity at the keypoints' nearest pixels."""
    H, W = disp.shape
    x = torch.round(kpts[:, 0]).long().clamp(0, W - 1)
    y = torch.round(kpts[:, 1]).long().clamp(0, H - 1)
    return disp[y, x], valid[y, x]


def keypoints_to_3d(kpts: torch.Tensor, disp_at_kp: torch.Tensor,
                    K: torch.Tensor, baseline: float) -> torch.Tensor:
    """Keypoints with disparity, back-projected to camera-frame 3-D."""
    fx = K[0, 0]
    fy = K[1, 1]
    z = fx * baseline / torch.clamp(disp_at_kp, min=1e-6)
    x = (kpts[:, 0] - K[0, 2]) / fx * z
    y = (kpts[:, 1] - K[1, 2]) / fy * z
    return torch.stack([x, y, z], -1)
