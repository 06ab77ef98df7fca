"""ALIKED-style keypoint detector + descriptor network as ``nn.Module``s
(the counterpart of ``simpleslam_tpu/models/aliked.py``).

Module names mirror the flax tree (``block1.Conv_0``, ``block1.GroupNorm_0``,
``desc_head``, ``score_conv1``, ...). The network runs NCHW inside; its
public functions keep the reference's layout: images (B, H, W, 1) in,
``desc_map`` (B, H/2, W/2, D) out, so the tests compare like with like.

Numerics follow the reference: convolutions in bfloat16 (inputs, kernels and
bias cast; bias added after the convolution), GroupNorm statistics in
float32 with flax's epsilon 1e-6, GELU in its tanh form (flax's default),
bilinear upsampling with half-pixel centres (``align_corners=False``).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from simpleslam_tpu_torch.core.types import Features

_GN_EPS = 1e-6


class Conv(nn.Conv2d):
    """``flax.linen.Conv`` with SAME padding, computed in ``dtype``."""

    def __init__(self, cin: int, cout: int, ksize: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(cin, cout, ksize, padding=ksize // 2)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), None,
                     padding=self.padding)
        return y + self.bias.to(self.dtype)[None, :, None, None]


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class ConvBlock(nn.Module):
    def __init__(self, cin: int, ch: int, dtype=torch.bfloat16):
        super().__init__()
        self.Conv_0 = Conv(cin, ch, 3, dtype)
        self.Conv_1 = Conv(ch, ch, 3, dtype)
        self.GroupNorm_0 = nn.GroupNorm(8, ch, eps=_GN_EPS)
        self.dtype = dtype

    def forward(self, x):
        x = self.Conv_1(_gelu(self.Conv_0(x)))
        return _gelu(self.GroupNorm_0(x.float()).to(self.dtype))


def space_to_depth(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """NCHW (B, C, H, W) -> (B, C*r*r, H/r, W/r) with the reference's
    channel order (dy, dx, c) — not ``F.pixel_unshuffle``'s (c, dy, dx)."""
    B, C, H, W = x.shape
    x = x.reshape(B, C, H // r, r, W // r, r)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(B, C * r * r, H // r, W // r)


class ALIKED(nn.Module):
    """Backbone + score head + descriptor head. Input (B, H, W, 1) float32
    grey in [0, 1], H and W multiples of 8. Returns (score (B, H, W),
    desc_map (B, H/2, W/2, D)), both float32."""

    def __init__(self, desc_dim: int = 128,
                 channels: Tuple[int, ...] = (32, 64, 128, 128),
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        cin = 4
        for i, ch in enumerate(channels):
            setattr(self, f"block{i + 1}", ConvBlock(cin, ch, dtype))
            cin = ch
        self.n_blocks = len(channels)
        fused = sum(channels)
        self.desc_head = Conv(fused, desc_dim, 1, dtype)
        self.score_conv1 = Conv(fused, 32, 3, dtype)
        self.score_conv2 = Conv(32, 1, 3, dtype)

    def forward(self, img: torch.Tensor):
        B, H, W, _ = img.shape
        x = space_to_depth(img.permute(0, 3, 1, 2).to(self.dtype), 2)
        feats = []
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i + 1}")(x)
            feats.append(x)
            if i + 1 < self.n_blocks:
                x = F.avg_pool2d(x, 2)
        h2, w2 = H // 2, W // 2
        fused = torch.cat([feats[0].float()] + [
            F.interpolate(f.float(), size=(h2, w2), mode="bilinear",
                          align_corners=False) for f in feats[1:]], 1)
        fused = fused.to(self.dtype)
        desc_map = self.desc_head(fused).float()
        s = self.score_conv2(_gelu(self.score_conv1(fused)))
        score = F.interpolate(s.float(), size=(H, W), mode="bilinear",
                              align_corners=False)[:, 0]
        return score, desc_map.permute(0, 2, 3, 1)


# --------------------------------------------------------------------------- #
# DKD: NMS + top-K + soft-argmax subpixel + descriptor sampling
# --------------------------------------------------------------------------- #

def _nms_mask(score: torch.Tensor, radius: int = 2) -> torch.Tensor:
    """(B, H, W) bool: local maxima within a (2r+1)^2 window."""
    mx = F.max_pool2d(score[:, None], 2 * radius + 1, stride=1,
                      padding=radius)[:, 0]
    return score >= mx


def _flat_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """The reference's gather index rule: negatives wrap, overflow clamps."""
    return torch.clamp(torch.where(idx < 0, idx + n, idx), 0, n - 1)


def _soft_argmax_refine(score: torch.Tensor, xs: torch.Tensor,
                        ys: torch.Tensor, temp: float = 0.1):
    """3x3 soft-argmax subpixel offsets around integer keypoints of one
    image -> (dx, dy)."""
    H, W = score.shape
    d = torch.arange(-1, 2, device=score.device)
    dy = d[:, None].expand(3, 3).reshape(-1)
    dx = d[None, :].expand(3, 3).reshape(-1)
    idx = (ys * W + xs)[:, None] + (dy * W + dx)[None, :]
    patch = score.reshape(-1)[_flat_index(idx, H * W)]
    w = torch.softmax(patch / temp, 1)
    return (w * dx.float()[None]).sum(1), (w * dy.float()[None]).sum(1)


def _bilinear_sample(fmap: torch.Tensor, x: torch.Tensor, y: torch.Tensor
                     ) -> torch.Tensor:
    """Sample (Hf, Wf, C) at float coords (N,) -> (N, C)."""
    Hf, Wf, C = fmap.shape
    x = torch.clamp(x, 0.0, Wf - 1.001)
    y = torch.clamp(y, 0.0, Hf - 1.001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    base = y0 * Wf + x0
    idx = torch.stack([base, base + 1, base + Wf, base + Wf + 1], 1)
    v = fmap.reshape(-1, C)[_flat_index(idx, Hf * Wf)]
    return (v[:, 0] * ((1 - fx) * (1 - fy)) + v[:, 1] * (fx * (1 - fy))
            + v[:, 2] * ((1 - fx) * fy) + v[:, 3] * (fx * fy))


def dkd_extract(score: torch.Tensor, desc_map: torch.Tensor, max_kp: int,
                nms_radius: int = 2, border: int = 8,
                score_floor: float = -1e5) -> Features:
    """Deterministic top-K keypoints of ONE image. score (H, W), desc_map
    (H/2, W/2, D) -> padded Features, L2-normalised descriptors."""
    H, W = score.shape
    nms = _nms_mask(score[None], nms_radius)[0]
    yy = torch.arange(H, device=score.device)[:, None]
    xx = torch.arange(W, device=score.device)[None, :]
    inb = (xx >= border) & (xx < W - border) & (yy >= border) \
        & (yy < H - border)
    gated = torch.where(nms & inb & (score > score_floor), score,
                        torch.full_like(score, -float("inf")))
    top_v, top_i = torch.topk(gated.reshape(-1), max_kp)
    valid = torch.isfinite(top_v)
    ys, xs = top_i // W, top_i % W
    dx, dy = _soft_argmax_refine(score, xs, ys)
    xf = xs.float() + dx
    yf = ys.float() + dy
    desc = _bilinear_sample(desc_map, xf * 0.5, yf * 0.5)
    desc = desc / torch.clamp(torch.linalg.norm(desc, dim=-1, keepdim=True),
                              min=1e-8)
    return Features(kpts=torch.stack([xf, yf], -1),
                    desc=torch.where(valid[:, None], desc,
                                     torch.zeros_like(desc)),
                    scores=torch.where(valid, top_v, torch.zeros_like(top_v)),
                    valid=valid)


def preprocess_image(img: torch.Tensor) -> torch.Tensor:
    """uint8/float BGR or grey (H, W[, 3]) -> (H', W', 1) float32 in [0, 1],
    zero-padded to multiples of 8."""
    if img.dim() == 3:
        img = img.float()
        gray = 0.114 * img[..., 0] + 0.587 * img[..., 1] + 0.299 * img[..., 2]
    else:
        gray = img.float()
    H, W = gray.shape
    gray = F.pad(gray, (0, (-W) % 8, 0, (-H) % 8))
    return (gray / 255.0)[..., None]
