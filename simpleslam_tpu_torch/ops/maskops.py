"""Masked statistics over padded tensors (static-shape replacements for
reductions over ragged inlier sets)."""
from __future__ import annotations

import torch


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of x[mask] without dynamic shapes (0.0 when mask is empty)."""
    n = mask.sum()
    s = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf")))
                   ).values
    k = torch.clamp(n, min=1)
    lo = s[torch.clamp((k - 1) // 2, min=0)]
    hi = s[torch.clamp(k // 2, min=0)]
    return torch.where(n > 0, 0.5 * (lo + hi), torch.zeros_like(lo))


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    n = torch.clamp(mask.to(x.dtype).sum(), min=1.0)
    return torch.where(mask, x, torch.zeros_like(x)).sum() / n


def masked_fraction(cond: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Fraction of masked entries satisfying cond (0.0 when mask empty)."""
    n = mask.float().sum()
    c = (cond & mask).float().sum()
    return torch.where(n > 0, c / torch.clamp(n, min=1.0),
                       torch.zeros_like(n))
