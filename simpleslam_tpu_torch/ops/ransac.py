"""Batched-hypothesis RANSAC core (the counterpart of
``simpleslam_tpu/ops/ransac.py``).

All ``n_hyp`` minimal sets are drawn at once, fitted as one batch, scored as
one (S, M) residual tensor, and the best hypothesis is picked by argmax — no
sequential early-exit loop. Randomness comes from a key object
(``utils/rng.py``); with a key backed by ``jax.random`` the port draws
exactly the reference's minimal sets.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch


def sample_minimal_sets(key, valid: torch.Tensor, k: int, n_hyp: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw ``n_hyp`` index sets of size ``k`` from the valid entries.

    Rank sampling: uniform ranks in [0, n_valid) mapped to entry positions
    through the valid mask's prefix sum (searchsorted). Ranks inside a set
    are independent, so a set can rarely repeat a point; that hypothesis
    then fits a degenerate model and simply scores badly.

    Returns (idx (S, k) int64, ok (S,) bool); ``ok`` is False when fewer
    than k valid entries exist.
    """
    n_valid = valid.sum()
    ranks = key.randint((n_hyp, k), n_valid, valid.device)
    cums = torch.cumsum(valid.to(torch.int64), 0)
    idx = torch.searchsorted(cums, (ranks.reshape(-1) + 1).contiguous())
    # no valid entry maps every rank past the end; the reference's gather
    # clamps such an index, and so does this
    idx = torch.clamp(idx, max=valid.shape[0] - 1).reshape(n_hyp, k)
    ok = (n_valid >= k).expand(n_hyp)
    return idx, ok


def score_count(res_sq: torch.Tensor, valid: torch.Tensor, thresh_sq
                ) -> torch.Tensor:
    """Inlier count per hypothesis. res_sq: (S, M)."""
    return ((res_sq < thresh_sq) & valid[None, :]).float().sum(1)


def score_msac(res_sq: torch.Tensor, valid: torch.Tensor, thresh_sq
               ) -> torch.Tensor:
    """MSAC: sum of (thresh^2 - res^2) over inliers."""
    gain = torch.clamp(thresh_sq - res_sq, min=0.0)
    return torch.where(valid[None, :], gain, torch.zeros_like(gain)).sum(1)


def score_chi2_truncated(res_sq: torch.Tensor, valid: torch.Tensor,
                         chi2_thresh) -> torch.Tensor:
    """ORB-SLAM truncated score: sum(max(0, chi2 - d^2)) over valid."""
    return score_msac(res_sq, valid, chi2_thresh)


def ransac(key, pts0: torch.Tensor, pts1: torch.Tensor, valid: torch.Tensor,
           *, fit_fn: Callable, residual_fn: Callable, k: int, n_hyp: int,
           thresh_sq: float, score: str = "count"):
    """Generic batched two-view RANSAC.

    fit_fn: batched minimal solver (S,k,2),(S,k,2) -> (S, ...) models.
    residual_fn: (models (S, ...), pts0 (M,2), pts1 (M,2)) -> (S, M)
      SQUARED residuals.
    Returns (model, inliers (M,) bool, best_score, ok) — ``ok`` a 0-d bool
    tensor.
    """
    idx, ok_h = sample_minimal_sets(key, valid, k, n_hyp)
    models = fit_fn(pts0[idx], pts1[idx])
    res_sq = residual_fn(models, pts0, pts1)
    res_sq = torch.where(torch.isfinite(res_sq), res_sq,
                         torch.full_like(res_sq, float("inf")))
    if score == "count":
        scores = score_count(res_sq, valid, thresh_sq)
    elif score == "msac":
        scores = score_msac(res_sq, valid, thresh_sq)
    else:
        raise ValueError(score)
    scores = torch.where(ok_h, scores, torch.full_like(scores, -float("inf")))
    best = torch.argmax(scores)
    inliers = (res_sq[best] < thresh_sq) & valid
    return models[best], inliers, scores[best], ok_h[0] & (scores[best] > 0)
