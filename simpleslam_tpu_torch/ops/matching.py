"""Brute-force descriptor matching as dense products (the counterpart of
``simpleslam_tpu/ops/matching.py``).

* binary descriptors: Hamming distance without popcount loops, the bits
  unpacked once to {0, 1} floats and ``ham(a, b) = |a| + |b| - 2 a.b`` as
  one product (bit sums <= 256 are exact in float32; TF32 is off,
  ``utils/precision.py``);
* float descriptors: L2 by the same Gram-matrix trick;
* cross-check (mutual nearest neighbours), results sorted by ascending
  distance (stable) into a padded :class:`Matches`.
"""
from __future__ import annotations

import torch

from simpleslam_tpu_torch.core.types import Features, Matches
from simpleslam_tpu_torch.utils.precision import highest_precision

_INF = 3.0e38


def unpack_bits(desc_u8: torch.Tensor, msb_first: bool = False
                ) -> torch.Tensor:
    """(N, B) uint8 -> (N, 8B) float32 in {0, 1}, LSB-first per byte (the
    matcher's order) or MSB-first (``np.unpackbits``, the place vector's)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=desc_u8.device)
    if msb_first:
        shifts = 7 - shifts
    bits = (desc_u8[..., :, None] >> shifts) & 1
    return bits.reshape(desc_u8.shape[0], -1).float()


@highest_precision()
def hamming_matrix(bits0: torch.Tensor, bits1: torch.Tensor) -> torch.Tensor:
    """Pairwise Hamming distances from {0,1} bit matrices via one product."""
    return (bits0.sum(1)[:, None] + bits1.sum(1)[None, :]
            - 2.0 * bits0 @ bits1.T)


@highest_precision()
def l2sq_matrix(d0: torch.Tensor, d1: torch.Tensor) -> torch.Tensor:
    """Pairwise squared-L2 distances via the Gram trick."""
    n0 = (d0 * d0).sum(1)
    n1 = (d1 * d1).sum(1)
    return torch.clamp(n0[:, None] + n1[None, :] - 2.0 * d0 @ d1.T, min=0.0)


def distance_matrix(desc0: torch.Tensor, desc1: torch.Tensor,
                    valid0: torch.Tensor, valid1: torch.Tensor
                    ) -> torch.Tensor:
    """(N0, N1) distances: Hamming for uint8 descriptors, L2 for float;
    +inf (3e38) where either row is invalid."""
    if desc0.dtype == torch.uint8:
        dist = hamming_matrix(unpack_bits(desc0), unpack_bits(desc1))
    else:
        dist = torch.sqrt(l2sq_matrix(desc0.float(), desc1.float()))
    return torch.where(valid0[:, None] & valid1[None, :], dist,
                       torch.full_like(dist, _INF))


def bf_match(feats0: Features, feats1: Features, *, cross_check: bool = True,
             sort: bool = True) -> Matches:
    """``BFMatcher.match`` over padded feature sets: row i holds query
    keypoint i's best partner (mutual-NN filtered with ``cross_check``),
    sorted by ascending distance with ``sort`` (ties keep row order)."""
    dist = distance_matrix(feats0.desc, feats1.desc, feats0.valid,
                           feats1.valid)
    nn1 = torch.argmin(dist, dim=1)                  # first index on ties
    d_best = dist.gather(1, nn1[:, None])[:, 0]
    ok = d_best < _INF
    idx0 = torch.arange(dist.shape[0], device=dist.device)
    if cross_check:
        nn0 = torch.argmin(dist, dim=0)
        ok = ok & (nn0[nn1] == idx0)
    score = torch.where(ok, d_best, torch.full_like(d_best, _INF))
    idx1 = nn1
    if sort:
        order = torch.argsort(score, stable=True)
        idx0, idx1, score, ok = idx0[order], idx1[order], score[order], \
            ok[order]
    return Matches(idx0=idx0, idx1=idx1,
                   score=torch.where(ok, score, torch.zeros_like(score)),
                   valid=ok)


def knn_distances(feats0: Features, feats1: Features, k: int = 2):
    """The k smallest distances and their indices per query (ties to the
    lower index), for ratio tests."""
    dist = distance_matrix(feats0.desc, feats1.desc, feats0.valid,
                           feats1.valid)
    d, idx = torch.sort(dist, dim=1, stable=True)
    return d[:, :k], idx[:, :k]
