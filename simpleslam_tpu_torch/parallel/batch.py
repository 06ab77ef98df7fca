"""Sharded batched extraction and matching over a device mesh (the
counterpart of ``simpleslam_tpu/parallel/batch.py``).

The offline throughput mode: a batch of frames or frame pairs is split
over the mesh's 'dp' axis. Each dp rank takes its contiguous slice, runs
the batched ALIKED extraction and LightGlue matching on it, and the slices
are all-gathered over the dp group, so every rank returns the whole batch
(what ``jax.device_get`` hands the reference's caller). The tp ranks of one
dp row compute the same slice. The models carry their weights, so the
reference's separate parameter arguments are gone.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.distributed as dist

from simpleslam_tpu_torch.core.types import Features, Matches
from simpleslam_tpu_torch.models import aliked as aliked_mod
from simpleslam_tpu_torch.models import lightglue as lg_mod
from simpleslam_tpu_torch.parallel.mesh import dp_slice


def _gather_dp(mesh, record):
    """All-gather a record's batch slices over the dp group, in dp order
    (bool fields travel as uint8)."""
    group = mesh.get_group("dp")
    n = dist.get_world_size(group)

    def gather(t):
        x = t.to(torch.uint8) if t.dtype == torch.bool else t
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts).to(t.dtype)

    return record.map(gather)


def sharded_extract(a_model, images: torch.Tensor, mesh, *,
                    max_kp: int) -> Features:
    """Batched ALIKED extraction, the batch split over 'dp'.

    images: (B, H, W, 1) float32 in [0, 1] on the rank's device; B
    divisible by dp. Returns Features with a leading batch axis (all B)."""
    s = dp_slice(mesh, images.shape[0])
    return _gather_dp(mesh, aliked_mod.extract_batch(a_model, images[s],
                                                     max_kp))


def sharded_extract_classical(det_fn: Callable, grays: torch.Tensor,
                              mesh) -> Features:
    """Batched classical extraction (an ORB, SIFT or AKAZE detector function
    of one (H, W) image, run per image of the slice), the batch split over
    'dp'. grays: (B, H, W) on the rank's device; B divisible by dp."""
    s = dp_slice(mesh, grays.shape[0])
    local = Features.stack([det_fn(g) for g in grays[s].float()])
    return _gather_dp(mesh, local)


def sharded_match(l_model, f0: Features, f1: Features, mesh, *,
                  image_hw: Tuple[int, int], min_conf: float = 0.7
                  ) -> Matches:
    """Batched LightGlue matching of already-extracted feature batches, the
    batch split over 'dp'."""
    s = dp_slice(mesh, f0.kpts.shape[0])
    m = lg_mod.match_batch(l_model, f0.map(lambda t: t[s]),
                           f1.map(lambda t: t[s]), image_hw, min_conf)
    return _gather_dp(mesh, m)


def sharded_extract_and_match(a_model, l_model, images0: torch.Tensor,
                              images1: torch.Tensor, mesh, *, max_kp: int,
                              image_hw: Tuple[int, int],
                              min_conf: float = 0.7
                              ) -> Tuple[Features, Features, Matches]:
    """(B, H, W, 1) image pair batches -> (Features, Features, Matches),
    the batch split over the mesh's 'dp' axis; B divisible by dp."""
    s = dp_slice(mesh, images0.shape[0])
    f0 = aliked_mod.extract_batch(a_model, images0[s], max_kp)
    f1 = aliked_mod.extract_batch(a_model, images1[s], max_kp)
    m = lg_mod.match_batch(l_model, f0, f1, image_hw, min_conf)
    return _gather_dp(mesh, f0), _gather_dp(mesh, f1), _gather_dp(mesh, m)
