"""Place recognition (the counterpart of ``simpleslam_tpu/core/loop.py``;
only ``place_vector`` is ported — loop closure and pose-graph optimisation
wait for a later slice). Global relocalisation ranks keyframes by it."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from simpleslam_tpu_torch.ops.matching import unpack_bits


def place_vector(feats, img_hw: Tuple[int, int], grid: int) -> np.ndarray:
    """(G*G*D,) pooled place vector: per-cell mean descriptor over a G x G
    grid, cell- and globally L2-normalised. Binary (uint8) descriptors pool
    as their bits (G*G*8D)."""
    G = grid
    H, W = int(img_hw[0]), int(img_hw[1])
    kpts, desc = feats.kpts, feats.desc
    desc = unpack_bits(desc, msb_first=True) if desc.dtype == torch.uint8 \
        else desc.float()
    cx = torch.clamp((kpts[:, 0] / W * G).long(), 0, G - 1)
    cy = torch.clamp((kpts[:, 1] / H * G).long(), 0, G - 1)
    cell = cy * G + cx
    oh = ((cell[:, None] == torch.arange(G * G, device=kpts.device)[None, :])
          & feats.valid[:, None]).float()
    cv = (oh.T @ desc) / torch.clamp(oh.sum(0), min=1.0)[:, None]
    cv = cv / (torch.linalg.norm(cv, dim=1, keepdim=True) + 1e-8)
    v = cv.reshape(-1)
    return (v / (torch.linalg.norm(v) + 1e-8)).cpu().numpy()
