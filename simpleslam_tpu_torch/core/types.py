"""Padded, static-shaped containers shared across the pipeline, as
dataclasses of tensors (the counterpart of ``simpleslam_tpu/core/types.py``).

* keypoints  -> (N, 2) float32 + ``valid`` mask
* descriptors-> (N, D) float32 (L2-normalised)
* matches    -> index pairs + score + mask
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional, Tuple

import numpy as np
import torch


class _TensorRecord:
    def numpy(self) -> dict:
        """Host copies of every field, by name."""
        return {f.name: getattr(self, f.name).detach().cpu().numpy()
                for f in fields(self)}


@dataclass
class Features(_TensorRecord):
    """Padded per-frame feature set.

    kpts:   (N, 2) float32 pixel coords (x, y).
    desc:   (N, D) float32 L2-normalised descriptors.
    scores: (N,) float32 detector scores.
    valid:  (N,) bool mask of live rows.
    """
    kpts: torch.Tensor
    desc: torch.Tensor
    scores: torch.Tensor
    valid: torch.Tensor

    @property
    def n(self) -> torch.Tensor:
        return self.valid.sum()

    @property
    def capacity(self) -> int:
        return self.kpts.shape[0]

    @classmethod
    def empty(cls, n_pad: int, desc_dim: int, device="cpu",
              desc_dtype=torch.float32) -> "Features":
        return cls(kpts=torch.zeros((n_pad, 2), device=device),
                   desc=torch.zeros((n_pad, desc_dim), dtype=desc_dtype,
                                    device=device),
                   scores=torch.zeros((n_pad,), device=device),
                   valid=torch.zeros((n_pad,), dtype=torch.bool,
                                     device=device))

    @classmethod
    def from_arrays(cls, kpts, desc, scores=None, n_pad: Optional[int] = None,
                    device="cpu") -> "Features":
        """Build (and pad) from host arrays."""
        kpts = np.asarray(kpts, np.float32).reshape(-1, 2)
        desc = np.asarray(desc, np.float32)
        n = kpts.shape[0]
        if scores is None:
            scores = np.ones((n,), np.float32)
        cap = n_pad or n
        m = min(n, cap)
        out_k = np.zeros((cap, 2), np.float32)
        out_d = np.zeros((cap, desc.shape[1]), np.float32)
        out_s = np.zeros((cap,), np.float32)
        out_v = np.zeros((cap,), bool)
        out_k[:m], out_d[:m] = kpts[:m], desc[:m]
        out_s[:m] = np.asarray(scores, np.float32)[:m]
        out_v[:m] = True
        return cls(kpts=torch.as_tensor(out_k, device=device),
                   desc=torch.as_tensor(out_d, device=device),
                   scores=torch.as_tensor(out_s, device=device),
                   valid=torch.as_tensor(out_v, device=device))


@dataclass
class Matches(_TensorRecord):
    """Padded match set between two feature sets.

    idx0/idx1: (M,) int64 indices into the query/train feature arrays.
    score:     (M,) float32 (confidence for the learned matcher).
    valid:     (M,) bool.
    """
    idx0: torch.Tensor
    idx1: torch.Tensor
    score: torch.Tensor
    valid: torch.Tensor

    @property
    def n(self) -> torch.Tensor:
        return self.valid.sum()

    @property
    def capacity(self) -> int:
        return self.idx0.shape[0]

    def pairs(self) -> torch.Tensor:
        return torch.stack([self.idx0, self.idx1], dim=-1)

    @classmethod
    def empty(cls, m_pad: int, device="cpu") -> "Matches":
        z = torch.zeros((m_pad,), dtype=torch.int64, device=device)
        return cls(idx0=z, idx1=z.clone(),
                   score=torch.zeros((m_pad,), device=device),
                   valid=torch.zeros((m_pad,), dtype=torch.bool,
                                     device=device))

    @classmethod
    def from_arrays(cls, idx0, idx1, score=None, m_pad: Optional[int] = None,
                    device="cpu") -> "Matches":
        idx0 = np.asarray(idx0, np.int64).reshape(-1)
        idx1 = np.asarray(idx1, np.int64).reshape(-1)
        n = idx0.shape[0]
        if score is None:
            score = np.zeros((n,), np.float32)
        cap = m_pad or n
        m = min(n, cap)
        o0 = np.zeros((cap,), np.int64)
        o1 = np.zeros((cap,), np.int64)
        os_ = np.zeros((cap,), np.float32)
        ov = np.zeros((cap,), bool)
        o0[:m], o1[:m] = idx0[:m], idx1[:m]
        os_[:m], ov[:m] = np.asarray(score, np.float32)[:m], True
        return cls(idx0=torch.as_tensor(o0, device=device),
                   idx1=torch.as_tensor(o1, device=device),
                   score=torch.as_tensor(os_, device=device),
                   valid=torch.as_tensor(ov, device=device))


def gather_matched_points(kpts0: torch.Tensor, kpts1: torch.Tensor,
                          m: Matches) -> Tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
    """(pts0 (M,2), pts1 (M,2), mask) for matched keypoint pairs."""
    return kpts0[m.idx0], kpts1[m.idx1], m.valid
