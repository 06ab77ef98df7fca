"""LightGlue-style attention matcher as ``nn.Module``s (the counterpart of
``simpleslam_tpu/models/lightglue.py``).

Module and parameter names mirror the flax tree name for name (``self0``,
``cross0``, ``attn.q``, ``LayerNorm_0``, ...), so a state_dict converted by
``models/pipeline.py::from_jax_params`` loads with ``strict=True``.

Numerics follow the reference: the attention and MLP projections run in
bfloat16 (``Dense(dtype=bf16)``: inputs and weights cast to bf16, the bias
added after the product), LayerNorm, the input/final projections, the
assignment and the softmaxes in float32. In self-attention rotary turns q
and k into float32; in cross-attention they stay bf16; v is always bf16.
The attention itself goes through ``ops/attention.py::masked_attention``
(the CUDA kernel on the GPU).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from simpleslam_tpu_torch.core.types import Matches
from simpleslam_tpu_torch.models.seeding import seeded_init_
from simpleslam_tpu_torch.ops.attention import masked_attention
from simpleslam_tpu_torch.utils.profiling import span

_NEG = -1e9
_LN_EPS = 1e-6   # flax LayerNorm's epsilon (torch's default is 1e-5)


class Dense(nn.Linear):
    """``flax.linen.Dense``: y = x @ W^T + b, computed in ``dtype`` when
    one is given (inputs, weight and bias cast first; product and bias add
    rounded separately, as XLA does)."""

    def __init__(self, din: int, dout: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(din, dout, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        y = x.to(dt) @ self.weight.to(dt).T
        return y + self.bias.to(dt) if self.bias is not None else y


def _rotate_half_pairs(x: torch.Tensor) -> torch.Tensor:
    """Rotate each (even, odd) pair by 90 degrees: (-x1, x0, ...)."""
    return torch.stack([-x[..., 1::2], x[..., 0::2]], -1).reshape(x.shape)


def apply_rotary(x: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """2-D position rotary encoding. x (..., N, d), theta (..., N, d/2);
    the result is float32 (bf16 x promoted by the float32 angles)."""
    cos = torch.repeat_interleave(torch.cos(theta), 2, dim=-1)
    sin = torch.repeat_interleave(torch.sin(theta), 2, dim=-1)
    x = x.to(torch.promote_types(x.dtype, theta.dtype))
    return x * cos + _rotate_half_pairs(x) * sin


class Attention(nn.Module):
    """Multi-head attention with optional rotary encoding and masked keys."""

    def __init__(self, dim: int, heads: int, dtype=torch.bfloat16):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.q = Dense(dim, dim, dtype=dtype)
        self.k = Dense(dim, dim, dtype=dtype)
        self.v = Dense(dim, dim, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)
        self.dtype = dtype

    def forward(self, xq, xk, mask_k, theta_q=None, theta_k=None):
        B, Nq, _ = xq.shape
        Nk = xk.shape[1]
        hd = self.dim // self.heads

        def split(t, n):
            return t.reshape(B, n, self.heads, hd).transpose(1, 2)

        q, k, v = split(self.q(xq), Nq), split(self.k(xk), Nk), \
            split(self.v(xk), Nk)
        if theta_q is not None:
            q = apply_rotary(q, theta_q[:, None, :, : hd // 2])
            k = apply_rotary(k, theta_k[:, None, :, : hd // 2])
        mk = mask_k[:, None, :].expand(B, self.heads, Nk) \
            .reshape(B * self.heads, Nk)
        out = masked_attention(q.reshape(B * self.heads, Nq, hd),
                               k.reshape(B * self.heads, Nk, hd),
                               v.reshape(B * self.heads, Nk, hd), mk)
        out = out.reshape(B, self.heads, Nq, hd).transpose(1, 2) \
            .reshape(B, Nq, self.dim)
        return self.proj(out.to(self.dtype))


class TransformerUnit(nn.Module):
    """Attention + gated MLP with residuals (one LightGlue half-layer)."""

    def __init__(self, dim: int, heads: int, dtype=torch.bfloat16):
        super().__init__()
        self.attn = Attention(dim, heads, dtype)
        self.LayerNorm_0 = nn.LayerNorm(2 * dim, eps=_LN_EPS)
        self.ff1 = Dense(2 * dim, 2 * dim, dtype=dtype)
        self.ff2 = Dense(2 * dim, dim, dtype=dtype)

    def forward(self, x, src, mask_src, theta_x=None, theta_src=None):
        msg = self.attn(x, src, mask_src, theta_x, theta_src)
        y = self.LayerNorm_0(torch.cat([x, msg.float()], -1))
        h = F.gelu(self.ff1(y), approximate="tanh")
        return x + self.ff2(h).float()


class LightGlue(nn.Module):
    """Attention matcher over two padded keypoint sets; weights shared
    between the two images."""

    def __init__(self, desc_dim: int = 128, dim: int = 256, heads: int = 4,
                 n_layers: int = 9, dtype=torch.bfloat16):
        super().__init__()
        self.dim, self.heads, self.n_layers = dim, heads, n_layers
        self.input_proj = Dense(desc_dim, dim)
        self.rotary_freq = Dense(2, dim // heads // 2, bias=False)
        for i in range(n_layers):
            setattr(self, f"self{i}", TransformerUnit(dim, heads, dtype))
            setattr(self, f"cross{i}", TransformerUnit(dim, heads, dtype))
        self.final_proj = Dense(dim, dim)
        self.matchability = Dense(dim, 1)

    def forward(self, kpts0, desc0, valid0, kpts1, desc1, valid1,
                image_hw: Tuple[int, int]):
        """kpts (B, N, 2) pixels, desc (B, N, D), valid (B, N) bool ->
        (P (B, N, M) assignment probabilities, sig0, sig1)."""
        with span("lightglue.forward"):
            H, W = image_hw
            scale = float(max(H, W))

            def centred(k):       # Python numbers: no copy to the device
                return torch.stack([k[..., 0] - W / 2.0,
                                    k[..., 1] - H / 2.0], -1)

            th0 = self.rotary_freq(centred(kpts0) / scale) * 10.0
            th1 = self.rotary_freq(centred(kpts1) / scale) * 10.0
            x0 = self.input_proj(desc0.float())
            x1 = self.input_proj(desc1.float())
            for i in range(self.n_layers):
                su = getattr(self, f"self{i}")
                cu = getattr(self, f"cross{i}")
                x0 = su(x0, x0, valid0, th0, th0)
                x1 = su(x1, x1, valid1, th1, th1)
                x0n = cu(x0, x1, valid1)
                x1 = cu(x1, x0, valid0)
                x0 = x0n
            m0, m1 = self.final_proj(x0), self.final_proj(x1)
            S = torch.einsum("bnd,bmd->bnm", m0, m1) / (self.dim ** 0.5)
            sig0 = torch.sigmoid(self.matchability(x0)[..., 0])
            sig1 = torch.sigmoid(self.matchability(x1)[..., 0])
            pair = valid0[:, :, None] & valid1[:, None, :]
            S = torch.where(pair, S, torch.full_like(S, _NEG))
            P = (torch.softmax(S, -1) * torch.softmax(S, -2)
                 * sig0[:, :, None] * sig1[:, None, :])
            return torch.where(pair, P, torch.zeros_like(P)), sig0, sig1


def matches_from_assignment(P: torch.Tensor, min_conf: float) -> Matches:
    """Mutual-argmax matches of one (N, M) assignment, gated at
    ``conf > min_conf`` and sorted by descending confidence. The order is
    part of the contract (downstream indexes idx0/idx1 positionally), so
    the sort is stable, like the reference's."""
    nn1 = torch.argmax(P, 1)
    nn0 = torch.argmax(P, 0)
    conf = P.gather(1, nn1[:, None])[:, 0]
    rows = torch.arange(P.shape[0], device=P.device)
    ok = (nn0[nn1] == rows) & (conf > min_conf)
    order = torch.argsort(torch.where(ok, -conf, torch.full_like(conf,
                                                                 float("inf"))),
                          stable=True)
    return Matches(idx0=rows[order], idx1=nn1[order],
                   score=torch.where(ok, conf, torch.zeros_like(conf))[order],
                   valid=ok[order])


@torch.no_grad()
def match_pair(model: LightGlue, feats0, feats1, image_hw: Tuple[int, int],
               min_conf: float = 0.7) -> Matches:
    """Single-pair matching (batch of 1) -> padded Matches."""
    P, _, _ = model(feats0.kpts[None], feats0.desc[None], feats0.valid[None],
                    feats1.kpts[None], feats1.desc[None], feats1.valid[None],
                    image_hw)
    return matches_from_assignment(P[0], min_conf)


@torch.no_grad()
def match_batch(model: LightGlue, feats0, feats1, image_hw: Tuple[int, int],
                min_conf: float = 0.7) -> Matches:
    """Batched pair matching: Features with a leading batch axis -> Matches
    with a leading batch axis. One forward over the B pairs (each attention
    call at BH = B x heads), then :func:`matches_from_assignment` per
    pair."""
    P, _, _ = model(feats0.kpts, feats0.desc, feats0.valid,
                    feats1.kpts, feats1.desc, feats1.valid, image_hw)
    with span("lightglue.assign"):
        return Matches.stack([matches_from_assignment(p, min_conf)
                              for p in P])


def init_lightglue(generator: torch.Generator, desc_dim: int = 128,
                   dim: int = 256, heads: int = 4, n_layers: int = 9,
                   dtype: torch.dtype = torch.bfloat16) -> LightGlue:
    """A LightGlue of the given width with seeded weights (the counterpart
    of the JAX package's ``init_lightglue``)."""
    return seeded_init_(LightGlue(desc_dim=desc_dim, dim=dim, heads=heads,
                                  n_layers=n_layers, dtype=dtype), generator)
