"""Key-masked attention for the LightGlue matcher: the hand-written CUDA
kernel, its plain PyTorch version, and the dispatch between them.

Replaces ``simpleslam_tpu/ops/pallas/attention.py``: the TPU kernel
``_attn_kernel`` (via ``pallas_masked_attention``) becomes
``csrc/masked_attention.cu``, and ``xla_masked_attention`` becomes
:func:`plain_masked_attention`. Semantics, for q (BH, Nq, d), k/v
(BH, Nk, d), mask (BH, Nk) bool:

    out = softmax(q k^T / sqrt(d) + (1 - m) (-1e9)) v        (float32)

The kernel, like the TPU kernel, ADDS the mask term and clamps the softmax
denominator at 1e-30; the plain version, like ``xla_masked_attention``,
REPLACES masked logits by -1e9. The two agree wherever a row has a live
key; on a fully masked row both are finite averages of v.

Bound on an H100 SXM at the main path's shape (BH = 4, N = 2048, d = 64):
4 N^2 d BH = 4.3 GFLOP against ~8 MB of I/O, so operations bound it —
~4.3 us at the bf16 tensor-core peak, ~64 us at the float32 CUDA-core peak
that this first kernel uses (see the source's header for the design).

:func:`masked_attention` sends CUDA tensors to the kernel and CPU tensors to
the plain version; there is no fallback from one to the other.
``cuda_masked_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from simpleslam_tpu_torch.utils import cuda_build

SOURCE = "masked_attention.cu"
_NEG = -1e9


def plain_masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask_k: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version (counterpart of ``xla_masked_attention``)."""
    d = q.shape[-1]
    logits = torch.einsum("bnd,bmd->bnm", q.float(), k.float()) / math.sqrt(d)
    logits = torch.where(mask_k[:, None, :], logits,
                         torch.full_like(logits, _NEG))
    return torch.einsum("bnm,bmd->bnd", torch.softmax(logits, -1), v.float())


def _bind(lib: ctypes.CDLL):
    fn = lib.masked_attention_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def cuda_masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask_k: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; returns float32
    (BH, Nq, 64). Raises on anything the kernel does not take."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda and mask_k.is_cuda):
        raise ValueError("cuda_masked_attention needs CUDA tensors")
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    BH, Nq, d = q.shape
    Nk = k.shape[1]
    if d != 64 or k.shape[0] != BH or k.shape[2] != d:
        raise ValueError(f"the kernel takes head dim 64 and matching BH; got "
                         f"q {tuple(q.shape)} k {tuple(k.shape)}")
    if tuple(mask_k.shape) != (BH, Nk) or mask_k.dtype != torch.bool:
        raise ValueError(f"mask must be bool {(BH, Nk)}, got "
                         f"{mask_k.dtype} {tuple(mask_k.shape)}")
    fn = _bind(cuda_build.load(SOURCE))
    qf, kf, vf = (t.float().contiguous() for t in (q, k, v))
    m = mask_k.contiguous()
    out = torch.empty((BH, Nq, d), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), m.data_ptr(),
             out.data_ptr(), BH, Nq, Nk, 1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"masked_attention kernel launch failed: CUDA "
                           f"error {err}")
    cuda_masked_attention.launches += 1
    return out


cuda_masked_attention.launches = 0


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask_k: torch.Tensor) -> torch.Tensor:
    """Dispatch: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if q.is_cuda:
        return cuda_masked_attention(q, k, v, mask_k)
    return plain_masked_attention(q, k, v, mask_k)
