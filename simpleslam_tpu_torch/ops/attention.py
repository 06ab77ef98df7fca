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

The kernel takes q, k and v as the matcher makes them -- float32 q and k
with a bf16 v (self-attention), all bf16 (cross-attention), or all float32
(tests) -- in any row and head strides with a contiguous head dim, and
takes float32-accurate products on the tensor cores by operand splitting
(3 TF32 passes for float32 q k^T, 2 bf16 passes for P v; the source's
header gives the scheme, its emulated error and its bound). A call is one
device kernel: nothing is upcast or copied first.

:func:`masked_attention` sends CUDA tensors to the kernel and CPU tensors to
the plain version; there is no fallback from one to the other.
``cuda_masked_attention.launches`` counts kernel launches.

Gradients. ``_pallas_attention_diff`` (the reference's ``custom_vjp``)
becomes :class:`MaskedAttentionFn`: its forward is the kernel, its backward
recomputes :func:`plain_masked_attention` and takes that expression's
vector-Jacobian product, which gives dq, dk and dv in the inputs' dtypes
and nothing for the mask. That is what ``_pad_bwd`` does: the JAX package
has no backward Pallas kernel, its backward is XLA's autodiff of
``xla_masked_attention``, so the recomputed plain expression is the
faithful port, not a stand-in for a kernel. :func:`masked_attention` takes
the Function only for CUDA tensors when gradients are enabled and an input
requires one (training); every other CUDA call goes straight to the kernel.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from simpleslam_tpu_torch.utils import cuda_build

SOURCE = "masked_attention.cu"
_NEG = -1e9


def plain_masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask_k: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version (counterpart of ``xla_masked_attention``):
    float32, or float64 where an input is float64 (the gradient checks)."""
    d = q.shape[-1]
    ct = torch.promote_types(torch.promote_types(q.dtype, v.dtype),
                             torch.float32)
    logits = torch.einsum("bnd,bmd->bnm", q.to(ct), k.to(ct)) / math.sqrt(d)
    logits = torch.where(mask_k[:, None, :], logits,
                         torch.full_like(logits, _NEG))
    return torch.einsum("bnm,bmd->bnd", torch.softmax(logits, -1), v.to(ct))


# (q/k dtype, v dtype) -> (qk_bf16, v_bf16): the kernel's compiled variants
_VARIANTS = {(torch.float32, torch.bfloat16): (0, 1),
             (torch.bfloat16, torch.bfloat16): (1, 1),
             (torch.float32, torch.float32): (0, 0)}


@functools.lru_cache(maxsize=None)
def _bind():
    """(launch, {variant: the most keys it holds}) of the kernel's library,
    built, typed and queried once, at first use."""
    lib = cuda_build.load(SOURCE)
    fn = lib.masked_attention
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong] * 7 + [ctypes.c_int] * 2 + [ctypes.c_float,
                                                        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    max_keys = lib.masked_attention_max_keys
    max_keys.argtypes = [ctypes.c_int] * 2
    max_keys.restype = ctypes.c_int
    return fn, {v: max_keys(*v) for v in _VARIANTS.values()}


def _strides(t: torch.Tensor, name: str):
    """(head stride, row stride) in elements of a (BH, N, 64) operand; a
    dim of size 1 has no stride. Raises unless the head dim is contiguous
    and both strides and the base are 16-byte aligned."""
    sh, sr, sd = t.stride()
    sh = sh if t.shape[0] > 1 else 0
    sr = sr if t.shape[1] > 1 else 0
    size = t.element_size()
    if sd != 1 or (sh * size) % 16 or (sr * size) % 16 \
            or t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel takes a contiguous head dim "
                         f"and 16-byte aligned rows and heads; got strides "
                         f"{tuple(t.stride())} ({t.dtype})")
    return sh, sr


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
    variant = _VARIANTS.get((q.dtype, v.dtype)) if k.dtype == q.dtype \
        else None
    if variant is None:
        raise ValueError(f"the kernel takes (q, k, v) dtypes (f32, f32, "
                         f"bf16), (bf16, bf16, bf16) or (f32, f32, f32); got "
                         f"({q.dtype}, {k.dtype}, {v.dtype})")
    if Nk > 1 and mask_k.stride(1) != 1:
        raise ValueError(f"mask: the key dim must be contiguous; got strides "
                         f"{tuple(mask_k.stride())}")
    q_s, k_s, v_s = (_strides(t, n) for t, n in ((q, "q"), (k, "k"),
                                                  (v, "v")))
    m_sh = mask_k.stride(0) if BH > 1 else 0
    fn, max_keys = _bind()
    if Nk > max_keys[variant]:
        raise ValueError(f"the kernel holds at most {max_keys[variant]} "
                         f"keys in this dtype mix; got {Nk}")
    out = torch.empty((BH, Nq, d), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_k.data_ptr(),
             out.data_ptr(), BH, Nq, Nk, *q_s, *k_s, *v_s, m_sh, *variant,
             1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"masked_attention kernel launch failed: CUDA "
                           f"error {err}")
    cuda_masked_attention.launches += 1
    return out


cuda_masked_attention.launches = 0


class MaskedAttentionFn(torch.autograd.Function):
    """Masked attention with a gradient (``_pallas_attention_diff``):
    forward the CUDA kernel (the plain version for CPU tensors), backward
    the vector-Jacobian product of the recomputed plain expression.
    ``MaskedAttentionFn.launches`` counts its kernel launches."""

    launches = 0

    @staticmethod
    def forward(ctx, q, k, v, mask_k):
        ctx.save_for_backward(q, k, v, mask_k)
        if q.is_cuda:
            out = cuda_masked_attention(q, k, v, mask_k)
            MaskedAttentionFn.launches += 1
            return out
        return plain_masked_attention(q, k, v, mask_k)

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask_k = ctx.saved_tensors
        leaves = [t.detach().requires_grad_(need) for t, need in
                  zip((q, k, v), ctx.needs_input_grad[:3])]
        wanted = [t for t in leaves if t.requires_grad]
        with torch.enable_grad():
            out = plain_masked_attention(*leaves, mask_k)
            grads = iter(torch.autograd.grad(out, wanted, g))
        return (*(next(grads) if t.requires_grad else None for t in leaves),
                None)


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask_k: torch.Tensor) -> torch.Tensor:
    """Dispatch: the CUDA kernel for CUDA tensors (through
    :class:`MaskedAttentionFn` when a gradient is wanted), the plain version
    for CPU tensors."""
    if q.is_cuda:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return MaskedAttentionFn.apply(q, k, v, mask_k)
        return cuda_masked_attention(q, k, v, mask_k)
    return plain_masked_attention(q, k, v, mask_k)
