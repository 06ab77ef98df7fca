"""Key-masked attention for the LightGlue matcher: the hand-written CUDA
kernels, their plain PyTorch versions, and the dispatch between them.

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
becomes :class:`MaskedAttentionFn`. Its forward is the kernel; its
backward is one call of the backward kernel ``csrc/masked_attention_bwd.cu``
(:func:`cuda_masked_attention_bwd`, ``.launches``; one device kernel where a
head's blocks fit one thread-block cluster, N <= 512 as in training, else
two: the row statistics, then the gradients; :func:`bwd_kernels_per_call`
says which), which computes the vector-Jacobian
product of the plain expression: dq, dk and dv in the inputs' dtypes and
nothing for the mask, as the reference's ``_pad_bwd`` (XLA's autodiff of
``xla_masked_attention``) does. Its plain version is
:func:`plain_masked_attention_bwd`, the same VJP in closed form, which is
the backward for CPU tensors. :func:`masked_attention` takes the Function
only for CUDA tensors when gradients are enabled and an input requires one
(training); every other CUDA call goes straight to the forward kernel.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from simpleslam_tpu_torch.utils import cuda_build

SOURCE = "masked_attention.cu"
BWD_SOURCE = "masked_attention_bwd.cu"
_NEG = -1e9


def _compute_dtype(*ts: torch.Tensor) -> torch.dtype:
    """float32, or float64 where an input is float64 (the gradient
    checks)."""
    ct = torch.float32
    for t in ts:
        ct = torch.promote_types(ct, t.dtype)
    return ct


def plain_masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask_k: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version (counterpart of ``xla_masked_attention``):
    float32, or float64 where an input is float64 (the gradient checks)."""
    d = q.shape[-1]
    ct = _compute_dtype(q, v)
    logits = torch.einsum("bnd,bmd->bnm", q.to(ct), k.to(ct)) / math.sqrt(d)
    logits = torch.where(mask_k[:, None, :], logits,
                         torch.full_like(logits, _NEG))
    return torch.einsum("bnm,bmd->bnd", torch.softmax(logits, -1), v.to(ct))


def plain_masked_attention_bwd(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, mask_k: torch.Tensor,
                               g: torch.Tensor):
    """(dq, dk, dv): the vector-Jacobian product of
    :func:`plain_masked_attention` at upstream gradient ``g``, in closed
    form (the backward kernel's plain version, and the Function's backward
    for CPU tensors). Masked logits are replaced, so masked keys pass no
    gradient to q or k; a head with no live key has a uniform P. Computes
    in float32 (float64 where an input is) and rounds each gradient to its
    input's dtype once."""
    d = q.shape[-1]
    ct = _compute_dtype(q, v, g)
    qc, kc, vc, gc = (t.to(ct) for t in (q, k, v, g))
    live = mask_k[:, None, :]
    logits = torch.einsum("bnd,bmd->bnm", qc, kc) / math.sqrt(d)
    p = torch.softmax(torch.where(live, logits,
                                  torch.full_like(logits, _NEG)), -1)
    dv = torch.einsum("bnm,bnd->bmd", p, gc)
    dp = torch.einsum("bnd,bmd->bnm", gc, vc)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    ds = torch.where(live, ds, torch.zeros_like(ds))
    dq = torch.einsum("bnm,bmd->bnd", ds, kc) / math.sqrt(d)
    dk = torch.einsum("bnm,bnd->bmd", ds, qc) / math.sqrt(d)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# (q/k dtype, v dtype) -> (qk_bf16, v_bf16): the kernels' compiled variants
_VARIANTS = {(torch.float32, torch.bfloat16): (0, 1),
             (torch.bfloat16, torch.bfloat16): (1, 1),
             (torch.float32, torch.float32): (0, 0)}


def _bind_lib(source: str, name: str, n_ptr: int, n_strides: int):
    """(launch, {variant: the most keys it holds}) of a kernel library,
    built, typed and queried once. The launch takes ``n_ptr`` pointers,
    BH, Nq, Nk, ``n_strides`` strides, the variant, the scale and the
    stream; ``<name>_max_keys`` the variant."""
    lib = cuda_build.load(source)
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 3 + [
        ctypes.c_longlong] * n_strides + [ctypes.c_int] * 2 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    max_keys = getattr(lib, name + "_max_keys")
    max_keys.argtypes = [ctypes.c_int] * 2
    max_keys.restype = ctypes.c_int
    return fn, {v: max_keys(*v) for v in _VARIANTS.values()}


@functools.lru_cache(maxsize=None)
def _bind():
    """The forward kernel: q, k, v, mask, out; 7 strides."""
    return _bind_lib(SOURCE, "masked_attention", 5, 7)


@functools.lru_cache(maxsize=None)
def _bind_bwd():
    """The backward kernel: q, k, v, mask, g, stats, dq, dk, dv; 9
    strides."""
    return _bind_lib(BWD_SOURCE, "masked_attention_bwd", 9, 9)


def bwd_kernels_per_call(Nq: int, Nk: int) -> int:
    """The device kernels one backward call launches at (Nq, Nk), whatever
    gradients are wanted: 1 where a head's key and query blocks (128 rows
    each) fit one cluster of 8, else 2 (the kernel library's own rule)."""
    fn = cuda_build.load(BWD_SOURCE).masked_attention_bwd_kernels
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    return fn(Nq, Nk)


def _raw_stream(t: torch.Tensor) -> int:
    """The handle of the current CUDA stream on CUDA tensor ``t``'s device,
    from PyTorch's raw getter (no ``torch.cuda.Stream`` built per call)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _bwd_buffers(q, k, v, needs):
    """(stats, [dq, dk, dv]) as views of one buffer per dtype: the float32
    statistics scratch (2, BH, Nq, 4) first (a partial record per row and
    key half), then each wanted gradient in its input's dtype (None where
    not wanted). Every view starts 16-byte aligned (each is a multiple of
    64 elements)."""
    BH, Nq, d = q.shape
    Nk = k.shape[1]
    parts = [("stats", torch.float32, (2, BH, Nq, 4))]
    parts += [(i, t.dtype, (BH, n, d)) for i, (t, n, need) in
              enumerate(zip((q, k, v), (Nq, Nk, Nk), needs)) if need]
    sizes = {}
    for _n, dt, shape in parts:
        sizes[dt] = sizes.get(dt, 0) + math.prod(shape)
    bufs = {dt: torch.empty(n, dtype=dt, device=q.device)
            for dt, n in sizes.items()}
    offs = dict.fromkeys(sizes, 0)
    views = {}
    for name, dt, shape in parts:
        n = math.prod(shape)
        views[name] = bufs[dt][offs[dt]:offs[dt] + n].view(shape)
        offs[dt] += n
    return views["stats"], [views.get(i) for i in range(3)]


def _strides_ok(t: torch.Tensor) -> bool:
    """Whether the kernels take ``t`` as it lies (see :func:`_strides`)."""
    sh, sr, sd = t.stride()
    size = t.element_size()
    sh = sh if t.shape[0] > 1 else 0
    sr = sr if t.shape[1] > 1 else 0
    return not (sd != 1 or (sh * size) % 16 or (sr * size) % 16
                or t.data_ptr() % 16)


def _strides(t: torch.Tensor, name: str):
    """(head stride, row stride) in elements of a (BH, N, 64) operand; a
    dim of size 1 has no stride. Raises unless the head dim is contiguous
    and both strides and the base are 16-byte aligned."""
    if not _strides_ok(t):
        raise ValueError(f"{name}: the kernel takes a contiguous head dim "
                         f"and 16-byte aligned rows and heads; got strides "
                         f"{tuple(t.stride())} ({t.dtype})")
    sh, sr, _sd = t.stride()
    return (sh if t.shape[0] > 1 else 0), (sr if t.shape[1] > 1 else 0)


def _operands(q, k, v, mask_k):
    """Check what both kernels take; returns (variant, q/k/v strides, the
    mask's head stride). Raises on anything they do not take."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda and mask_k.is_cuda):
        raise ValueError("the attention kernels need CUDA tensors")
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    BH, _Nq, d = q.shape
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
    strides = [x for t, n in ((q, "q"), (k, "k"), (v, "v"))
               for x in _strides(t, n)]
    return variant, strides, (mask_k.stride(0) if BH > 1 else 0)


def _check_keys(Nk: int, variant, max_keys) -> None:
    """Raise past a kernel's key limit (``max_keys``: {variant: keys})."""
    if Nk > max_keys[variant]:
        raise ValueError(f"the kernel holds at most {max_keys[variant]} "
                         f"keys in this dtype mix; got {Nk}")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def cuda_masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask_k: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; returns float32
    (BH, Nq, 64). Raises on anything the kernel does not take."""
    return _launch(q, k, v, mask_k, _operands(q, k, v, mask_k))


def _launch(q, k, v, mask_k, checked):
    """:func:`cuda_masked_attention` on operands that :func:`_operands`
    has passed (``checked``, its result)."""
    fn, max_keys = _bind()
    variant, strides, m_sh = checked
    _check_keys(k.shape[1], variant, max_keys)
    BH, Nq, d = q.shape
    out = torch.empty((BH, Nq, d), dtype=torch.float32, device=q.device)
    stream = _raw_stream(q)
    _raise_on(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_k.data_ptr(),
                 out.data_ptr(), BH, Nq, k.shape[1], *strides, m_sh, *variant,
                 1.0 / math.sqrt(d), stream), "masked_attention")
    cuda_masked_attention.launches += 1
    return out


cuda_masked_attention.launches = 0


def cuda_masked_attention_bwd(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, mask_k: torch.Tensor,
                              g: torch.Tensor, needs=(True, True, True)):
    """Launch the backward kernel on the current stream (one or two device
    kernels, :func:`bwd_kernels_per_call`): (dq, dk, dv) in q's, k's and
    v's dtypes, ``None``
    where ``needs`` says so. ``g`` is the float32 upstream gradient, taken
    strided where its head dim is contiguous and copied otherwise
    (``.g_copies`` counts those copies). Raises on anything the kernel does
    not take, beyond its key limit included."""
    return _launch_bwd(q, k, v, mask_k, g, needs, _operands(q, k, v, mask_k))


def _launch_bwd(q, k, v, mask_k, g, needs, checked):
    """:func:`cuda_masked_attention_bwd` on operands that :func:`_operands`
    has passed (``checked``, its result)."""
    fn, max_keys = _bind_bwd()
    variant, strides, m_sh = checked
    BH, Nq, d = q.shape
    Nk = k.shape[1]
    _check_keys(Nk, variant, max_keys)
    if g.dtype != torch.float32 or tuple(g.shape) != (BH, Nq, d) \
            or not g.is_cuda:
        raise ValueError(f"g must be float32 {(BH, Nq, d)} on the card, got "
                         f"{g.dtype} {tuple(g.shape)}")
    if not _strides_ok(g):
        g = g.contiguous()
        cuda_masked_attention_bwd.g_copies += 1
    if not any(needs):
        return None, None, None
    stats, grads = _bwd_buffers(q, k, v, needs)
    stream = _raw_stream(q)
    _raise_on(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_k.data_ptr(),
                 g.data_ptr(), stats.data_ptr(),
                 *(x.data_ptr() if x is not None else None for x in grads),
                 BH, Nq, Nk, *strides, *_strides(g, "g"), m_sh, *variant,
                 1.0 / math.sqrt(d), stream), "masked_attention_bwd")
    cuda_masked_attention_bwd.launches += 1
    return tuple(grads)


cuda_masked_attention_bwd.launches = 0
cuda_masked_attention_bwd.g_copies = 0


class MaskedAttentionFn(torch.autograd.Function):
    """Masked attention with a gradient (``_pallas_attention_diff``). For
    CUDA tensors the forward is the kernel and the backward one call of
    :func:`cuda_masked_attention_bwd`; for CPU tensors the plain version and
    :func:`plain_masked_attention_bwd`. No fallback from one to the other.
    ``MaskedAttentionFn.launches`` counts its forward kernel launches."""

    launches = 0

    @staticmethod
    def forward(ctx, q, k, v, mask_k):
        ctx.save_for_backward(q, k, v, mask_k)
        if q.is_cuda:
            ctx.checked = _operands(q, k, v, mask_k)   # once for both
            out = _launch(q, k, v, mask_k, ctx.checked)
            MaskedAttentionFn.launches += 1
            return out
        return plain_masked_attention(q, k, v, mask_k)

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[:3]
        saved = ctx.saved_tensors
        if saved[0].is_cuda:
            grads = _launch_bwd(*saved, g, needs, ctx.checked)
        else:
            grads = plain_masked_attention_bwd(*saved, g)
        return (*(x if need else None for x, need in zip(grads, needs)),
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
