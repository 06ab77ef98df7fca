"""Roundings by which the reference states a precision.

A :class:`Precision` names how the operands of two kinds of product are
rounded: ``low`` for the products that the configuration runs in
bfloat16 (convolutions, the attention and MLP projections) and ``f32`` for
those it runs in float32 (the attention itself, the input, final and
matchability projections, the assignment). Stored bfloat16 activations are
rounded to bfloat16 either way. Every rounding also rounds the gradient
that flows back through it, as a bfloat16 tensor's gradient is bfloat16.

The configuration's own precision is ``Precision("bfloat16", "float32")``;
the control, one step below it, is ``Precision("fp8", "tf32")``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

FP8_MAX = 448.0          # the largest float8 e4m3 value


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (nearest, ties away from
    zero, as the tensor cores' conversion rounds)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with one scale for the tensor (its largest magnitude
    maps to 448), returned in float32."""
    x = x.float()
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.float().to(torch.bfloat16).float()


_ROUND = {"float32": lambda x: x.float(), "tf32": tf32, "bfloat16": bf16,
          "fp8": fp8}


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def rounder(kind: str):
    """x -> x rounded to ``kind`` (float32 values), gradient likewise."""
    fn = _ROUND[kind]
    if kind == "float32":
        return fn
    return lambda x: _Round.apply(x, fn)


@dataclass(frozen=True)
class Precision:
    low: str = "bfloat16"
    f32: str = "float32"

    def __post_init__(self):
        object.__setattr__(self, "r_low", rounder(self.low))
        object.__setattr__(self, "r_f32", rounder(self.f32))
        object.__setattr__(self, "store", rounder("bfloat16"))


STATED = Precision("bfloat16", "float32")
CONTROL = Precision("fp8", "tf32")


def no_tf32():
    """Turn TF32 off for float32 products (cuBLAS and cuDNN)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
