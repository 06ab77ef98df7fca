"""Image resizes without cv2 or JAX, each as two small matrix products.

A resize along one axis is a fixed (out x in) weight matrix, so a 2-D resize
of the last two axes is ``Wy @ x @ Wx^T``. The matrices reproduce:

* :func:`resize_bicubic_like_jax`: ``jax.image.resize(..., "bicubic")``
  (``jax.image.scale_and_translate``): the Keys cubic with a = -0.5 at
  half-pixel centres, the kernel widened by the ratio when shrinking
  (antialiasing), each output's weights normalised over the taps that lie
  inside the input. ``F.interpolate(mode="bicubic")`` uses a = -0.75 and
  clamps at the edges, which differs by up to 0.1 on data in [0, 1] when
  ``models/train.py::_smooth_noise`` upsamples its coarse grids;
* :func:`resize_linear_like_jax`: ``jax.image.resize(..., "linear")``, the
  same scheme with the triangle kernel: when shrinking by 1.2 (the ORB
  pyramid, ``ops/features.py``) each output averages about 2.4 inputs.
  Neither ``F.interpolate(mode="bilinear")`` nor :func:`resize_linear`
  widens the kernel;
* :func:`resize_linear`: cv2's ``INTER_LINEAR`` on float32 (half-pixel
  centres; a source position left of the first pixel or right of the last
  takes that pixel);
* :func:`resize_area`: cv2's ``INTER_AREA`` when shrinking: each output
  pixel averages the input pixels its cell covers, each weighted by its
  fractional overlap (``computeResizeAreaTab``).
  ``F.interpolate(mode="area")`` is adaptive pooling and weights whole
  pixels instead.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def bicubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of ``jax.image.resize``'s bicubic along one
    axis (``compute_weight_mat`` with scale n_out / n_in, translation 0,
    antialias on), in float32 as JAX computes them."""
    f32 = np.float32
    inv_scale = f32(1.0) / (f32(n_out) / f32(n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    w = _keys_cubic(x).astype(f32)
    total = w.sum(0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0).astype(f32)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(f32).T


def triangle_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of ``jax.image.resize``'s linear along one
    axis (``compute_weight_mat``: the scale n_out / n_in in double, then
    float32 arithmetic; antialias on)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = w.sum(0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0).astype(f32)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(f32).T


def linear_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of cv2's ``INTER_LINEAR`` along one axis (the
    source position in double, the two coefficients as float32)."""
    scale = 1.0 / (n_out / n_in)
    w = np.zeros((n_out, n_in), np.float32)
    for d in range(n_out):
        f = (d + 0.5) * scale - 0.5
        s = math.floor(f)
        f -= s
        if s < 0:
            f, s = 0.0, 0
        if s >= n_in - 1:
            f, s = 0.0, n_in - 1
        w[d, s] += np.float32(1.0 - f)
        if f != 0:
            w[d, s + 1] += np.float32(f)
    return w


def area_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of cv2's ``INTER_AREA`` along one axis when
    shrinking (n_in >= n_out): ``computeResizeAreaTab``'s fractional
    overlaps over the cell width, as float32."""
    if n_in < n_out:
        raise ValueError(f"resize_area shrinks; got {n_in} -> {n_out}")
    scale = n_in / n_out
    w = np.zeros((n_out, n_in), np.float32)
    for d in range(n_out):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_in - f1)
        s2 = min(math.floor(f2), n_in - 1)
        s1 = min(math.ceil(f1), s2)
        if s1 - f1 > 1e-3:
            w[d, s1 - 1] = np.float32((s1 - f1) / cell)
        for s in range(s1, s2):
            w[d, s] = np.float32(1.0 / cell)
        if f2 - s2 > 1e-3:
            w[d, s2] = np.float32(min(min(f2 - s2, 1.0), cell) / cell)
    return w


def _apply(x: torch.Tensor, wy: np.ndarray, wx: np.ndarray) -> torch.Tensor:
    wy_t = torch.as_tensor(wy, dtype=x.dtype, device=x.device)
    wx_t = torch.as_tensor(wx, dtype=x.dtype, device=x.device)
    return wy_t @ x @ wx_t.T


def resize_bicubic_like_jax(x: torch.Tensor, out_hw: Tuple[int, int]
                            ) -> torch.Tensor:
    """``jax.image.resize(x, (..., H, W), "bicubic")`` of the last two
    axes of a float tensor."""
    H, W = out_hw
    return _apply(x, bicubic_weights(x.shape[-2], H),
                  bicubic_weights(x.shape[-1], W))


@functools.lru_cache(maxsize=64)
def _triangle_matrix(n_in: int, n_out: int, dtype: torch.dtype,
                     device: torch.device) -> torch.Tensor:
    """:func:`triangle_weights` on ``device``, made once per shape (the ORB
    pyramid resizes every frame to the same sizes; a copy from the host
    would wait for the device)."""
    return torch.as_tensor(triangle_weights(n_in, n_out), dtype=dtype,
                           device=device)


def resize_linear_like_jax(x: torch.Tensor, out_hw: Tuple[int, int]
                           ) -> torch.Tensor:
    """``jax.image.resize(x, (..., H, W), "linear")`` of the last two axes
    of a float tensor."""
    H, W = out_hw
    wy = _triangle_matrix(x.shape[-2], H, x.dtype, x.device)
    wx = _triangle_matrix(x.shape[-1], W, x.dtype, x.device)
    return wy @ x @ wx.T


def resize_linear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """``cv2.resize(x, (W, H), interpolation=INTER_LINEAR)`` of the last
    two axes of a float32 tensor."""
    H, W = out_hw
    return _apply(x, linear_weights(x.shape[-2], H),
                  linear_weights(x.shape[-1], W))


def resize_area(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """``cv2.resize(x, (W, H), interpolation=INTER_AREA)`` of the last two
    axes of a float32 tensor, shrinking (or keeping) each axis."""
    H, W = out_hw
    return _apply(x, area_weights(x.shape[-2], H),
                  area_weights(x.shape[-1], W))
