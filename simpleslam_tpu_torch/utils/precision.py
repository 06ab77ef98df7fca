"""Float32 precision control for geometry code (the counterpart of
``simpleslam_tpu/utils/precision.py::highest_precision``).

On the GPU, PyTorch may run float32 matrix products and convolutions in
TF32 (about three decimal digits). That is fine for the neural front-end,
which runs in bfloat16 anyway, but not for multi-view geometry: RANSAC
gating, DLT triangulation, PnP and bundle adjustment need sub-pixel
(< 1e-5 relative) accuracy. :func:`highest_precision` turns TF32 off for
both matmuls and cuDNN while the wrapped code runs, as a decorator or as a
context manager.
"""
from __future__ import annotations

import contextlib

import torch


class highest_precision(contextlib.ContextDecorator):
    """Run the enclosed code with TF32 disabled for matmul and cuDNN."""

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self._saved
        return False
