"""Zstandard decompression through the repository's own decoder
(``csrc/zstd_decode.c``, RFC 8878's decoding side), built at first use
with the host's C compiler. It is the only zstd path of the port, on every
machine: the trained checkpoint's chunks and B-tree nodes are zstd frames,
and neither Python 3.12's standard library nor the GPU machine has a zstd
module.
"""
from __future__ import annotations

import ctypes
from typing import Optional

from simpleslam_tpu_torch.utils import cuda_build

SOURCE = "zstd_decode.c"

_ERRORS = {-1: "malformed zstd data", -2: "output buffer too small",
           -3: "zstd dictionaries are not supported"}


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        lib.zstd_decompress.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                        ctypes.c_void_p, ctypes.c_size_t]
        lib.zstd_decompress.restype = ctypes.c_longlong
        lib.zstd_content_size.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        lib.zstd_content_size.restype = ctypes.c_longlong
        lib._typed = True
    return lib


def content_size(data: bytes) -> Optional[int]:
    """The first frame's declared content size, or None."""
    n = _lib().zstd_content_size(data, len(data))
    return None if n < 0 else int(n)


def decompress(data: bytes, size: Optional[int] = None) -> bytes:
    """All frames of ``data`` decoded. ``size``: the expected output size,
    if known; otherwise the frame header's, else the buffer grows until it
    fits."""
    lib = _lib()
    exact = size is not None
    cap = size if exact else (content_size(data) or max(1024, 4 * len(data)))
    while True:
        out = ctypes.create_string_buffer(max(cap, 1))
        n = lib.zstd_decompress(data, len(data), out, cap)
        if n == -2 and not exact:
            cap *= 2
            continue
        if n < 0:
            raise ValueError(_ERRORS.get(n, f"zstd error {n}"))
        if exact and n != cap:
            raise ValueError(f"zstd data decoded to {n} bytes, expected {cap}")
        return out.raw[:n]
