"""The host-side native codecs and readahead (the counterpart of
``simpleslam_tpu/native/``), bound with ``ctypes``.

* ``csrc/lz4.cpp``: the LZ4 block codec of the keyframe thumbnails.
  :func:`compress` writes the reference's container, a tag byte, the
  input's length as a little-endian u32, then the payload. It always
  writes ``L`` (LZ4) and raises when the library does not build: the port
  has no zlib fallback, which would hide a broken build. :func:`decompress`
  reads both tags, so a state that the JAX package wrote with its zlib
  fallback (``Z``) still loads.
* ``csrc/prefetch.cpp``: :class:`FilePrefetcher`, a native thread that
  reads upcoming files through the page cache ahead of the decoder
  (``data/dataloader.py::Prefetcher``).

Each source is built at first use with the host's C++ compiler into
``simpleslam_tpu_torch/_build/`` (``utils/cuda_build.py``).
"""
from __future__ import annotations

import ctypes
import zlib
from typing import Iterable

from simpleslam_tpu_torch.utils import cuda_build

LZ4_SOURCE = "lz4.cpp"
PREFETCH_SOURCE = "prefetch.cpp"
SOURCES = (LZ4_SOURCE, PREFETCH_SOURCE)
TAG_LZ4 = b"\x4c"    # 'L'
TAG_ZLIB = b"\x5a"   # 'Z'


def _lz4() -> ctypes.CDLL:
    lib = cuda_build.load(LZ4_SOURCE)
    if not getattr(lib, "_typed", False):
        size_t, buf = ctypes.c_size_t, ctypes.c_char_p
        lib.slam_lz4_bound.restype = size_t
        lib.slam_lz4_bound.argtypes = [size_t]
        lib.slam_lz4_compress.restype = size_t
        lib.slam_lz4_compress.argtypes = [buf, size_t, buf, size_t]
        lib.slam_lz4_decompress.restype = size_t
        lib.slam_lz4_decompress.argtypes = [buf, size_t, buf, size_t]
        lib._typed = True
    return lib


def _prefetch() -> ctypes.CDLL:
    lib = cuda_build.load(PREFETCH_SOURCE)
    if not getattr(lib, "_typed", False):
        lib.slam_prefetch_start.restype = ctypes.c_void_p
        lib.slam_prefetch_start.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                            ctypes.c_int]
        lib.slam_prefetch_stop.restype = None
        lib.slam_prefetch_stop.argtypes = [ctypes.c_void_p]
        lib._typed = True
    return lib


def compress(data: bytes) -> bytes:
    """LZ4-compress ``data`` into the tagged container. An empty input
    (which the codec refuses) takes the ``Z`` tag, as in the reference."""
    lib = _lz4()
    header = len(data).to_bytes(4, "little")
    bound = lib.slam_lz4_bound(len(data))
    out = ctypes.create_string_buffer(bound)
    n = lib.slam_lz4_compress(data, len(data), out, bound)
    if n:
        return TAG_LZ4 + header + out.raw[:n]
    if data:
        raise RuntimeError("lz4 compression failed")
    return TAG_ZLIB + header + zlib.compress(data, 6)


def decompress(blob: bytes) -> bytes:
    """The inverse of :func:`compress`, for either tag."""
    tag, orig_len = blob[:1], int.from_bytes(blob[1:5], "little")
    payload = blob[5:]
    if tag == TAG_ZLIB:
        return zlib.decompress(payload)
    if tag != TAG_LZ4:
        raise ValueError("unknown compression tag")
    out = ctypes.create_string_buffer(orig_len)
    n = _lz4().slam_lz4_decompress(payload, len(payload), out, orig_len)
    if n != orig_len:
        raise ValueError("corrupt lz4 stream")
    return out.raw


class FilePrefetcher:
    """Background readahead of a list of files on a native thread
    (``slam_prefetch_start`` / ``slam_prefetch_stop``); :meth:`stop`
    cancels and joins it. Entries that are not ``str`` paths are skipped."""

    def __init__(self, paths: Iterable):
        self._handle = None
        paths = [p for p in paths if isinstance(p, str)]
        if not paths:
            return
        self._lib = _prefetch()
        self._keepalive = (ctypes.c_char_p * len(paths))(
            *[p.encode() for p in paths])
        self._handle = self._lib.slam_prefetch_start(self._keepalive,
                                                     len(paths))

    def stop(self) -> None:
        if self._handle:
            self._lib.slam_prefetch_stop(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.stop()
        except Exception:
            pass
