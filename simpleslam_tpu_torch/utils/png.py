"""PNG reading and writing in numpy and ``zlib`` (no cv2, no PIL).

:func:`decode_png` returns what ``cv2.imread(path, cv2.IMREAD_UNCHANGED)``
returns for an 8-bit image: grey as (H, W), RGB as BGR (H, W, 3), RGBA as
BGRA (H, W, 4), and grey+alpha as BGRA with the grey copied into the three
colour channels. IDAT may be split over several chunks and each row may
use any of the five filters (libpng picks them per row). Interlaced,
16-bit, palette and sub-byte images raise ``ValueError`` naming the case.

:func:`encode_png` writes grey, BGR and BGRA uint8 arrays as
``cv2.imwrite`` does: RGB(A) order in the file, every row Sub-filtered,
zlib at its fastest level.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}     # colour type -> samples per pixel
_KINDS = {0: "grey", 2: "RGB", 3: "palette", 4: "grey+alpha", 6: "RGBA"}


def _chunks(data: bytes):
    i = len(SIGNATURE)
    while i + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[i:i + 8])
        yield kind, data[i + 8:i + 8 + n]
        i += 12 + n
        if kind == b"IEND":
            return
    raise ValueError("PNG ends without an IEND chunk")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_wavefront(ft: np.ndarray, f: np.ndarray) -> np.ndarray:
    """Any mix of the five filters: a pixel needs its left, upper and
    upper-left neighbours, so the pixels of one anti-diagonal are
    independent and each diagonal is one vectorised step."""
    h, w, _ = f.shape
    r = np.zeros((h + 1, w + 1, f.shape[2]), np.int16)   # zero border
    f = f.astype(np.int16)
    for d in range(h + w - 1):
        ys = np.arange(max(0, d - w + 1), min(h, d + 1))
        xs = d - ys
        left, up, ul = r[ys + 1, xs], r[ys, xs + 1], r[ys, xs]
        t = ft[ys][:, None]
        pred = np.where(t == 1, left, np.where(
            t == 2, up, np.where(t == 3, (left + up) >> 1, np.where(
                t == 4, _paeth(left, up, ul), 0))))
        r[ys + 1, xs + 1] = (f[ys, xs] + pred) & 255
    return r[1:, 1:].astype(np.uint8)


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """(h, w, bpp) uint8 pixels of the decompressed, filtered scanlines."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size < h * (w * bpp + 1):
        raise ValueError("PNG image data is truncated")
    rows = rows[:h * (w * bpp + 1)].reshape(h, w * bpp + 1)
    ft, f = rows[:, 0], rows[:, 1:].reshape(h, w, bpp)
    if ft.max(initial=0) > 4:
        raise ValueError(f"PNG row filter {int(ft.max())} is not one of 0-4")
    if (ft >= 3).any():
        return _unfilter_wavefront(ft, f)
    # None, Sub and Up only: Sub is a running sum along the row (uint8
    # wraps mod 256), Up adds the row above
    out = np.where((ft == 1)[:, None, None],
                   np.cumsum(f, axis=1, dtype=np.uint8), f)
    for y in np.flatnonzero(ft == 2):
        out[y] = f[y] + (out[y - 1] if y else 0)
    return out


def decode_png(data: bytes) -> np.ndarray:
    """An 8-bit PNG file's bytes -> uint8 array (see the module doc)."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file (bad signature)")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, ctype, _comp, _filt, interlace = header
    if ctype not in _KINDS:
        raise ValueError(f"PNG colour type {ctype} is not valid")
    if ctype == 3:
        raise ValueError("palette PNG images are not supported")
    if interlace:
        raise ValueError("interlaced (Adam7) PNG images are not supported")
    if depth == 16:
        raise ValueError("16-bit PNG images are not supported")
    if depth != 8:
        raise ValueError(f"{depth}-bit {_KINDS[ctype]} PNG images are not "
                         "supported (8-bit only)")
    bpp = _CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w, bpp)
    if ctype == 0:
        return px[..., 0]
    if ctype == 4:                                   # grey+alpha -> BGRA
        return np.concatenate([px[..., :1]] * 3 + [px[..., 1:]], axis=-1)
    order = [2, 1, 0] if ctype == 2 else [2, 1, 0, 3]
    return np.ascontiguousarray(px[..., order])


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """Grey (H, W), BGR (H, W, 3) or BGRA (H, W, 4) uint8 -> PNG bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png writes uint8 images, got {img.dtype}")
    if img.ndim == 2:
        img, ctype = img[..., None], 0
    elif img.ndim == 3 and img.shape[2] in (3, 4):
        ctype = 2 if img.shape[2] == 3 else 6
        img = img[..., [2, 1, 0] if ctype == 2 else [2, 1, 0, 3]]
    else:
        raise ValueError(f"encode_png writes grey, BGR or BGRA images, got "
                         f"shape {img.shape}")
    h, w, _ = img.shape
    sub = np.diff(img, axis=1, prepend=np.zeros_like(img[:, :1]))
    rows = np.concatenate([np.ones((h, 1), np.uint8),
                           sub.reshape(h, -1)], axis=1)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
