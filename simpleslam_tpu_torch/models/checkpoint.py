"""The trained front-end checkpoint, read without orbax or tensorstore (the
counterpart of ``simpleslam_tpu/models/pipeline.py::_load_repo_checkpoint``
and ``_graft_matching``).

``checkpoints/learned_frontend`` is an orbax tree stored as an OCDBT
key-value store (tensorstore's format) holding one zarr v2 array per leaf:

* ``manifest.ocdbt``: a header, a zstd-compressed body and a CRC-32C
  footer. The body holds the store's config, a table of data files and the
  latest version, which names the B-tree root node (file, offset, length,
  height);
* B-tree nodes (``d/...``): the same framing. A leaf node lists its keys
  (each sharing a prefix with the one before), then each value's length and
  kind: inline values follow the node's key table, indirect ones are
  (data file, offset) ranges of files under ``ocdbt.process_0/d/``. An
  interior node lists child nodes the same way;
* values: per leaf ``<path>/.zarray`` (zarr v2 JSON: shape, chunks,
  dtype, compressor) and chunks ``<path>/<i>.<j>...``, zstd frames of the
  C-ordered raw array;
* ``_METADATA``: the tree paths, e.g. ``('aliked', 'params', 'block1',
  'Conv_0', 'bias')``, stored under the key ``aliked.params.block1...``.

CRC-32C footers are not verified; the zstd frames and the zarr shapes are.

A tree the port trained (``models/train_frontend.py``) is one ``.npz``
instead: each leaf stored under its tree path joined by ``/`` (for example
``aliked/params/block1/Conv_0/kernel``), flax's layout and names.
:func:`load_frontend_tree` reads either kind.
"""
from __future__ import annotations

import ast
import json
import logging
import os
import struct
from functools import lru_cache
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from simpleslam_tpu_torch.utils import zstd

logger = logging.getLogger("checkpoint")

DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "checkpoints", "learned_frontend")
ENV_VAR = "SLAM_FRONTEND_CKPT"

_MANIFEST_MAGIC = 0x0CDB3A2A
_NODE_MAGIC = 0x0CDB20DE


class _Reader:
    """Sequential reader of varints and bytes."""

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf, self.pos = buf, pos

    def byte(self) -> int:
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def varint(self) -> int:
        out, shift = 0, 0
        while True:
            b = self.byte()
            out |= (b & 0x7F) << shift
            shift += 7
            if b < 0x80:
                return out

    def varints(self, n: int):
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        out = self.buf[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("OCDBT record ends early")
        self.pos += n
        return out


def _unframe(raw: bytes, magic: int) -> _Reader:
    """Header (magic, length, version, compression), body, CRC footer ->
    a reader over the decompressed body."""
    if len(raw) < 16 or struct.unpack(">I", raw[:4])[0] != magic:
        raise ValueError("not an OCDBT record (bad magic)")
    (length,) = struct.unpack("<Q", raw[4:12])
    if length != len(raw):
        raise ValueError(f"OCDBT record length {length} != {len(raw)}")
    head = _Reader(raw, 12)
    if head.varint() != 0:
        raise ValueError("unknown OCDBT format version")
    compression = head.varint()
    body = raw[head.pos:-4]
    if compression == 1:
        body = zstd.decompress(body)
    elif compression != 0:
        raise ValueError(f"unknown OCDBT compression {compression}")
    return _Reader(body)


def _data_file_table(r: _Reader):
    """Paths of the data files a record refers to, relative to the root."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    r.varints(n)                   # base-path lengths: part of the path
    paths, prev = [], b""
    for p, s in zip(prefix, suffix):
        prev = prev[:p] + r.take(s)
        paths.append(prev.decode())
    return paths


class OcdbtStore:
    """Read-only view of one OCDBT key-value store on disk."""

    def __init__(self, root: str):
        self.root = root
        self._files: Dict[str, bytes] = {}
        with open(os.path.join(root, "manifest.ocdbt"), "rb") as f:
            r = _unframe(f.read(), _MANIFEST_MAGIC)
        r.take(16)                             # uuid
        if r.varint() != 0:
            raise ValueError("only single-file OCDBT manifests are read")
        r.varint()                             # max inline value bytes
        r.varint()                             # max decoded node bytes
        r.byte()                               # version tree arity (log2)
        if r.varint() == 1:
            r.varint()                         # zstd level
        for _ in range(3):                     # data file prefixes
            r.take(r.varint())
        files = _data_file_table(r)
        n_versions = r.varint()
        if n_versions < 1:
            raise ValueError("OCDBT manifest has no version")
        generation = r.varints(n_versions)
        heights = [r.byte() for _ in range(n_versions)]
        fid, off, length = (r.varints(n_versions) for _ in range(3))
        latest = int(np.argmax(generation))
        self._root_ref = (files[fid[latest]], off[latest], length[latest],
                          heights[latest])

    def _bytes(self, path: str, offset: int, length: int) -> bytes:
        with open(os.path.join(self.root, path), "rb") as f:
            f.seek(offset)
            out = f.read(length)
        if len(out) != length:
            raise ValueError(f"{path}: {length} bytes at {offset} not found")
        return out

    def items(self) -> Dict[str, bytes]:
        """Every key of the store with its value."""
        out: Dict[str, bytes] = {}
        self._walk(self._root_ref, b"", out)
        return out

    def _walk(self, ref, prefix: bytes, out: Dict[str, bytes]) -> None:
        path, offset, length, height = ref
        r = _unframe(self._bytes(path, offset, length), _NODE_MAGIC)
        if r.byte() != height:
            raise ValueError("OCDBT node height disagrees with its parent")
        files = _data_file_table(r)
        n = r.varint()
        kp = [0] + r.varints(n - 1) if n else []
        ks = r.varints(n)
        if height > 0:
            r.varints(n)                       # subtree common-prefix lengths
        keys, prev = [], b""
        for p, s in zip(kp, ks):
            prev = prev[:p] + r.take(s)
            keys.append(prefix + prev)
        if height > 0:
            fid, off, ln = (r.varints(n) for _ in range(3))
            for i in range(n):
                self._walk((files[fid[i]], off[i], ln[i], height - 1),
                           keys[i], out)
            return
        lengths = r.varints(n)
        kinds = r.varints(n)
        indirect = [i for i in range(n) if kinds[i] == 1]
        fid = r.varints(len(indirect))
        off = r.varints(len(indirect))
        for j, i in enumerate(indirect):
            out[keys[i].decode()] = self._bytes(files[fid[j]], off[j],
                                                lengths[i])
        for i in range(n):
            if kinds[i] == 0:
                out[keys[i].decode()] = r.take(lengths[i])
            elif kinds[i] != 1:
                raise ValueError(f"unknown OCDBT value kind {kinds[i]}")


def _zarr_array(store: Mapping[str, bytes], name: str) -> np.ndarray:
    meta = json.loads(store[f"{name}/.zarray"])
    if meta.get("zarr_format") != 2 or meta.get("filters"):
        raise ValueError(f"{name}: unsupported zarr array {meta}")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{name}: unsupported compressor {comp}")
    dtype = np.dtype(meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value") or 0
    out = np.full(shape, fill, dtype)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid) if grid else [()]:
        key = f"{name}/" + (sep.join(map(str, idx)) if idx else "0")
        if key not in store:
            continue
        raw = store[key]
        n = int(np.prod(chunks)) * dtype.itemsize
        data = zstd.decompress(raw, n) if comp is not None else raw
        order = "F" if meta.get("order") == "F" else "C"
        block = np.frombuffer(data, dtype).reshape(chunks, order=order)
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        out[sl] = block[tuple(slice(0, x.stop - x.start) for x in sl)]
    return out


def read_tree(path: str) -> dict:
    """The orbax tree at ``path`` as nested dicts of numpy arrays."""
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)["tree_metadata"]
    store = OcdbtStore(path).items()
    tree: dict = {}
    for key_str in meta:
        keys = [str(k) for k in ast.literal_eval(key_str)]
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = _zarr_array(store, ".".join(keys))
    return tree


def tree_stats(tree: Mapping) -> Tuple[int, int]:
    """(leaf count, bytes) of a nested tree of arrays."""
    n, size = 0, 0
    for v in tree.values():
        if isinstance(v, Mapping):
            dn, ds = tree_stats(v)
            n, size = n + dn, size + ds
        else:
            n, size = n + 1, size + v.nbytes
    return n, size


def read_npz_tree(path: str) -> dict:
    """A tree written by :func:`save_npz_tree` as nested dicts of numpy
    arrays."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            keys = key.split("/")
            node = tree
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = z[key]
    return tree


def save_npz_tree(path: str, tree: Mapping) -> None:
    """Write a nested tree of numpy arrays as one ``.npz`` (leaves keyed by
    their ``/``-joined path), through a temporary file renamed into place."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for k, v in node.items():
            name = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, Mapping):
                walk(v, name)
            else:
                flat[name] = np.asarray(v)

    walk(tree, "")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def checkpoint_dir() -> str:
    """``SLAM_FRONTEND_CKPT`` if set, else the repository's tree."""
    return os.environ.get(ENV_VAR, DEFAULT_DIR)


@lru_cache(maxsize=2)
def _read_cached(path: str, mtime_ns: int) -> dict:
    return read_npz_tree(path) if os.path.isfile(path) else read_tree(path)


def load_frontend_tree(path: Optional[str] = None,
                       on_error: str = "warn") -> Optional[dict]:
    """The trained tree ``{"aliked": ..., "lightglue": ...}`` (numpy
    leaves, shared between callers: do not modify) of an orbax directory
    or a ``.npz`` file, read once per path and modification time.

    With no tree at ``path``, or one that fails to read, ``on_error="warn"``
    logs a warning naming the path and returns None (the caller then keeps
    seeded weights); ``on_error="raise"`` raises."""
    path = os.path.abspath(path or checkpoint_dir())
    try:
        if not os.path.exists(path):
            raise FileNotFoundError(f"no checkpoint at {path}")
        tree = _read_cached(path, os.stat(path).st_mtime_ns)
        if "aliked" not in tree or "lightglue" not in tree:
            raise ValueError(f"{path} holds no aliked/lightglue trees")
        return tree
    except (OSError, ValueError, KeyError, IndexError, SyntaxError) as e:
        if on_error == "raise":
            raise
        logger.warning("learned front-end checkpoint at %s not restored "
                       "(%s); using seeded random weights", path, e)
        return None


def graft_matching(module: torch.nn.Module,
                   loaded: Mapping[str, torch.Tensor]) -> int:
    """Copy each loaded leaf whose name and shape match the module's into
    it, leave the others as they are (``_graft_matching``'s rule). Returns
    the number of leaves copied."""
    n = 0
    with torch.no_grad():
        for name, p in module.state_dict().items():
            src = loaded.get(name)
            if src is not None and tuple(src.shape) == tuple(p.shape):
                p.copy_(src.to(p.dtype))
                n += 1
    return n
