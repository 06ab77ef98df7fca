"""Build the port's CUDA sources with ``nvcc`` into shared libraries with a
plain C interface, loaded through ``ctypes``.

A library is built at first use from the source in ``csrc/`` into
``simpleslam_tpu_torch/_build/`` (listed in ``.gitignore``), named by a hash
of the source and the flags, so an edited source is rebuilt and an
unchanged one is reused. ``nvcc`` compiles a plain-C-interface source in
seconds; nothing here includes PyTorch's headers.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def library_path(source: str) -> str:
    """Where the library built from ``csrc/<source>`` lives."""
    with open(os.path.join(CSRC, source), "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()
                              ).hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")


def build(source: str) -> str:
    """Build ``csrc/<source>`` unless it is built already. Returns the
    compiler's output ("" when nothing was built); raises with it if
    ``nvcc`` fails."""
    lib = library_path(source)
    if os.path.exists(lib):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
           os.path.join(CSRC, source)]
    run = subprocess.run(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if run.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source}:\n{run.stdout}")
    os.replace(tmp, lib)
    return run.stdout


def load(source: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<source>``, built first if needed."""
    lib = _LOADED.get(source)
    if lib is None:
        build(source)
        lib = ctypes.CDLL(library_path(source))
        _LOADED[source] = lib
    return lib
