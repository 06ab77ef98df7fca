"""Build the port's native sources into shared libraries with a plain C
interface, loaded through ``ctypes``.

A library is built at first use from the source in ``csrc/`` into
``simpleslam_tpu_torch/_build/`` (listed in ``.gitignore``), named by a hash
of the source and the flags, so an edited source is rebuilt and an
unchanged one is reused. The suffix picks the toolchain: ``.cu`` sources go
through ``nvcc`` (seconds for a plain-C-interface source; nothing here
includes PyTorch's headers), ``.c`` sources through the host's C compiler
and ``.cpp`` sources through its C++ compiler (the one ``nvcc`` drives on a
CUDA machine), with ``-pthread``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
CC_FLAGS = ["-std=c99", "-O2", "-shared", "-fPIC"]
CXX_FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC", "-pthread"]

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


def cc_path() -> str:
    for name in ("cc", "gcc", "clang"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C compiler (cc, gcc or clang) found on PATH")


def cxx_path() -> str:
    for name in ("c++", "g++", "clang++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler (c++, g++ or clang++) found on PATH")


def _flags(source: str) -> List[str]:
    if source.endswith(".cu"):
        return NVCC_FLAGS
    return CXX_FLAGS if source.endswith(".cpp") else CC_FLAGS


def library_path(source: str) -> str:
    """Where the library built from ``csrc/<source>`` lives."""
    with open(os.path.join(CSRC, source), "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(_flags(source)).encode()
                              ).hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")


def build(source: str) -> str:
    """Build ``csrc/<source>`` unless it is built already. Returns the
    compiler's output ("" when nothing was built); raises with it if the
    compiler fails."""
    lib = library_path(source)
    if os.path.exists(lib):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    if source.endswith(".cu"):
        cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v"]
    elif source.endswith(".cpp"):
        cmd = [cxx_path(), *CXX_FLAGS]
    else:
        cmd = [cc_path(), *CC_FLAGS]
    cmd += ["-o", tmp, os.path.join(CSRC, source)]
    run = subprocess.run(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if run.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{cmd[0]} failed on {source}:\n{run.stdout}")
    os.replace(tmp, lib)
    return run.stdout


def build_all(sources: Sequence[str]) -> Dict[str, str]:
    """Build several sources at once, one compiler process each, all
    started together: {source: compiler output}. Raises if any fails."""
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        return dict(zip(sources, pool.map(build, sources)))


def load(source: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<source>``, built first if needed."""
    lib = _LOADED.get(source)
    if lib is None:
        build(source)
        lib = ctypes.CDLL(library_path(source))
        _LOADED[source] = lib
    return lib
