"""Where the masked attention's backward kernel spends its time, per block
role and phase, on the card: ``csrc/masked_attention_bwd.cu`` built with
``-DMAB_SPANS``, whose warpgroups add the clock64 cycles of each phase of
their tile loop to a device counter.

    python -m simpleslam_tpu_torch.tools.bwd_spans [--shapes 32x96 4x2048]

For each mix and (BH, N) it runs one call after a warm-up and prints, per
role (key blocks; query blocks, pass 1 and 2 together), the thousands of
cycles a warpgroup spends per tile in each phase: the producer waiting for
its loads, for a free stage, and splitting; a consumer waiting for a full
stage, forming S and dP, the softmax (P and dS, or pass 1's statistics),
and the gradient products. Needs an NVIDIA GPU and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import torch

from simpleslam_tpu_torch.ops import attention
from simpleslam_tpu_torch.utils import cuda_build

PHASES = ("producer_wait_loads", "producer_wait_stage", "producer_split",
          "consumer_wait_stage", "consumer_scores", "consumer_softmax",
          "consumer_gradients")
MIXES = {"self": (torch.float32, torch.float32, torch.bfloat16),
         "cross": (torch.bfloat16, torch.bfloat16, torch.bfloat16)}


def build_spans_lib() -> ctypes.CDLL:
    """The backward kernel built with its spans, beside the normal build."""
    src = os.path.join(cuda_build.CSRC, attention.BWD_SOURCE)
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(cuda_build.BUILD_DIR, "libmasked_attention_bwd_spans.so")
    run = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                          "-DMAB_SPANS", "-o", out, src],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if run.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{run.stdout}")
    return ctypes.CDLL(out)


def spans(lib, BH: int, N: int, mix: str, seed: int = 0) -> dict:
    """Thousands of cycles per tile and warpgroup in each phase, by role,
    for one call at (BH, N, N) in ``mix``."""
    fn = lib.masked_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong] * 9 + [ctypes.c_int] * 2 + [ctypes.c_float,
                                                       ctypes.c_void_p]
    fn.restype = ctypes.c_int
    read = lib.masked_attention_bwd_spans
    read.argtypes = [ctypes.c_void_p]
    read.restype = ctypes.c_int
    _fn, max_keys = attention._bind_bwd()
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v, gr = (torch.randn(BH, N, 64, generator=g) for _ in range(4))
    mask = torch.rand(BH, N, generator=g) > 0.3
    dev = torch.device("cuda")
    q, k, v = (t.to(dev, dt) for t, dt in zip((q, k, v), MIXES[mix]))
    mask, gr = mask.to(dev), gr.to(dev)
    counts = (ctypes.c_ulonglong * 16)()
    bind = attention._bind_bwd
    attention._bind_bwd = lambda: (fn, max_keys)
    try:
        attention.cuda_masked_attention_bwd(q, k, v, mask, gr)
        torch.cuda.synchronize()
        read(counts)
        attention.cuda_masked_attention_bwd(q, k, v, mask, gr)
        torch.cuda.synchronize()
        if read(counts) != 0:
            raise RuntimeError("reading the spans failed")
    finally:
        attention._bind_bwd = bind
    blocks = BH * -(-N // 128)   # of each role, per launch
    tiles = -(-N // 32)
    launches = attention.bwd_kernels_per_call(N, N)
    out = {}
    for role, name, passes in ((0, "key", 1), (1, "query", 2)):
        # query blocks stream the key tiles twice (pass 1 and pass 2), in
        # one launch or in two
        n_tiles = blocks * tiles * passes
        per = {}
        for i, phase in enumerate(PHASES):
            groups = 1 if phase.startswith("producer") else 2
            per[phase] = round(counts[role * 8 + i] / (groups * n_tiles) / 1e3,
                               3)
        out[name] = per
    return {"BH": BH, "N": N, "mix": mix, "launches": launches,
            "kcycles_per_tile": out}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+", default=["32x96", "4x2048"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bwd_spans needs an NVIDIA GPU")
    lib = build_spans_lib()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         stdout=subprocess.PIPE, text=True).stdout.strip())
    for shape in args.shapes:
        BH, N = (int(x) for x in shape.split("x"))
        for mix in MIXES:
            print(json.dumps(spans(lib, BH, N, mix)), flush=True)


if __name__ == "__main__":
    main()
