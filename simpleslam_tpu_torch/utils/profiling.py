"""Per-stage wall-clock accounting for the host-side pipeline, and a
``torch.profiler`` trace context (the counterpart of the JAX package's
``jax_trace``)."""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional


class StageTimer:
    """Accumulates wall-clock seconds per named pipeline stage.

    Use ``with timer.stage("extract"): ...``. Device work is asynchronous:
    the time is what the host waited, which includes device time only where
    the stage ends by reading a result back.
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def fps(self, name: str) -> float:
        t = self.totals.get(name, 0.0)
        return self.counts.get(name, 0) / t if t > 0 else 0.0

    def report(self) -> str:
        rows = []
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            t, n = self.totals[name], self.counts[name]
            rows.append(f"{name:<22s} {t:8.3f}s  {n:5d} calls "
                        f"{1e3 * t / max(n, 1):8.2f} ms/call "
                        f"{self.fps(name):8.2f} /s")
        return "\n".join(rows)


@contextlib.contextmanager
def torch_trace(log_dir: Optional[str]):
    """Record a ``torch.profiler`` trace of the block (host and, where
    CUDA is there, device activity) and write it to ``log_dir`` as a
    Chrome trace (open in Perfetto or chrome://tracing) when a directory
    is given; do nothing otherwise."""
    if not log_dir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))
