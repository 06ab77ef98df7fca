"""Per-stage wall-clock accounting for the host-side pipeline."""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict


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
