"""Per-stage wall-clock accounting for the host-side pipeline, spans that
mark the port's layers in a ``torch.profiler`` trace, and a trace context
(the counterpart of the JAX package's ``jax_trace``).

``with span("aliked.dkd"): ...`` costs one flag check while no profiler
records. While one does, the span opens a ``record_function`` range of its
name (so it lies in the Chrome trace beside the device operations, on the
profiler's clock) and keeps a record in memory: its name, the enclosing
span on the same thread, the host clock at entry and exit and, where CUDA
is initialised, a pair of timing events on the current stream. Nothing
synchronises: :func:`spans` reads the events when asked, after the caller
has synchronised.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function


class _NoSpan:
    """A span while no profiler records: enters and exits, nothing else."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()
_RECORDS: List[dict] = []         # what the spans recorded, in entry order
_LOCK = threading.Lock()
_LOCAL = threading.local()        # .stack: (index, root) of the open spans


class _Span:
    __slots__ = ("name", "rec", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        rec = {"name": self.name, "thread": threading.get_ident()}
        with _LOCK:
            idx = len(_RECORDS)
            _RECORDS.append(rec)
        rec["index"] = idx
        rec["parent"], rec["root"] = stack[-1] if stack else (None, idx)
        stack.append((idx, rec["root"]))
        self.rec = rec
        self.range = record_function(self.name)
        self.range.__enter__()
        events = None
        if torch.cuda.is_initialized():
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        rec["_events"] = events
        rec["host_start_ns"] = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        rec = self.rec
        rec["host_end_ns"] = time.perf_counter_ns()
        if rec["_events"] is not None:
            rec["_events"][1].record()
        self.range.__exit__(*exc)
        _LOCAL.stack.pop()
        return False


def span(name: str):
    """A context manager marking one layer's work as ``name`` (see the
    module's docstring); the same no-op object while no profiler records."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name)


def spans() -> List[dict]:
    """The records, in entry order: ``index``, ``name``, ``parent`` and
    ``root`` (indices; ``parent`` None at the top), ``thread``,
    ``host_start_ns``, ``host_end_ns``, ``host_ms`` and ``device_ms``:
    the stream's time from reaching the span's start to the end of its
    last operation (None without CUDA). Waits for each span's last
    operation."""
    out = []
    with _LOCK:
        recs = list(_RECORDS)
    for rec in recs:
        r = {k: v for k, v in rec.items() if k != "_events"}
        end = rec.get("host_end_ns")
        r["host_ms"] = None if end is None \
            else (end - rec["host_start_ns"]) / 1e6
        ev = rec.get("_events")
        r["device_ms"] = None
        if ev is not None and end is not None:
            ev[1].synchronize()
            r["device_ms"] = ev[0].elapsed_time(ev[1])
        out.append(r)
    return out


def span_totals(records: Optional[List[dict]] = None) -> Dict[str, dict]:
    """{name: {"count", "host_ms", "device_ms"}} summed over the records
    (``device_ms`` None where no record of the name has device time)."""
    tot: Dict[str, dict] = {}
    for r in spans() if records is None else records:
        t = tot.setdefault(r["name"], {"count": 0, "host_ms": 0.0,
                                       "device_ms": None})
        t["count"] += 1
        t["host_ms"] += r["host_ms"] or 0.0
        if r["device_ms"] is not None:
            t["device_ms"] = (t["device_ms"] or 0.0) + r["device_ms"]
    return tot


def clear_spans() -> None:
    """Forget every record."""
    with _LOCK:
        _RECORDS.clear()


class StageTimer:
    """Accumulates wall-clock seconds per named pipeline stage.

    Use ``with timer.stage("extract"): ...``. Device work is asynchronous:
    the time is what the host waited, which includes device time only where
    the stage ends by reading a result back. While a profiler records, each
    stage is also the span ``stage.<name>``.
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with span("stage." + name):
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
    CUDA is there, device activity) when a directory is given, and write
    to ``log_dir`` a Chrome trace ``trace_<pid>_<ms>.json`` (open in
    Perfetto or chrome://tracing) and beside it ``spans_<pid>_<ms>.json``,
    the block's spans (``{"totals": span_totals(), "spans": spans()}``);
    the span records are cleared on entry. Do nothing without a
    directory."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    clear_spans()
    with profile(activities=acts) as prof:
        yield
    stamp = f"{os.getpid()}_{int(time.time() * 1e3)}"
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{stamp}.json"))
    recs = spans()
    with open(os.path.join(log_dir, f"spans_{stamp}.json"), "w") as f:
        json.dump({"totals": span_totals(recs), "spans": recs}, f)
