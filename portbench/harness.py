"""What every cell shares: finding a cell's files by name, the module
check, the reduction of a profiler trace, and the result line."""
from __future__ import annotations

import collections
import importlib.util
import json
import os
import re
import sys

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
FORBIDDEN = ("jax", "jaxlib", "flax", "simpleslam_tpu")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Files:
    """A cell's files, looked up by name in each of ``dirs`` in turn (the
    package first unless a caller says otherwise): ``configs/<n>.json``,
    ``workloads/<n>.json``, ``drivers/<n>.py``, ``metrics/<n>.py``.
    ``bench`` is the parsed ``BENCHMARK.json`` (read from the checkout's
    root when not given)."""

    def __init__(self, dirs=(PKG,), bench=None):
        self.dirs = list(dirs)
        if bench is None:
            with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
                bench = json.load(f)
        self.bench = bench

    def path(self, sub: str, name: str, ext: str) -> str:
        for d in self.dirs:
            p = os.path.join(d, sub, name + ext)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(f"no {sub}/{name}{ext} under {self.dirs}")

    def json(self, sub: str, name: str) -> dict:
        with open(self.path(sub, name, ".json")) as f:
            return json.load(f)

    def module(self, sub: str, name: str):
        path = self.path(sub, name, ".py")
        mod_name = "portbench_" + sub + "_" + re.sub(r"\W", "_", name)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def metric_names(self):
        names = set()
        for d in self.dirs:
            sub = os.path.join(d, "metrics")
            if os.path.isdir(sub):
                names |= {f[:-3] for f in os.listdir(sub)
                          if f.endswith(".py") and not f.startswith("_")}
        return sorted(names)

    def applicable(self, cell: str, kind: str, reported_e2e=()):
        """Names of the ``kind`` ("end_to_end" or "per_layer") metrics that
        ``cell`` reports: those that list it, and those that list no cells
        and (per-layer) move a metric the cell reports."""
        out = []
        for m in self.bench.get(kind, []):
            if "workloads" in m:
                if cell in m["workloads"]:
                    out.append(m["name"])
            elif kind == "end_to_end" or m.get("moves") in reported_e2e:
                out.append(m["name"])
        return out


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name (before the first dot) is one of
    :data:`FORBIDDEN`, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


# --------------------------------------------------------------------------- #
# Trace reduction
# --------------------------------------------------------------------------- #

def union_us(intervals):
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def innermost(events, times):
    """{t: the name of the innermost of the nested host intervals
    ``events`` that contains t, or None} for each time in ``times``."""
    ivs = sorted((e["ts"], e["ts"] + e.get("dur", 0.0), e["name"])
                 for e in events)
    out, stack, i = {}, [], 0
    for t in sorted(set(times)):
        while i < len(ivs) and ivs[i][0] <= t:
            while stack and stack[-1][0] < ivs[i][0]:
                stack.pop()
            stack.append((ivs[i][1], ivs[i][2]))
            i += 1
        while stack and stack[-1][0] < t:
            stack.pop()
        out[t] = stack[-1][1] if stack else None
    return out


def reduce_trace(trace: dict, ranges=()):
    """A Chrome trace (``torch.profiler``'s export) -> the device's work:

    * ``kernels``: [(name, start us, end us, range)] of every device
      operation, ``range`` the benchmark's innermost named range (one of
      ``ranges``) around the host call that launched it (a device
      operation whose launch is not in the trace takes the range of the
      operation before it on its stream);
    * ``busy_us``: the union of their intervals;
    * ``gaps``: [(us, what the host was doing)] of the device's idle gaps,
      each named by the range and host operation that launched the
      operation ending it.
    """
    evs = trace.get("traceEvents", trace) if isinstance(trace, dict) \
        else trace
    evs = [e for e in evs if e.get("ph") == "X"]
    dev = [e for e in evs if e.get("cat") in DEVICE_CATS]
    launch = {}
    for e in evs:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch[corr] = e["ts"]
    times = list(launch.values())
    ann = innermost([e for e in evs if e.get("cat") == "user_annotation"
                     and e["name"] in ranges], times)
    ops = innermost([e for e in evs if e.get("cat") == "cpu_op"], times)
    kernels, last = [], {}
    for e in sorted(dev, key=lambda e: e["ts"]):
        t = launch.get(e.get("args", {}).get("correlation"))
        stream = e.get("args", {}).get("stream", e.get("tid"))
        rng = ann[t] if t is not None else last.get(stream)
        last[stream] = rng
        kernels.append((e["name"], e["ts"], e["ts"] + e.get("dur", 0.0),
                        rng, t))
    busy = union_us([(k[1], k[2]) for k in kernels])
    gaps, end = [], None
    for k in kernels:
        if end is not None and k[1] > end:
            what = ops[k[4]] if k[4] is not None else None
            gaps.append((k[1] - end, f"{k[3] or '-'}/{what or '-'}"))
        end = k[2] if end is None else max(end, k[2])
    return {"kernels": [k[:4] for k in kernels], "busy_us": busy,
            "gaps": gaps}


def breakdown(reduced, top: int = 10):
    """The device operations that took most time and the longest idle
    gaps by what the host was doing: {"device_ops": [[name, s]],
    "idle_gaps": [[name, s]]}, at most ``top`` each."""
    by_op = collections.Counter()
    for name, s, e, _r in reduced["kernels"]:
        by_op[name[:160]] += (e - s) / 1e6
    by_gap = collections.Counter()
    for us, what in reduced["gaps"]:
        by_gap[what[:160]] += us / 1e6
    return {"device_ops": [[n, v] for n, v in by_op.most_common(top)],
            "idle_gaps": [[n, v] for n, v in by_gap.most_common(top)]}


def kernel_time_s(reduced, pattern, exclude=None):
    """(entries, seconds) of device operations whose name holds
    ``pattern`` (and not ``exclude``)."""
    hits = [(s, e) for n, s, e, _r in reduced["kernels"]
            if pattern in n and (exclude is None or exclude not in n)]
    return len(hits), sum(e - s for s, e in hits) / 1e6


def range_busy_s(reduced, name):
    """Device seconds (union) of the operations launched inside the
    benchmark's range ``name``."""
    return union_us([(s, e) for _n, s, e, r in reduced["kernels"]
                     if r == name]) / 1e6
