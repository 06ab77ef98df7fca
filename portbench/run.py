"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Loads the cell (``workloads/<cell>.json``) and its configuration, sets up
its driver (weights, inputs, one warm call of every shape), measures for
``--seconds`` with calls back to back, and with ``--trace 1`` then traces
``trace_calls`` more calls under ``torch.profiler``. After the window it
reads the peak memory, frees the program's state, holds the outputs kept
from the window to the plain reference, and prints one JSON line last on
standard output; the numbers compared, each beside its limit, go last on
standard error. Exits 2 without a result where CUDA or the cell's cards
are missing, and 3 where a JAX module was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

from portbench import harness  # noqa: E402

CACHE = os.path.join(harness.ROOT, ".portbench_cache")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def trace_calls(torch, drv, device, n):
    """``n`` calls under the profiler: (reduced trace, host seconds,
    counter deltas, what the calls did)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(torch, device)
    before = drv.counters()
    first = len(drv.history)
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        for _i in range(n):
            drv.call()
        _sync(torch, device)
        seconds = time.perf_counter() - t
    after = drv.counters()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    work = drv.traced(first, n)
    red = harness.reduce_trace(trace, work["ranges"])
    if device.type == "cuda" and not red["kernels"]:
        raise RuntimeError("torch.profiler recorded no device operation")
    deltas = {k: after[k] - before[k] for k in after}
    return red, seconds, deltas, work


def main(argv=None, files=None, require_cuda=True, device=None,
         impl="port", out=None) -> int:
    out = out or sys.stdout
    a = parse(argv)
    files = files or harness.Files()
    cell = files.json("workloads", a.workload)
    cfg = files.json("configs", cell["config"])
    os.environ.update(USE_FLAX="0", USE_JAX="0",
                      TRITON_CACHE_DIR=os.path.join(CACHE, "triton"),
                      TORCH_EXTENSIONS_DIR=os.path.join(CACHE,
                                                        "torch_extensions"))
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if require_cuda and found < cell["chips"]:
        print(f"portbench: {a.workload} needs {cell['chips']} CUDA "
              f"device(s); found {found}", file=sys.stderr)
        return 2
    device = torch.device(device or "cuda:0")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    drv = files.module("drivers", cell["driver"]).Driver(
        cell, cfg, a.seed, device, impl)
    drv.setup()
    _sync(torch, device)
    setup_s = time.perf_counter() - T0

    calls = 0
    t = time.perf_counter()
    while time.perf_counter() - t < a.seconds:
        drv.call()
        calls += 1
    _sync(torch, device)
    window_s = time.perf_counter() - t
    print(f"portbench: set-up {setup_s:.3f} s; window {calls} calls in "
          f"{window_s:.3f} s", file=sys.stderr)

    per_layer, dev_extra, bd = {}, {}, None
    if a.trace:
        red, traced_s, deltas, work = trace_calls(torch, drv, device,
                                                  cell["trace_calls"])
        busy_s = red["busy_us"] / 1e6
        dev_extra = {"busy_s": busy_s, "window_s": traced_s}
        bd = harness.breakdown(red)
        run = {"cell": cell, "config": cfg, "trace": red,
               "window_s": traced_s, "busy_s": busy_s,
               "calls": cell["trace_calls"], "counters": deltas,
               **work}
        names = files.applicable(a.workload, "per_layer",
                                 reported_e2e=drv.end_to_end(1, 1.0))
        for name in names:
            m = files.module("metrics", name)
            v = m.read(run)
            if v is not None:
                per_layer[name] = {"value": v, "unit": m.UNIT}

    if device.type == "cuda":
        peak = max(torch.cuda.max_memory_allocated(d)
                   for d in range(cell["chips"]))
        kind = torch.cuda.get_device_name(device)
    else:
        peak, kind = 0, "cpu"
    e2e = dict(drv.end_to_end(calls, window_s), setup_s=setup_s)
    units = {"setup_s": "s"}
    units.update({k: f"{drv.unit}/s" for k in e2e if k != "setup_s"})
    attempted = drv.work(calls)
    drv.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    limits = cell["limits"]
    t = time.perf_counter()
    judged = drv.check()
    print(f"portbench: check {time.perf_counter() - t:.3f} s over "
          f"{len(judged)} units", file=sys.stderr)
    worst = {}
    failed_units = 0
    for _unit, readings in judged:
        bad = False
        for k, v in readings.items():
            worst[k] = max(worst.get(k, 0.0), float(v))
            bad |= k in limits and float(v) > limits[k]
        failed_units += bad
    for k in sorted(set(worst) - set(limits)):
        print(f"portbench: {k} {worst[k]!r} (not compared)", file=sys.stderr)
    checks = {k: {"value": worst.get(k, 0.0), "limit": limits[k]}
              for k in limits}
    correct = bool(judged) and all(c["value"] <= c["limit"]
                                   for c in checks.values())

    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: modules loaded that the port must not load: "
              f"{loaded}", file=sys.stderr)
        return 3

    if a.trace:
        metrics = per_layer
    else:
        names = files.applicable(a.workload, "end_to_end")
        metrics = {k: {"value": v, "unit": units[k]} for k, v in e2e.items()
                   if k in names}
    result = {"correct": correct, "attempted": attempted,
              "failed": failed_units,
              "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda"
                         else "cpu", "kind": kind, "count": cell["chips"],
                         "memory_peak_bytes": int(peak), **dev_extra}}
    if bd is not None:
        result["breakdown"] = bd
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
