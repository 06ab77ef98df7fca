"""Arithmetic that several per-layer readers share."""
from __future__ import annotations

import sys

from portbench import harness
from portbench.flops import counts


def range_ms(run, name):
    """Device ms a call of the operations launched inside the benchmark's
    range ``name``; None where the run has no such range."""
    calls = run.get("range_calls", {}).get(name)
    if not calls:
        return None
    return 1e3 * harness.range_busy_s(run["trace"], name) / calls


def idle_pct(run):
    """The share of the traced window with no device operation running."""
    if run["window_s"] <= 0 or not run["trace"]["kernels"]:
        return None
    return 100.0 * (1.0 - run["busy_s"] / run["window_s"])


def mfu_pct(run):
    """Model operations of the traced calls over the traced window's
    seconds, as a share of the card's bfloat16 dense peak."""
    if not run.get("model_ops") or not run["trace"]["kernels"]:
        return None
    return 100.0 * run["model_ops"] / run["window_s"] \
        / counts.peaks()["flops_per_s"]


def roofline_pct(run, calls_key, counter, pattern, exclude=None):
    """The attention calls' least time on the card (the larger of their
    operations over the peak rate and their bytes over the peak bandwidth)
    over the summed device time of the kernel's own entries, in %. None
    where the run made no such call, or where the calls counted from shapes
    differ from the program's launch counter or the trace lacks entries."""
    calls = run.get(calls_key)
    if not calls:
        return None
    entries, seconds = harness.kernel_time_s(run["trace"], pattern, exclude)
    launches = run["counters"].get(counter)
    if launches != len(calls) or entries < len(calls) or seconds <= 0:
        print(f"portbench: {calls_key}: {len(calls)} calls counted, "
              f"{launches} launched, {entries} trace entries",
              file=sys.stderr)
        return None
    pk = counts.peaks()
    ops = sum(c[0] for c in calls)
    byt = sum(c[1] for c in calls)
    return 100.0 * max(ops / pk["flops_per_s"], byt / pk["bytes_per_s"]) \
        / seconds
