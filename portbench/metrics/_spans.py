"""Arithmetic of the readers of the port's own spans
(``simpleslam_tpu_torch/utils/profiling.py``): the records that the
program kept while the profiler recorded, which in a run are those of the
traced calls alone. A program without spans, or the reference in its
place, leaves no record, and each reader then reads None."""
from __future__ import annotations


def records():
    """The program's span records, or [] where it keeps none."""
    from simpleslam_tpu_torch.utils import profiling
    read = getattr(profiling, "spans", None)
    return read() if read is not None else []


def per_call_ms(run, name, clock):
    """The ``clock`` ms ("device" or "host") of the top-level records
    named ``name``, summed and divided by the traced calls; None where no
    such record has a reading on that clock."""
    vals = [r[clock + "_ms"] for r in records()
            if r["name"] == name and r["parent"] is None]
    if not vals or any(v is None for v in vals) or not run.get("calls"):
        return None
    return sum(vals) / run["calls"]
