"""The port's spans (``utils/profiling.py``): nothing but one shared object
while no profiler records; records with parents, host times and a
``record_function`` range while one does; the names that the models, the
training steps, the stage timer and the CLI's ``--trace_dir`` give."""
import glob
import json
import os
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from simpleslam_tpu_torch.models import aliked as aliked_mod
from simpleslam_tpu_torch.models import lightglue as lg_mod
from simpleslam_tpu_torch.models import train as train_mod
from simpleslam_tpu_torch.utils import profiling
from simpleslam_tpu_torch.utils.profiling import (StageTimer, clear_spans,
                                                  span, span_totals, spans)

HW = (64, 96)


@pytest.fixture(autouse=True)
def _empty_store():
    clear_spans()
    yield
    clear_spans()


def _recording():
    return profile(activities=[ProfilerActivity.CPU])


def _top(recs):
    return [r["name"] for r in recs if r["parent"] is None]


def test_span_off_is_one_shared_object_that_records_nothing(monkeypatch):
    def no_range(name):
        raise AssertionError(f"record_function({name!r}) while off")

    monkeypatch.setattr(profiling, "record_function", no_range)
    assert span("a") is span("b")
    with span("a"):
        with span("b"):
            pass
    assert spans() == [] and span_totals() == {}


def test_span_on_records_parents_host_times_and_trace_ranges(tmp_path):
    with _recording() as prof:
        with span("outer"):
            with span("inner"):
                torch.ones(8).sum()
            with span("inner2"):
                pass
        def other():
            with span("other"):
                pass

        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    recs = spans()
    assert [r["name"] for r in recs] == ["outer", "inner", "inner2",
                                         "other"]
    outer, inner, inner2, other = recs
    assert outer["parent"] is None and outer["root"] == outer["index"] == 0
    assert inner["parent"] == inner2["parent"] == 0
    assert inner["root"] == inner2["root"] == 0
    # another thread's span has no parent here: its own stack is empty
    assert other["parent"] is None and other["thread"] != outer["thread"]
    for r in (inner, inner2):
        assert outer["host_start_ns"] <= r["host_start_ns"] \
            <= r["host_end_ns"] <= outer["host_end_ns"]
    assert all(r["device_ms"] is None for r in recs)      # no CUDA here
    assert span_totals(recs[:3]) == {
        r["name"]: {"count": 1, "host_ms": r["host_ms"], "device_ms": None}
        for r in recs[:3]}
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        ann = {e["name"] for e in json.load(f)["traceEvents"]
               if e.get("cat") == "user_annotation"}
    assert {"outer", "inner", "inner2"} <= ann
    clear_spans()
    assert spans() == []


def test_stage_timer_counts_and_emits_stage_spans():
    timer = StageTimer()
    with timer.stage("extract"):
        pass
    assert spans() == []
    with _recording():
        with timer.stage("extract"):
            with timer.stage("track"):
                pass
    assert timer.counts == {"extract": 2, "track": 1}
    assert timer.totals["extract"] >= timer.totals["track"] >= 0.0
    recs = spans()
    assert [(r["name"], r["parent"]) for r in recs] == [
        ("stage.extract", None), ("stage.track", 0)]


def test_extract_and_match_batch_give_their_spans_once_each():
    g = torch.Generator().manual_seed(3)
    a = aliked_mod.init_aliked(g, desc_dim=16)
    lg = lg_mod.init_lightglue(g, desc_dim=16, dim=32, heads=2, n_layers=1)
    imgs = torch.rand((3, *HW, 1), generator=g)
    with _recording():
        f = aliked_mod.extract_batch(a, imgs, 32)
        lg_mod.match_batch(lg, f.map(lambda t: t[:-1]),
                           f.map(lambda t: t[1:]), HW, 0.0)
    recs = spans()
    assert _top(recs) == ["aliked.forward", "aliked.dkd",
                          "lightglue.forward", "lightglue.assign"]
    assert len(recs) == 4 and all(r["host_ms"] > 0 for r in recs)


@pytest.mark.parametrize("sharded", [False, True])
def test_train_step_gives_forward_backward_optimizer(sharded):
    g = torch.Generator().manual_seed(5)
    tx, state = train_mod.make_train_state(g, device="cpu", desc_dim=16,
                                           dim=32, n_layers=1)
    batch = train_mod.synthetic_pair_batch(g, 2, *HW, 16)
    batch = {k: v for k, v in batch.items() if k != "Hmats"}
    if sharded:            # a one-rank gloo group
        import torch.distributed as dist
        from simpleslam_tpu_torch.parallel.mesh import make_mesh
        try:
            mesh = make_mesh()
            state = train_mod.shard_train_state(state, mesh)
            step = train_mod.make_sharded_train_step(tx, HW, mesh)
            with _recording():
                step(state, batch)
        finally:
            dist.destroy_process_group()
    else:
        step = train_mod.make_train_step(tx, HW)
        with _recording():
            step(state, batch)
    recs = spans()
    assert _top(recs) == ["train.forward", "train.backward",
                          "train.optimizer"]
    fwd = recs[0]["index"]
    assert [r["name"] for r in recs if r["parent"] == fwd] == [
        "aliked.forward", "aliked.forward", "lightglue.forward"]
    assert len(recs) == 6


def test_run_slam_trace_dir_writes_a_trace_and_a_span_summary(
        tmp_path, monkeypatch):
    from simpleslam_tpu_torch import run_slam
    from simpleslam_tpu_torch.tools.synth import generate_kitti_sequence
    monkeypatch.chdir(tmp_path)
    base = str(tmp_path / "seq")
    generate_kitti_sequence(base, n_frames=6, seed=2, hw=(128, 256),
                            device="cpu")
    argv = ["--dataset", "kitti", "--base_dir", base, "--headless",
            "--no_viz3d", "--max_features", "256", "--fused",
            "--device", "cpu"]
    out = tmp_path / "tr"
    results = []
    assert run_slam.main(argv + ["--trace_dir", str(out)],
                         results=results) == 0
    assert results[0].n_frames == 6
    (trace,) = glob.glob(str(out / "trace_*.json"))
    (summary,) = glob.glob(str(out / "spans_*.json"))
    assert os.path.basename(trace)[len("trace_"):] == \
        os.path.basename(summary)[len("spans_"):]
    with open(trace) as f:
        ann = {e["name"] for e in json.load(f)["traceEvents"]
               if e.get("cat") == "user_annotation"}
    assert {"stage.fused_dispatch", "fused.detect", "fused.track",
            "fused.keyframe", "fused.read.track"} <= ann
    with open(summary) as f:
        got = json.load(f)
    assert set(got) == {"totals", "spans"}
    tot = got["totals"]
    # the host bootstraps on frames 0-1, the fused step takes frames 2-5
    assert tot["stage.fused_dispatch"]["count"] == 4
    for name in ("fused.detect", "fused.track", "fused.keyframe",
                 "fused.read.track"):
        assert tot[name]["count"] == 4, name
    assert sum(r["name"] == "fused.detect" for r in got["spans"]) == 4
