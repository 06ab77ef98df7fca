"""The readers of the port's own spans: the host-clock metrics in a traced
tiny cell on the CPU, nothing where the store is empty or has no device
time, and on the card the spans' device time against the traced window."""
import io
import json

import pytest

import portbench_tiny as tiny
from portbench import harness, run
from simpleslam_tpu_torch.utils import profiling

PAIRS = ["aliked_ms.pairs", "dkd_ms.pairs", "dkd_host_ms.pairs",
         "lightglue_ms.pairs", "assign_ms.pairs", "assign_host_ms.pairs"]
TRAIN = ["forward_ms.train", "backward_ms.train", "optimizer_ms.train"]


@pytest.fixture(autouse=True)
def _empty_store():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _bench(pairs_cell, train_cell):
    real = harness.Files().bench["per_layer"]
    cell = {n: pairs_cell for n in PAIRS}
    cell.update({n: train_cell for n in TRAIN})
    return [dict(m, workloads=[cell[m["name"]]]) for m in real
            if m["name"] in cell]


def test_a_traced_tiny_cell_reports_the_host_clock_spans(tmp_path):
    f = tiny.files(tmp_path, bench={
        "end_to_end": [{"name": "pairs_per_s"}, {"name": "setup_s"}],
        "per_layer": _bench("tiny.pairs", "tiny.train")})
    rc, line = tiny.run_cell(f, "tiny.pairs", trace=1)
    assert rc == 0 and line["correct"]
    # the CPU has no stream to time: the device readings are left out
    assert sorted(line["metrics"]) == ["assign_host_ms.pairs",
                                       "dkd_host_ms.pairs"]
    for m in line["metrics"].values():
        assert m["unit"] == "ms" and m["value"] > 0
    profiling.clear_spans()
    rc, line = tiny.run_cell(f, "tiny.train", trace=1)
    assert rc == 0 and line["correct"] and line["metrics"] == {}
    names = [r["name"] for r in profiling.spans() if r["parent"] is None]
    assert names == ["train.forward", "train.backward", "train.optimizer"]


def test_the_readers_read_none_without_records(monkeypatch):
    f = harness.Files()
    run_ = {"calls": 3}
    for name in PAIRS + TRAIN:
        assert f.module("metrics", name).read(run_) is None
    # records with no device time leave the device readers empty
    from portbench.metrics import _spans
    monkeypatch.setattr(_spans, "records", lambda: [
        {"name": "aliked.dkd", "parent": None, "host_ms": 6.0,
         "device_ms": None},
        {"name": "aliked.dkd", "parent": None, "host_ms": 3.0,
         "device_ms": None},
        {"name": "aliked.forward", "parent": 7, "host_ms": 1.0,
         "device_ms": 2.0}])
    assert f.module("metrics", "dkd_host_ms.pairs").read(run_) == 3.0
    assert f.module("metrics", "dkd_ms.pairs").read(run_) is None
    # only top-level records count
    assert f.module("metrics", "aliked_ms.pairs").read(run_) is None


@pytest.mark.cuda
@pytest.mark.parametrize("cell, names", [
    ("lightglue-kitti-2048.pairs-b32", PAIRS),
    ("lightglue-train-2048.b16", TRAIN)])
def test_span_device_time_fills_the_traced_window(cuda, cell, names):
    """The spans' device ms sum to 80-100% of the traced ms a call: less
    means a span misses work, more that it counts work twice."""
    buf = io.StringIO()
    rc = run.main(["--workload", cell, "--seed", str(2**31 + 77),
                   "--seconds", "2", "--trace", "1"], out=buf)
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert rc == 0 and line["correct"]
    got = line["metrics"]
    assert set(names) <= set(got)
    calls = harness.Files().json("workloads", cell)["trace_calls"]
    per_call = 1e3 * line["device"]["window_s"] / calls
    device = sum(got[n]["value"] for n in names if "_host_" not in n)
    print(f"{cell}: spans {device:.2f} ms of {per_call:.2f} ms a call")
    assert 0.8 * per_call <= device <= per_call
