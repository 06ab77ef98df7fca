"""The harness finds cells, configurations and metrics by name, the
benchmark's files agree with ``BENCHMARK.json``, and the result line has
the contract's keys."""
import json
import os

import portbench_tiny as tiny
from portbench import harness

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_new_config_cell_and_metric_are_found_by_name(tmp_path):
    f = tiny.files(tmp_path, bench={
        "end_to_end": [{"name": "pairs_per_s"}, {"name": "setup_s"}],
        "per_layer": [{"name": "zz_calls", "moves": "pairs_per_s",
                       "workloads": ["tiny.pairs"]}]})
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "zz_calls.py").write_text(
        'NAME, UNIT, SOURCE = "zz_calls", "calls", "program_counter"\n'
        'LAYER, MOVES = "device", "pairs_per_s"\n'
        'def read(run):\n    return float(run["calls"])\n')
    rc, line = tiny.run_cell(f, "tiny.pairs", trace=1)
    assert rc == 0
    assert line["metrics"] == {"zz_calls": {"value": 1.0, "unit": "calls"}}
    rc, line = tiny.run_cell(f, "tiny.pairs", trace=0)
    assert rc == 0 and set(line["metrics"]) == {"pairs_per_s", "setup_s"}


def test_result_line_has_the_contracts_keys(tmp_path):
    f = tiny.files(tmp_path)
    for trace in (0, 1):
        rc, line = tiny.run_cell(f, "tiny.pairs", trace=trace)
        assert rc == 0
        keys = list(line)
        assert keys[:5] == RESULT_KEYS and keys[-1] == "checks"
        assert set(keys) == set(RESULT_KEYS) | {"checks"} | (
            {"breakdown"} if trace else set())
        dev = set(line["device"])
        assert {"platform", "kind", "count", "memory_peak_bytes"} <= dev
        assert ({"busy_s", "window_s"} <= dev) == bool(trace)
        for c in line["checks"].values():
            assert set(c) == {"value", "limit"}
        if trace:
            assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_benchmark_json_names_files_that_agree_with_it():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    f = harness.Files()
    for c in bench["configs"]:
        assert os.path.relpath(f.path("configs", c["name"], ".json"),
                               harness.ROOT) == c["file"]
        assert f.json("configs", c["name"])["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        cell = f.json("workloads", w["name"])
        assert (cell["config"], cell["chips"], cell["why"]) == \
            (w["config"], w["chips"], w["why"])
        f.module("drivers", cell["driver"])
    for m in bench["per_layer"]:
        mod = f.module("metrics", m["name"])
        assert (mod.NAME, mod.UNIT, mod.LAYER, mod.MOVES, mod.SOURCE) == \
            (m["name"], m["unit"], m["layer"], m["moves"], m["source"])
    assert sorted(m["name"] for m in bench["per_layer"]) == \
        f.metric_names()
