"""Every configuration, cell and metric BENCHMARK.json names loads by
name; adding a cell and a metric is adding files."""

import json
import os

import pytest

from h100bench import run
from h100bench.tests import tiny

with open(os.path.join(tiny.ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_loads(c):
    cfg = run.read_json(tiny.ROOT, c["file"])
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    for k in c["reduced"]:
        assert k in cfg["detector"] or k in cfg["fusion"]
    assert {"detector", "fusion", "camera", "weights", "assumed"} <= set(cfg)


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_loads(w):
    cell = run.read_json(tiny.BENCH, "workloads", w["name"] + ".json")
    assert cell["config"] == w["config"] and cell["chips"] == w["chips"]
    drv = run.load_module(os.path.join(tiny.BENCH, "drivers",
                                       cell["driver"] + ".py"), "d")
    assert hasattr(drv, "Driver")
    names = [m["name"] for m in run.cell_metrics(BENCH, w["name"], False)]
    assert "setup_s" in names and len(names) >= 2
    assert run.cell_metrics(BENCH, w["name"], True)


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_loads(m):
    mod = run.load_module(os.path.join(tiny.BENCH, "metrics",
                                       m["name"] + ".py"), "m")
    assert callable(mod.read)
    for cell in m.get("workloads", []):
        assert any(w["name"] == cell for w in BENCH["workloads"])


def test_added_cell_and_metric_are_files_only(tmp_path):
    """A new cell (a workload file on an existing driver form) and a new
    per-layer metric (a reader file), each with its BENCHMARK.json entry,
    run in a copy with no harness file edited."""
    root = tiny.make_tree(str(tmp_path))
    wl = os.path.join(root, "h100bench", "workloads")
    cell = run.read_json(wl, "ns512.step.json")
    cell["render"] = "instance"
    with open(os.path.join(wl, "ns512.step_render.json"), "w") as f:
        json.dump(cell, f)
    with open(os.path.join(root, "h100bench", "metrics",
                           "calls_per_s.py"), "w") as f:
        f.write("def read(record):\n"
                "    return len(record['call_ms']) / record['window_s']\n")
    bench = dict(BENCH)
    bench["workloads"] = BENCH["workloads"] + [dict(
        name="ns512.step_render", config="north_star_r101_512",
        traffic="step_render", chips=1, why="a render in the step")]
    bench["per_layer"] = BENCH["per_layer"] + [dict(
        name="calls_per_s", unit="1/s", better="higher",
        source="host_clock", layer="Device, H100", moves="frames_per_s",
        workloads=["ns512.step_render"])]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    out = run.run("ns512.step_render", 5, 0.5, True, root=root,
                  device="cpu")
    assert out["correct"] and out["metrics"]["calls_per_s"]["value"] > 0
