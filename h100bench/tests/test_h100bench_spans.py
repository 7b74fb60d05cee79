"""The metrics of the port's own spans and counters (``metrics/*_host_ms``,
``syncs_per_frame``, ``sync_wait_ms``, read through ``spans.py``): a tiny
``--trace 1`` run of each cell form on the CPU reports each of them, a
positive value, in exactly the cells its entry lists; a program without
the recorder, or a record without a traced stretch, gives None."""

import json
import os

import pytest

from h100bench import run, spans
from h100bench.tests import tiny

CELLS = ("ns512.chunk16", "ns512.step", "ref256.stage2", "ref256.stage1")
NEW = ("detect_host_ms", "label_host_ms", "associate_host_ms",
       "fuse_host_ms", "render_host_ms", "upload_host_ms",
       "syncs_per_frame", "sync_wait_ms")

with open(os.path.join(tiny.ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
ENTRY = {m["name"]: m for m in BENCH["per_layer"]}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_tree(str(tmp_path_factory.mktemp("tiny")))


@pytest.mark.parametrize("cell", CELLS)
def test_new_metrics_read_in_their_cells(root, cell):
    out = run.run(cell, 2 ** 32 + 5, 0.5, True, root=root, device="cpu")
    assert out["correct"]
    for name in NEW:
        listed = cell in ENTRY[name]["workloads"]
        assert (name in out["metrics"]) == listed, name
        if listed:
            assert out["metrics"][name]["value"] > 0, name
            assert out["metrics"][name]["unit"] == ENTRY[name]["unit"]


def test_entries_are_appended_whole():
    names = [m["name"] for m in BENCH["per_layer"]]
    assert names[-len(NEW):] == list(NEW)
    for name in NEW:
        m = ENTRY[name]
        assert m["moves"] == "frames_per_s" and m["better"] == "lower"
        assert m["source"] in ("program_span", "program_counter")


def test_readers_give_none_without_the_recorder(monkeypatch):
    from slam_maskrcnn_tpu_torch.utils import profiling

    ses = profiling.Session()
    record = dict(trace_frames=4)
    monkeypatch.setattr(profiling, "last_session", lambda: ses)
    assert spans.host_ms(record, ("detect",)) is None     # no such span
    assert spans.counted(record, "sync.") == 0
    assert spans.session(dict(trace_frames=0)) is None    # no stretch
    monkeypatch.delattr(profiling, "last_session")        # the parent
    for name in NEW:
        mod = run.load_module(os.path.join(tiny.BENCH, "metrics",
                                           name + ".py"), "m_" + name)
        assert mod.read(record) is None, name
