"""The port's spans and counters (utils/profiling.py), on the CPU.

* With no profiler the recorder stamps and keeps nothing: ``span`` and
  ``sync`` return the one shared null context, and a whole step leaves no
  session and no ``sync.*`` counter behind.
* Under a CPU-activity profiler, a tiny ``NorthStar.step``,
  ``run_chunk_paired``, ``SemanticFusion.parse_frame`` and
  ``batch_mask_process`` each record one root with the span tree the
  port names, one call id, parents that hold their children, and the
  chunk's frame indices.
* Each span's host stamps fall on its own ``record_function`` event of the
  profiler's trace: inside the event's interval (the span enters the event
  before it stamps its start and stamps its end before it leaves), and a
  call's spans sit within 50 us of their events' ends at the median.
* ``Trainer.steps`` records one ``train_step`` root a step with its
  children (the batch, the upload, the training forward and its
  sub-layers, the loss, the backward pass, the optimizer) and marks
  "upload", "forward", "backward" and "optimizer", one clip read-back
  (``sync.train.clip``) and one loss read-back a step.
* The stage marks of ``step`` and the chunk forms are the ones the
  benchmark's per-layer metrics read, name for name, in order.
* Each ``sync.<site>`` counter counts its site once a pass: it equals the
  ``sync:<site>`` spans, and the known sites count what they should.
* ``kernels.launches`` keeps its counts, ``add`` and ``reset``, always on.
* ``last_session()`` holds the newest session only; ``idle_gaps`` names a
  device gap by the innermost span that holds it.
"""

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from slam_maskrcnn_tpu_torch import kernels
from slam_maskrcnn_tpu_torch.data.png import write_png
from slam_maskrcnn_tpu_torch.data.shapes import ShapesConfig, ShapesDataset
from slam_maskrcnn_tpu_torch.data.synthetic import (default_scene,
                                                    make_sequence)
from slam_maskrcnn_tpu_torch.fusion.fuse import init_from_first_frame
from slam_maskrcnn_tpu_torch.fusion.pipeline import SemanticFusion
from slam_maskrcnn_tpu_torch.fusion.state import FusionConfig, make_intrinsic
from slam_maskrcnn_tpu_torch.models import mask_ops
from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
from slam_maskrcnn_tpu_torch.samples.north_star import NorthStar
from slam_maskrcnn_tpu_torch.samples.train_shapes import (
    InferenceShapesConfig, detect_scenes)
from slam_maskrcnn_tpu_torch.train.trainer import Trainer
from slam_maskrcnn_tpu_torch.utils import profiling

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINED = os.path.join(REPO, "weights", "shapes_r2_f16.h5")
H, W = 96, 128
K4 = make_intrinsic(100.0, 100.0, W / 2, H / 2)
VOL = (32,) * 3

DETECT = {"detect": None, "mold": "detect", "backbone": "detect",
          "rpn": "detect", "proposals": "detect", "heads": "detect",
          "mask_head": "detect"}
FUSE = {"probe": None, "associate": None, "relabel": None, "fuse": None}
TRAIN_FORWARD = {k: "train_forward" for k in (
    "backbone", "rpn", "proposals", "targets", "roi_align", "heads",
    "mask_head")}


class F32(InferenceShapesConfig):
    COMPUTE_DTYPE = "float32"
    POST_NMS_ROIS_INFERENCE = 100


class TrainF32(ShapesConfig):
    IMAGES_PER_GPU = 2
    TRAIN_ROIS_PER_IMAGE = 16
    POST_NMS_ROIS_TRAINING = 64
    PRE_NMS_LIMIT = 256
    MAX_GT_INSTANCES = 4
    COMPUTE_DTYPE = "float32"


@pytest.fixture(scope="module")
def model():
    return MaskRCNN("inference", F32(), device="cpu").load_weights(TRAINED)


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    frames = make_sequence(default_scene(), K4, H, W, n_frames=6)
    e0i = np.linalg.inv(frames[0]["extrinsic"]).astype(np.float32)
    return dict(
        tmp=str(tmp_path_factory.mktemp("spans")), frames=frames,
        depth=torch.stack([torch.from_numpy(f["depth"])
                           for f in frames[1:]]),
        color=torch.stack([torch.from_numpy(f["color"])
                           for f in frames[1:]]),
        e2i=np.stack([(f["extrinsic"] @ e0i).astype(np.float32)
                      for f in frames[1:]]),
        angle=np.array([0.01 * (i + 1) for i in range(5)], np.float32))


def _volume(cfg, seq):
    f0 = seq["frames"][0]
    return init_from_first_frame(cfg, f0["depth"], K4, f0["mean_depth"],
                                 device="cpu")


def _step(model, seq, mark=None):
    cfg = FusionConfig(vol_dim=VOL, probe_mode="depth")
    ns = NorthStar(model, K4, cfg, H, W, render_mode="none")
    st = _volume(cfg, seq)
    st, *_ = ns.step(st, seq["depth"][0], seq["color"][0], seq["e2i"][0],
                     seq["angle"][0], 0.5)
    return lambda: ns.step(st, seq["depth"][1], seq["color"][1],
                           seq["e2i"][1], seq["angle"][1], 0.5, mark=mark)


def _chunk(model, seq, mark=None):
    cfg = FusionConfig(vol_dim=VOL, probe_mode="depth",
                       shell_refresh_every=4)
    ns = NorthStar(model, K4, cfg, H, W, render_mode="instance")
    st = _volume(cfg, seq)
    st, *_ = ns.step(st, seq["depth"][0], seq["color"][0], seq["e2i"][0],
                     seq["angle"][0], 0.5)
    return lambda: ns.run_chunk_paired(
        st, seq["depth"][1:3], seq["color"][1:3], seq["e2i"][1:3],
        seq["angle"][1:3], 0.5, mark=mark)


def _parse_frame(model=None, seq=None, mark=None):
    sf = SemanticFusion(K4, FusionConfig(vol_dim=VOL), backend="pallas",
                        device="cpu", miss_check_every=1)
    host = [(f["depth"], f["color"], f["mask"], f["extrinsic"],
             f["mean_depth"]) for f in seq["frames"]]
    sf.parse_frame(*host[0])
    sf.parse_frame(*host[1])
    return lambda: sf.parse_frame(*host[2])


def _mask_process(model, seq, mark=None):
    root = seq["tmp"]
    rgb = os.path.join(root, "rgb")
    if not os.path.isdir(rgb):
        os.makedirs(rgb)
        for k in (0, 2):      # two 128 x 128 scenes the detector finds
            write_png(os.path.join(rgb, f"{k:02d}.png"),
                      detect_scenes()[k][0])
    return lambda: mask_ops.batch_mask_process(
        model, rgb, os.path.join(root, "mask"), verbose=False)


def _train(model=None, seq=None, mark=None):
    tm = MaskRCNN("training", TrainF32(), device="cpu")
    tm.init_params(0)
    ds = ShapesDataset()
    ds.load_shapes(4, 128, 128, seed=3)
    ds.prepare()
    it = Trainer(tm).steps(ds, 0.001, "all", mark=mark, seed=1)
    next(it)
    return lambda: next(it)


# entry -> (its runner, root name, {child: parent name} it must hold)
ENTRIES = {
    "step": (_step, "step",
             {**DETECT, "detect": "step", "label": "step",
              **{k: "step" for k in FUSE}}),
    "chunk": (_chunk, "chunk",
              {**DETECT, "detect": "chunk", "label": "chunk",
               "refresh": "chunk", "render": "chunk",
               **{k: "chunk" for k in FUSE}}),
    "parse_frame": (_parse_frame, "parse_frame",
                    {"upload": "parse_frame", "sync:upload": "upload",
                     **{k: "parse_frame" for k in FUSE},
                     "sync:misses": "parse_frame"}),
    "mask_process": (_mask_process, "mask_process",
                     {"read": "mask_process", "mask_detect": "mask_process",
                      "write": "mask_process", **DETECT,
                      "detect": "mask_detect", "label": "mask_detect",
                      "sync:detections": "detect"}),
    "train": (_train, "train_step",
              {**TRAIN_FORWARD, **{k: "train_step" for k in (
                  "batch", "upload", "train_forward", "loss", "backward",
                  "optimizer", "sync:train.loss")},
               "sync:train.clip": "optimizer",
               "sync:targets.const": "targets", "rpn_targets": "batch"}),
}

# the marks each call emits, as the benchmark's per-layer metrics read
# them (h100bench/run.py StageClock): the stage marks of the entry points
# before they had spans, name for name
MARKS = {
    "step": ["detect", "label", "associate", "fuse"],
    "chunk": ["detect", "label", "refresh", "associate", "fuse", "render"],
    "parse_frame": [],
    "mask_process": [],
    "train": ["upload", "forward", "backward", "optimizer"],
}


@pytest.fixture(scope="module")
def runs(model, seq):
    """Each entry's call and one traced call of it: {entry: (call, marks
    of the call, profiler, session)}."""
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("warm"):      # record_function's first use
            pass
    out = {}
    for entry, (runner, *_) in ENTRIES.items():
        marks = []
        fn = runner(model, seq, mark=marks.append)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
        out[entry] = (fn, marks, prof, profiling.last_session())
    return out


def test_null_span_is_shared():
    assert profiling.span("detect") is profiling.NULL
    assert profiling.sync("upload") is profiling.NULL
    with profiling.span("x") as s:
        assert s is None
    with profiling.sync("upload") as s:
        assert s is None


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_untraced_call_records_nothing(runs, entry):
    fn, marks, _, _ = runs[entry]
    before = profiling.last_session()
    n_spans, counters = len(before.spans), dict(before.counters)
    syncs = profiling.counters("sync.")
    del marks[:]
    fn()
    assert profiling.last_session() is before
    assert len(before.spans) == n_spans and before.counters == counters
    assert profiling.counters("sync.") == syncs
    assert marks == MARKS[entry]


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_entry_records_one_root_and_its_tree(runs, entry):
    _, root, parents = ENTRIES[entry]
    ses = runs[entry][3]
    spans = ses.spans
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == [root]
    assert {s.call for s in spans} == {roots[0].call}
    by_name = {}
    for s in spans:
        assert s.end_ns is not None and s.start_ns <= s.end_ns
        by_name.setdefault(s.name, []).append(s)
        if s.parent is not None:
            p = spans[s.parent]
            assert p.index == s.parent and p.index < s.index
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
        if s.name.startswith("sync:"):          # a leaf
            assert not any(c.parent == s.index for c in spans)
    for child, parent in parents.items():
        assert child in by_name, (child, sorted(by_name))
        if parent is not None:
            assert all(spans[s.parent].name == parent
                       for s in by_name[child]), child
    if entry == "chunk":
        # the pair's spans carry its first frame, the labels their own
        assert {s.frame for s in by_name["fuse"]} == {0}
        assert {s.frame for s in by_name["label"]} == {0, 1}
        assert {s.frame for s in by_name["detect"]} == {None}


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_stamps_map_onto_record_function_events(runs, entry):
    _, _, prof, ses = runs[entry]
    base = prof.profiler.kineto_results.trace_start_ns()
    events = {}
    for e in prof.events():
        events.setdefault(e.name, []).append(e)
    seen, lead, lag = {}, [], []
    for s in ses.spans:
        k = seen.get(s.name, 0)
        seen[s.name] = k + 1
        e = sorted(events[s.name], key=lambda e: e.time_range.start)[k]
        lead.append((s.start_ns - base) * 1e-3 - e.time_range.start)
        lag.append(e.time_range.end - (s.end_ns - base) * 1e-3)
        # the clocks' conversion may round by a microsecond either way
        assert lead[-1] > -1 and lag[-1] > -1, (s.name, lead[-1], lag[-1])
    # a thread descheduled between the event and the stamp moves one span
    # off by its pause, not the median
    assert np.median(lead) < 50 and np.median(lag) < 50, (lead, lag)


@pytest.mark.parametrize("entry", ["step", "chunk"])
def test_traced_marks_are_unchanged(runs, entry):
    assert runs[entry][1] == MARKS[entry]


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_sync_counters_count_each_site_once(runs, entry):
    ses = runs[entry][3]
    spans = {}
    for s in ses.spans:
        if s.name.startswith("sync:"):
            spans[s.name[5:]] = spans.get(s.name[5:], 0) + 1
    counted = {k[5:]: v for k, v in ses.counters.items()
               if k.startswith("sync.")}
    assert counted == spans
    if entry == "step":
        # the depth probe uploads 26 constants, the detector 5 and the
        # association its relabel's bin 0
        assert counted == {"probe.const": 26, "proposals.const": 2,
                           "heads.const": 1, "label.const": 2,
                           "associate.relabel0": 1}
    if entry == "parse_frame":
        assert counted == {"upload": 3, "compact.fill": 3,
                           "associate.relabel0": 1, "misses": 1}
    if entry == "mask_process":
        for site in ("detections", "mold.upload", "mold.mean",
                     "mold.windows", "unmold.keep", "unmold.masks"):
            assert counted[site] == 2, site     # two frames
    if entry in ("mask_process", "train"):
        # the resizes of CPU tensors upload no taps (ops/resize.py); on
        # the card tools/torch_spans_card.py matches the counters to the
        # profiler's synchronisations
        assert "resize.taps" not in counted
    if entry == "train":
        # the clip's and the loss's read-backs
        assert counted["train.clip"] == 1 and counted["train.loss"] == 1


def test_launch_counter_view():
    launches = kernels.launches
    launches.reset()
    assert launches.counts == {n: 0 for n in kernels.KERNELS}
    launches.add("nms")
    launches.add("nms")
    launches.add("fuse_pair")
    assert launches.counts == {"associate": 0, "fuse": 0, "fuse_pair": 1,
                               "nms": 2, "nms_sorted": 0, "roi_align": 0,
                               "rpn_targets": 0}
    assert profiling.counters("launch.")["launch.nms"] == 2
    with pytest.raises(KeyError):
        launches.add("no_such_kernel")
    with profile(activities=[ProfilerActivity.CPU]):
        launches.add("roi_align")
    assert launches.counts["roi_align"] == 1
    assert profiling.last_session().counters == {"launch.roi_align": 1}
    launches.reset()
    assert launches.counts == {n: 0 for n in kernels.KERNELS}


def test_last_session_is_the_newest(model, seq):
    fn = _parse_frame(model, seq)
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    first = profiling.last_session()
    with profile(activities=[ProfilerActivity.CPU]):   # right after
        fn()
    second = profiling.last_session()
    assert second is not first and len(second.spans) == len(first.spans)
    assert [s.name for s in second.spans if s.parent is None] == \
        ["parse_frame"]
    with profiling.trace(os.path.join(seq["tmp"], "trace")):
        third = profiling.last_session()
    assert third is not second and third.spans == []
    with open(os.path.join(seq["tmp"], "trace", "idle_gaps.txt")) as f:
        assert f.readline().startswith("gap ms")


class _Ev:
    def __init__(self, dev, a, b, name="k"):
        from torch.autograd import DeviceType

        self.device_type = getattr(DeviceType, dev)
        self.time_range = type("R", (), {"start": a, "end": b})()
        self.name = name


class _Prof:
    def __init__(self, events, base):
        self._events = events
        kr = type("K", (), {"trace_start_ns": lambda self: base})()
        self.profiler = type("P", (), {"kineto_results": kr})()

    def events(self):
        return self._events


def test_idle_gaps_names_gaps_by_innermost_span():
    base = 1_000_000_000
    ses = profiling.Session()
    # a parent and a child may start on one stamp: the child is innermost
    for i, (name, a, b, parent) in enumerate((("step", 0, 1000, None),
                                              ("probe", 100, 400, 0),
                                              ("sync:probe.const", 200, 300,
                                               1),
                                              ("relabel", 420, 700, 0),
                                              ("sync:associate.relabel0",
                                               420, 450, 3))):
        s = profiling.Span()
        s.name, s.index, s.parent, s.call, s.frame = name, i, parent, 1, None
        s.start_ns, s.end_ns = base + a * 1000, base + b * 1000
        ses.spans.append(s)
    prof = _Prof([_Ev("CUDA", 0, 150), _Ev("CUDA", 140, 200),
                  _Ev("CUDA", 280, 350), _Ev("CUDA", 500, 600),
                  _Ev("CUDA", 1500, 1600), _Ev("CPU", 0, 2000)], base)
    gaps = profiling.idle_gaps(prof, ses, 10)
    assert [g[0] for g in gaps] == ["outside the program",
                                    "sync:associate.relabel0",
                                    "sync:probe.const"]
    assert [round(g[1] * 1e6) for g in gaps] == [900, 150, 80]
    assert profiling.idle_gaps(prof, ses, 1) == gaps[:1]
