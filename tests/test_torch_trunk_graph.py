"""The batch-1 trunk's CUDA graph cache (models/trunk_graph.py), on the CPU.

* On the CPU the graph path is never taken: ``graph.trunk.capture`` and
  ``graph.trunk.replay`` stay 0 and the outputs are the eager trunk's.
* With a stub capture that keeps the CUDA graph's contract on the CPU
  (``replay`` rewrites the static outputs from the static input), the
  cache is taken at batch 1 in eval mode with grad off, and not at batch
  2, in train mode, with grad on, under ``train_forward``, or with a
  forward hook on a trunk module.
* Where it is taken, ``_forward``'s outputs equal the eager path's, one
  capture serves every later frame of the shape, and the returned
  ``rpn_probs`` / ``rpn_bbox`` share no storage with the static outputs
  (an earlier frame's survive the next replay).
* Replaced trunk weights make the next call capture again in the old
  graph's place; weights written in place do not, and the replay reads
  them.
"""

import copy

import pytest
import torch

from slam_maskrcnn_tpu_torch.models.config import Config
from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
from slam_maskrcnn_tpu_torch.models.trunk_graph import Captured, TrunkGraph
from slam_maskrcnn_tpu_torch.utils import profiling

torch.set_num_threads(2)

SIZE = 64
KEYS = ("detections", "detection_valid", "masks", "proposals", "rpn_probs",
        "rpn_bbox")


class TinyConfig(Config):
    NAME = "tiny"
    BACKBONE = "resnet50"
    NUM_CLASSES = 4
    IMAGES_PER_GPU = 1
    IMAGE_MIN_DIM = SIZE
    IMAGE_MAX_DIM = SIZE
    RPN_ANCHOR_SCALES = (8, 16, 32, 64, 128)
    PRE_NMS_LIMIT = 200
    POST_NMS_ROIS_INFERENCE = 40
    DETECTION_MAX_INSTANCES = 8
    DETECTION_MIN_CONFIDENCE = 0.0
    FPN_CLASSIF_FC_LAYERS_SIZE = 64
    COMPUTE_DTYPE = "float32"


class StubGraph:
    """A CUDA graph's contract on the CPU: ``replay`` runs ``fn`` on the
    static input and writes the static outputs in place."""

    def __init__(self, fn, static_in, outputs):
        self.fn, self.static_in, self.outputs = fn, static_in, outputs

    def replay(self):
        for out, new in zip(self.outputs, self.fn(self.static_in)):
            out.copy_(new)


def stub_capture(fn, images, ptrs):
    static_in = images.clone()
    outputs = fn(static_in)
    return Captured(StubGraph(fn, static_in, outputs), static_in, outputs,
                    ptrs)


@pytest.fixture(scope="module")
def model():
    m = MaskRCNN("inference", TinyConfig(), device="cpu")
    m.init_params(0)
    return m


@pytest.fixture
def module(model):
    model.module._trunk_graph = TrunkGraph()
    profiling.reset_counters("graph.trunk.")
    return model.module


@pytest.fixture
def stub(monkeypatch):
    monkeypatch.setattr(TrunkGraph, "DEVICES", ("cpu",))
    monkeypatch.setattr(TrunkGraph, "capture", staticmethod(stub_capture))


def inputs(model, seed: int, batch: int = 1):
    gen = torch.Generator().manual_seed(seed)
    images = torch.randn((batch, SIZE, SIZE, 3), generator=gen) * 60.0
    windows = torch.tensor([[0.0, 0.0, 1.0, 1.0]]).expand(batch, 4)
    return images, model.anchors((SIZE, SIZE)), windows


def graph_counts() -> tuple:
    c = profiling.counters("graph.trunk.")
    return c.get("graph.trunk.capture", 0), c.get("graph.trunk.replay", 0)


def eager(module, images, anchors, windows) -> dict:
    with torch.no_grad():
        pyramid = module.features(images)
        _, probs, bbox = module.rpn_outputs(pyramid)
    return dict(pyramid=pyramid, rpn_probs=probs, rpn_bbox=bbox)


def eager_forward(module, *args) -> dict:
    """``forward`` down the eager path whatever the inputs."""
    module._graphable = lambda images: False
    try:
        return module(*args)
    finally:
        del module._graphable


def assert_equal(a: dict, b: dict, keys=KEYS):
    for k in keys:
        assert torch.equal(a[k], b[k]), k


def test_cpu_takes_the_eager_path(model, module):
    args = inputs(model, 1)
    out = module(*args)
    assert graph_counts() == (0, 0)
    assert not module._trunk_graph._graphs
    ref = eager(module, *args)
    assert_equal(out, ref, ("rpn_probs", "rpn_bbox"))
    assert_equal(out, eager_forward(module, *args))


def _batch2(model, module):
    args = inputs(model, 2, batch=2)
    return module(*args), eager(module, *args)


def _grad_on(model, module):
    args = inputs(model, 3)
    with torch.enable_grad():
        return module._forward(*args), eager(module, *args)


def _train_mode(model, module):
    # BatchNorm takes the batch's statistics and moves its running ones:
    # each side runs on a copy
    args = inputs(model, 4)
    return (copy.deepcopy(module).train()(*args),
            eager(copy.deepcopy(module).train(), *args))


def _hook(model, module):
    seen = []
    handle = module.resnet.conv1.register_forward_hook(
        lambda *_: seen.append(1))
    try:
        args = inputs(model, 5)
        out = module(*args)
    finally:
        handle.remove()
    assert seen == [1]
    return out, eager(module, *args)


def _train_forward(model, module):
    images, anchors, _ = inputs(model, 6)
    n = module.proposal_count
    gen = torch.Generator().manual_seed(6)
    outputs, _ = module.train_forward(
        images, anchors, torch.tensor([[1]]),
        torch.tensor([[[0.2, 0.2, 0.6, 0.7]]]),
        torch.ones((1, 1, 56, 56)), torch.rand((1, n), generator=gen),
        torch.rand((1, n), generator=gen), train_rois=16)
    return ({k: v.detach() for k, v in outputs.items()},
            eager(module, images, anchors, None))


BYPASS = {"batch2": _batch2, "grad_on": _grad_on, "train_mode": _train_mode,
          "forward_hook": _hook, "train_forward": _train_forward}


@pytest.mark.parametrize("case", list(BYPASS))
def test_graph_path_is_bypassed(model, module, stub, case):
    out, ref = BYPASS[case](model, module)
    assert graph_counts() == (0, 0), case
    assert not module._trunk_graph._graphs
    assert_equal(out, ref, ("rpn_probs", "rpn_bbox"))


def test_replay_equals_eager_and_returns_copies(model, module, stub):
    frames = [inputs(model, 10 + i) for i in range(3)]
    outs = [module(*args) for args in frames]
    assert graph_counts() == (1, 3)
    (entry,) = module._trunk_graph._graphs.values()
    static = {t.untyped_storage().data_ptr() for t in entry.outputs}
    for args, out in zip(frames, outs):
        # an earlier frame's outputs survive the later replays
        assert_equal(out, eager_forward(module, *args))
        for k in ("rpn_probs", "rpn_bbox"):
            assert out[k].untyped_storage().data_ptr() not in static, k
    # the static outputs hold the last frame's trunk
    ref = eager(module, *frames[-1])
    for got, want in zip(entry.outputs, ref["pyramid"] + (
            ref["rpn_probs"], ref["rpn_bbox"])):
        assert torch.equal(got, want)


def test_replaced_weights_capture_again(model, module, stub):
    args = inputs(model, 20)
    module(*args)
    conv = module.fpn.fpn_p2
    old = conv.weight
    try:
        conv.weight = torch.nn.Parameter(old.detach() * 0.5)
        out = module(*args)
        assert graph_counts() == (2, 2)
        assert len(module._trunk_graph._graphs) == 1
        assert_equal(out, eager_forward(module, *args))
        with torch.no_grad():
            conv.weight.mul_(3.0)   # in place: the same graph reads it
        out = module(*args)
        assert graph_counts() == (2, 3)
        assert_equal(out, eager_forward(module, *args))
    finally:
        conv.weight = old
