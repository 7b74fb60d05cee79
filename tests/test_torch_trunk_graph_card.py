"""The batch-1 trunk's CUDA graph (models/trunk_graph.py) against the eager
trunk on the card, at the benchmark's two detector configurations:
``north_star_r101_512`` (768x1024 rect, bf16) and ``reference_r101_256``
(square 1024^2, bf16), each with the harness's seeded, calibrated weights
(h100bench/northstar.py) and frames of its orbit, molded as ``detect``
molds them.

* The graph's pyramid and RPN outputs are bit-equal to the eager trunk's
  over four different frames replayed in turn, one capture serving them
  all; a replay syncs nothing (``set_sync_debug_mode("error")``).
* Replaced trunk weights make the next call capture again
  (``graph.trunk.capture`` one more), and it equals the eager trunk with
  the new weights.
* ``forward``'s detections, masks, proposals and RPN outputs are bit-equal
  between the graph path and the eager path.

Each test takes the ``card`` fixture and skips without a CUDA card. This
file imports no JAX; on the card's machine, which has none, run it without
the suite's conftest:

    python3 -m pytest tests/test_torch_trunk_graph_card.py --noconftest -q
"""

import json
import os

import numpy as np
import pytest
import torch

from slam_maskrcnn_tpu_torch.models.mask_rcnn import mold_image
from slam_maskrcnn_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2**31 + 19
CELLS = {"north_star_r101_512": "ns512.step",
         "reference_r101_256": "ref256.stage1"}
KEYS = ("detections", "detection_valid", "masks", "proposals", "rpn_probs",
        "rpn_bbox")


def _json(*parts):
    with open(os.path.join(REPO, "h100bench", *parts)) as f:
        return json.load(f)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph is captured only there")
    return torch.device("cuda")


@pytest.fixture(scope="module", params=list(CELLS))
def program(request):
    """(model with the harness's weights, four molded frames as
    (images, anchors, windows)) for one configuration."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph is captured only there")
    from h100bench import northstar, traffic

    dev = torch.device("cuda")
    config = _json("configs", request.param + ".json")
    cell = _json("workloads", CELLS[request.param] + ".json")
    seq = traffic.sequence(cell["traffic"], config["camera"], SEED, dev)
    runner = northstar.reference_runner(config, dict(cell, render="none"),
                                        SEED, dev, seq)
    model = northstar.port_model(config, runner.model.module.state_dict(),
                                 dev)
    del runner
    frames = []
    for i in np.linspace(0, len(seq), 4, endpoint=False).astype(int):
        rgb = seq.color[int(i)].flip(-1).cpu().numpy()
        molded, windows = model.mold_inputs([rgb])
        shape = tuple(molded.shape[1:])
        frames.append((mold_image(molded, model.config),
                       model.anchors(shape),
                       torch.from_numpy(model.norm_windows(windows, shape))
                       .to(dev)))
    yield model, frames
    model.module._trunk_graph._graphs.clear()
    torch.cuda.empty_cache()


def graph_counts() -> tuple:
    c = profiling.counters("graph.trunk.")
    return c.get("graph.trunk.capture", 0), c.get("graph.trunk.replay", 0)


def eager_forward(module, *args) -> dict:
    module._graphable = lambda images: False
    try:
        return module(*args)
    finally:
        del module._graphable


def replay(module, images, check_sync: bool):
    with torch.no_grad():
        if check_sync:
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = module._trunk_graph.replay(module, images)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return [t.clone() for t in out]


@pytest.mark.card
def test_graph_trunk_equals_eager_and_syncs_nothing(card, program):
    model, frames = program
    module = model.module
    module._trunk_graph._graphs.clear()
    with torch.no_grad():
        eager = [module._trunk(x) for x, _, _ in frames]
    before = graph_counts()
    for i, (x, _, _) in enumerate(frames):
        got = replay(module, x, check_sync=i > 0)
        assert len(got) == len(eager[i]) == 7
        for k, (a, b) in enumerate(zip(got, eager[i])):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b), (i, k)
    after = graph_counts()
    assert (after[0] - before[0], after[1] - before[1]) == (1, 4)


@pytest.mark.card
def test_replaced_weights_capture_again(card, program):
    model, frames = program
    module = model.module
    x = frames[0][0]
    replay(module, x, check_sync=False)
    conv, bn = module.fpn.fpn_p3, module.resnet.bn_conv1
    old = conv.weight, bn.mean
    try:
        conv.weight = torch.nn.Parameter(old[0].detach() * 0.75)
        bn.mean = old[1] + 0.5
        before = graph_counts()
        got = replay(module, x, check_sync=False)
        after = graph_counts()
        assert (after[0] - before[0], after[1] - before[1]) == (1, 1)
        with torch.no_grad():
            want = module._trunk(x)
        for k, (a, b) in enumerate(zip(got, want)):
            assert torch.equal(a, b), k
    finally:
        conv.weight, bn.mean = old


@pytest.mark.card
def test_forward_graph_equals_eager(card, program):
    model, frames = program
    module = model.module
    before = graph_counts()
    for i, args in enumerate(frames):
        got = module(*args)
        want = eager_forward(module, *args)
        for k in KEYS:
            assert torch.equal(got[k], want[k]), (i, k)
    assert graph_counts()[1] - before[1] == len(frames)
