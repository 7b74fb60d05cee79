"""models/inspect.py and utils/profiling.py against the JAX package's, on
tests/test_samples.py::test_inspect_and_viz_extras's tiny config (ResNet-50,
128^2, 4 classes, float32) and weight seed 0 (the JAX init carried into
the port by models/weights.load_jax_params), on the CPU:

* ``weight_stats``: the same rows (names, shapes, min, max, mean, std)
  for every weight and for the "conv1" pattern, equal exactly (the same
  values in the same layout); ``find_suspicious_weights`` flags the same
  names;
* ``run_graph``: the port's activations under the JAX package's names;
  every backbone, FPN and RPN activation both packages name alike
  agrees within 1e-4 of its largest magnitude (the convolutions' summation
  order; the RPN's softmax probabilities within 1e-3, their logits being
  in the hundreds at random weights), and the graph's outputs appear as
  ``out/<key>``;
* ``log_tensor`` prints what the JAX one prints; ``StageTimer`` and
  ``trace`` on the CPU.
"""

import json
import os

import jax
import numpy as np
import torch

from slam_maskrcnn_tpu.models import Config as JConfig
from slam_maskrcnn_tpu.models import MaskRCNN as JMaskRCNN
from slam_maskrcnn_tpu.models.inspect import (
    find_suspicious_weights as j_suspicious, run_graph as j_run_graph,
    weight_stats as j_weight_stats)
from slam_maskrcnn_tpu.utils.profiling import log_tensor as j_log_tensor
from slam_maskrcnn_tpu_torch.models.config import Config
from slam_maskrcnn_tpu_torch.models.inspect import (find_suspicious_weights,
                                                    run_graph, weight_stats)
from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
from slam_maskrcnn_tpu_torch.models.weights import load_jax_params
from slam_maskrcnn_tpu_torch.utils import StageTimer, log_tensor, trace

torch.set_num_threads(2)

TINY = dict(NAME="inspect_test", BACKBONE="resnet50", IMAGE_MIN_DIM=128,
            IMAGE_MAX_DIM=128, NUM_CLASSES=4,
            RPN_ANCHOR_SCALES=(8, 16, 32, 64, 128),
            POST_NMS_ROIS_INFERENCE=20, PRE_NMS_LIMIT=50,
            DETECTION_MAX_INSTANCES=5, IMAGES_PER_GPU=1, GPU_COUNT=1,
            DETECTION_MIN_CONFIDENCE=0.0, COMPUTE_DTYPE="float32")


def _models():
    jm = JMaskRCNN("inference", type("J", (JConfig,), TINY)())
    jm.init_params(0)
    tm = MaskRCNN("inference", type("T", (Config,), TINY)(), device="cpu")
    load_jax_params(jax.tree.map(np.asarray, jm.params), tm, device="cpu")
    tm.initialized = True
    return jm, tm


def test_weight_stats_match_jax():
    jm, tm = _models()
    for pattern in (None, "conv1"):
        want = j_weight_stats(jm.params, pattern=pattern)
        got = weight_stats(tm, pattern=pattern)
        assert want and sorted(r["name"] for r in got) == \
            sorted(r["name"] for r in want)
        by_name = {r["name"]: r for r in got}
        for w in want:
            assert by_name[w["name"]] == w, w["name"]
    assert sorted(r["name"] for r in find_suspicious_weights(tm)) == \
        sorted(r["name"] for r in j_suspicious(jm.params))


def test_run_graph_matches_jax():
    jm, tm = _models()
    img = np.random.default_rng(0).integers(0, 255, (100, 120, 3),
                                            dtype=np.uint8)
    want = j_run_graph(jm, [img])
    got = run_graph(tm, [img])
    common = [k for k in want if k in got
              and k.split("/")[0] in ("resnet", "fpn", "rpn_model")]
    assert len(common) > 150, len(common)
    for k in common:
        w = np.asarray(want[k], np.float64)
        assert got[k].shape == w.shape, k
        # the RPN's probabilities: a softmax of logits in the hundreds at
        # random weights, whose 1e-4 becomes 1e-3 through it
        probs = k.startswith("rpn_model/__call__/") and k.endswith("/1")
        np.testing.assert_allclose(
            got[k], w, rtol=0,
            atol=1e-3 if probs else 1e-4 * max(np.abs(w).max(), 1.0),
            err_msg=k)
    assert {k for k in want if k.startswith("out/")} == \
        {k for k in got if k.startswith("out/")}
    small = run_graph(tm, [img], filter_fn=lambda k: "conv1" in k
                      or k.startswith("out/"))
    assert "resnet/conv1/__call__/0" in small and "out/detections" in small
    assert all("conv1" in k or k.startswith("out/") for k in small)


def test_log_tensor_and_timers(capsys, tmp_path):
    a = np.linspace(-1.0, 2.0, 12, dtype=np.float32).reshape(3, 4)
    for arr in (a, np.zeros((0, 2), np.float32)):
        j_log_tensor("x", arr)
        want = capsys.readouterr().out
        log_tensor("x", torch.from_numpy(arr))
        assert capsys.readouterr().out == want
    timer = StageTimer(device="cpu")
    for _ in range(2):
        with timer("matmul", sync=torch.ones(64, 64) @ torch.ones(64, 64)):
            pass
    assert timer.counts["matmul"] == 2 and timer.totals["matmul"] > 0
    assert "matmul" in timer.report()
    with trace(str(tmp_path)) as prof:
        torch.ones(32, 32) @ torch.ones(32, 32)
    assert prof.key_averages()
    with open(os.path.join(tmp_path, "trace.json")) as f:
        assert json.load(f)["traceEvents"]
