"""Data-parallel training (parallel/sharding.py, train/trainer.py with
GPU_COUNT > 1) on the CPU: two gloo ranks on the global batch against the
port's one-rank step on the same batch.

The fixture is tests/test_torch_train.py's TrainConfig (ResNet-50,
128^2, 64 training proposals, 16 training rois, float32) with the RPN's
output layers zeroed but for an objectness bias by anchor ratio, so that
the proposals are the anchors on every rank and in every batch split (the
pinned-proposal fixture), and gt boxes made from those proposals. The
global batch is 4 images, 2 a rank. Two cases:

* "even": every image holds gt boxes on proposals;
* "uneven": the second rank's images hold one box smaller than any
  proposal can match (IoU < 0.5), so that rank keeps no positive roi:
  the mask and box losses are their first rank's numerators over the
  global counts, and a mean of the two ranks' means would be half that.

Each with TRAIN_BN off and on ("all" layers), all four in one launch of
two ranks. The bars are test_torch_train.py's: the loss parts 3e-3
relative plus 1e-5 absolute; without TRAIN_BN every updated parameter
2e-6 absolute and the update 5e-3 in norm (measured 1.2e-5); with TRAIN_BN
the update 10% in norm (measured 0.7% even, 1.2% uneven: the ranks' sums
of the batch statistics round otherwise than one mean over the batch, and
the backward through the batch-statistics layers grows that, as the
summation order does there); the running BatchNorm statistics 1e-4 of
their largest value. The two ranks' tensors after the step are equal bit
for bit. Last, ``Trainer.train`` itself with GPU_COUNT = 2 (one step from
unequal tensors on the two ranks) ends with equal tensors on both, and
only rank 0 logs and writes its checkpoint.
"""

import os

import numpy as np
import pytest
import torch

from slam_maskrcnn_tpu_torch.data.dataset import data_generator
from slam_maskrcnn_tpu_torch.data.shapes import ShapesDataset
from slam_maskrcnn_tpu_torch.models.anchors import get_anchors
from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
from slam_maskrcnn_tpu_torch.models.proposal import generate_proposals
from slam_maskrcnn_tpu_torch.parallel import launch
from slam_maskrcnn_tpu_torch.train.checkpoint import restore_params
from slam_maskrcnn_tpu_torch.train.trainer import (LAYER_REGEX, Trainer,
                                                   batch_to_device)
import torch_sharding_ranks as ranks

torch.set_num_threads(2)

LR = 0.002
CONFIG = dict(NAME="shapes_dp_test", IMAGES_PER_GPU=4, GPU_COUNT=1,
              IMAGE_MIN_DIM=128, IMAGE_MAX_DIM=128,
              RPN_ANCHOR_SCALES=(8, 16, 32, 64, 128),
              TRAIN_ROIS_PER_IMAGE=16, POST_NMS_ROIS_TRAINING=64,
              PRE_NMS_LIMIT=256, MAX_GT_INSTANCES=4, STEPS_PER_EPOCH=2,
              COMPUTE_DTYPE="float32")


def _fixture(uneven: bool, train_bn: bool):
    """(config overrides, module tensors, global batch, draws)."""
    over = dict(CONFIG, TRAIN_BN=train_bn)
    cfg = ranks.train_config(over)
    model = MaskRCNN("training", cfg, device="cpu")
    model.init_params(21)
    m = model.module
    with torch.no_grad():
        for head in (m.rpn_model.rpn_class_raw, m.rpn_model.rpn_bbox_pred):
            head.weight.zero_()
            head.bias.zero_()
        m.rpn_model.rpn_class_raw.bias[1::2] = torch.tensor([1.0, 2.0, 0.0])
    ds = ShapesDataset()
    ds.load_shapes(8, 128, 128, seed=3)
    ds.prepare()
    np.random.seed(0)
    batch = next(data_generator(ds, cfg, seed=1))
    anchors = get_anchors(cfg, cfg.IMAGE_SHAPE)
    with torch.no_grad():
        _, probs, deltas = m.rpn_outputs(m.eval().features(
            torch.from_numpy(batch["images"])))
        props, _ = generate_proposals(
            probs, deltas, torch.from_numpy(anchors), m.proposal_count,
            m.rpn_nms_threshold, m.pre_nms_limit, m.rpn_bbox_std)
    gt = np.zeros_like(batch["gt_boxes"])
    for b in range(props.shape[0]):
        box = props[b, [0, 4]].numpy()
        c, hw = (box[:, :2] + box[:, 2:]) / 2, box[:, 2:] - box[:, :2]
        gt[b, :2] = np.concatenate([c - 0.45 * hw, c + 0.45 * hw], 1)
    ids = np.zeros_like(batch["gt_class_ids"])
    ids[:, :2] = [1, 2]
    if uneven:
        # the second rank's images: one box of 2% a side in a corner
        gt[2:] = 0
        gt[2:, 0] = [0.01, 0.01, 0.03, 0.03]
        ids[2:] = 0
        ids[2:, 0] = 3
    batch["gt_boxes"], batch["gt_class_ids"] = gt, ids
    empty = batch["gt_masks"].sum((2, 3)) == 0
    batch["gt_masks"][empty] = batch["gt_masks"][0, 0]
    gen = torch.Generator().manual_seed(5)
    P = cfg.POST_NMS_ROIS_TRAINING
    pos, neg = torch.rand(4, P, generator=gen), torch.rand(4, P, generator=gen)
    state = {k: v.numpy().copy() for k, v in m.state_dict().items()}
    return over, state, batch, anchors, pos, neg


CASES = [(uneven, train_bn) for uneven in (False, True)
         for train_bn in (False, True)]


@pytest.fixture(scope="module")
def fixtures():
    return {case: _fixture(*case) for case in CASES}


@pytest.fixture(scope="module")
def data_parallel(fixtures, tmp_path_factory):
    """Every case's two-rank step, in one launch of two gloo ranks."""
    args = []
    for case in CASES:
        over, state, batch, _, pos, neg = fixtures[case]
        dp = dict(over, IMAGES_PER_GPU=2, GPU_COUNT=2)
        args.append((dp, state, batch, pos, neg, LR, "all"))
    over, state = fixtures[CASES[0]][:2]
    logs = str(tmp_path_factory.mktemp("dp_logs"))
    out = launch(ranks.dp_steps, 2, devices=["cpu"] * 2, args=(
        args, (dict(over, IMAGES_PER_GPU=1), state, logs)), threads=2)
    steps = {case: (out[0][0][i], out[1][0][i])
             for i, case in enumerate(CASES)}
    return steps, (out[0][1], out[1][1]), logs


@pytest.mark.parametrize("uneven,train_bn", CASES)
def test_data_parallel_step_equals_global_batch_step(fixtures, data_parallel,
                                                     uneven, train_bn):
    over, state, batch, anchors, pos, neg = fixtures[(uneven, train_bn)]
    # the one-rank step on the global batch
    cfg = ranks.train_config(over)
    one = MaskRCNN("training", cfg, device="cpu")
    one.module.load_state_dict({k: torch.from_numpy(v)
                                for k, v in state.items()})
    one.initialized = True
    step = Trainer(one, cfg).make_step(LR, LAYER_REGEX["all"])
    b = batch_to_device(batch, "cpu")
    b["anchors"] = torch.from_numpy(anchors)
    loss, parts = step(b, pos, neg)
    want = one.module.state_dict()

    out = data_parallel[0][(uneven, train_bn)]
    for k, v in out[0]["state"].items():
        np.testing.assert_array_equal(out[1]["state"][k], v, err_msg=k)
    assert out[0]["loss"] == out[1]["loss"]
    np.testing.assert_allclose(out[0]["loss"], float(loss), rtol=3e-3)
    for k, v in parts.items():
        np.testing.assert_allclose(out[0]["parts"][k], float(v), rtol=3e-3,
                                   atol=1e-5, err_msg=k)
    moved, num, den = 0, 0.0, 0.0
    for k, w in want.items():
        g, w = out[0]["state"][k], w.numpy()
        if k.endswith((".mean", ".var")):
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=k)
            continue
        if not train_bn:
            np.testing.assert_allclose(g, w, rtol=0, atol=2e-6, err_msg=k)
        num += float(((g.astype(np.float64) - w) ** 2).sum())
        den += float(((w.astype(np.float64) - state[k]) ** 2).sum())
        moved += int((w != state[k]).any())
    assert moved > 100
    assert (num / den) ** 0.5 < (0.1 if train_bn else 5e-3)
    positives = [o["positive_rois"] for o in out]
    assert float(parts["mrcnn_mask_loss"]) > 0 and positives[0] > 0
    if uneven:
        # the case a mean of per-rank means gets wrong
        assert positives[1] == 0
        mean_of_means = np.mean([o["local_mask_loss"] for o in out])
        assert abs(mean_of_means - float(parts["mrcnn_mask_loss"])) \
            > 0.3 * float(parts["mrcnn_mask_loss"])
    else:
        assert positives[1] > 0


def test_trainer_trains_data_parallel(data_parallel):
    """Trainer.train with GPU_COUNT = 2 in a group of two ranks: the ranks
    start from different tensors, take rank 0's (shard_params), draw one
    global batch from one broadcast seed, and end the step with the same
    tensors and the same finite loss. Only rank 0 prints and writes the
    checkpoint: one run directory holding one file, which loads into a
    fresh model as rank 0's tensors."""
    a, b = data_parallel[1]
    logs = data_parallel[2]
    assert len(a["history"]) == 1 and np.isfinite(a["history"][0])
    assert a["history"] == b["history"]
    for k, v in a["state"].items():
        np.testing.assert_array_equal(b["state"][k], v, err_msg=k)
    assert a["printed"].startswith("epoch 1/1 loss") and b["printed"] == ""
    assert b["run_directory"] is None
    assert os.listdir(logs) == [os.path.basename(a["run_directory"])]
    files = os.listdir(a["run_directory"])
    assert files == ["mask_rcnn_shapes_dp_test_0001"]
    cfg = ranks.train_config(dict(CONFIG, GPU_COUNT=1, IMAGES_PER_GPU=1))
    fresh = MaskRCNN("training", cfg, device="cpu")
    restore_params(os.path.join(a["run_directory"], files[0]), fresh)
    for k, v in fresh.module.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), a["state"][k], err_msg=k)
