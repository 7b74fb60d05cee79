"""The RPN matching kernel (csrc/rpn_targets.cu, K6) against its plain
version (``rpn_match_plain``) on the card: labels and best gt bit-equal on
every case of ``slam_maskrcnn_tpu_torch.testing.RPN_CASES``, on random
boxes over the 1024^2 anchors (1 to 300 gt, past the kernel's 256-box
tile), and on the boxes of the training cell's traffic (orbit frames of
``h100bench/workloads/coco1024.train_all.json`` molded to 1024^2, half of
them flipped); ``build_rpn_targets`` with the anchors on the card equal to
the host numpy path with the same draws; one ``launch.rpn_targets`` an
image over ``Trainer.steps`` on the card.

Each test takes the ``card`` fixture and skips without a CUDA card. This
file imports no JAX; on the card's machine, which has none, run it without
the suite's conftest:

    python3 -m pytest tests/test_torch_rpn_targets_card.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from slam_maskrcnn_tpu_torch import kernels
from slam_maskrcnn_tpu_torch.models import targets
from slam_maskrcnn_tpu_torch.testing import (RPN_CASES, rpn_anchors,
                                             rpn_case, rpn_config, rpn_split)

torch.set_num_threads(2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the RPN matching kernel runs only "
                    "there")
    return torch.device("cuda")


def _kernel_equals_plain(anchors, g, crowd, dev):
    """The kernel's [2, A] on the card, checked against the plain
    version's; no sync, one launch."""
    a = torch.from_numpy(anchors).to(dev)
    boxes = torch.from_numpy(np.concatenate([g, crowd])).to(dev)
    before = kernels.launches.counts["rpn_targets"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = targets.rpn_match_cuda(a, boxes, len(g))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert kernels.launches.counts["rpn_targets"] == before + 1
    want = targets.rpn_match_plain(a, boxes, len(g))
    assert got.dtype == torch.int32 and got.shape == (2, len(anchors))
    bad = (got != want).any(dim=0).nonzero()[:5, 0].tolist()
    assert not bad, [(i, got[:, i].tolist(), want[:, i].tolist())
                     for i in bad]
    return got


def _targets_equal_numpy(anchors, ids, gt, cfg, dev):
    """build_rpn_targets with the anchors on the card against the host
    numpy path: rpn_match, rpn_bbox bits and numpy's stream."""
    np.random.seed(11)
    m_np, b_np = targets.build_rpn_targets(anchors, ids, gt, cfg)
    state = np.random.get_state()
    np.random.seed(11)
    m, b = targets.build_rpn_targets(targets.DeviceAnchors(anchors, dev),
                                     ids, gt, cfg)
    assert all(np.array_equal(x, y)
               for x, y in zip(np.random.get_state(), state))
    np.testing.assert_array_equal(m, m_np)
    np.testing.assert_array_equal(b.view(np.int32), b_np.view(np.int32))
    return m


@pytest.mark.card
@pytest.mark.parametrize("case", list(RPN_CASES))
def test_kernel_equals_plain(card, case):
    anchors, ids, gt, cfg = rpn_case(case)
    g, crowd = rpn_split(ids, gt)
    if len(g):
        _kernel_equals_plain(anchors, g, crowd, card)
    before = kernels.launches.counts["rpn_targets"]
    _targets_equal_numpy(anchors, ids, gt, cfg, card)
    # no gt left to match: nothing launched
    assert kernels.launches.counts["rpn_targets"] == before + (len(g) > 0)


@pytest.mark.card
@pytest.mark.parametrize("n_gt", [1, 12, 100, 300])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_equals_plain_on_random_boxes(card, seed, n_gt):
    anchors = rpn_anchors(1024)
    rng = np.random.default_rng([seed, n_gt])
    h, w = rng.integers(4, 400, (2, n_gt))
    y1, x1 = rng.integers(-50, 1024 - h), rng.integers(-50, 1024 - w)
    gt = np.stack([y1, x1, y1 + h, x1 + w], 1).astype(np.float32)
    ids = np.where(rng.random(n_gt) < 0.1, -1, 1).astype(np.int32)
    ids[0] = 1
    g, crowd = rpn_split(ids, gt)
    _kernel_equals_plain(anchors, g, crowd, card)
    _targets_equal_numpy(anchors, ids, gt, rpn_config(1024), card)


@pytest.mark.card
@pytest.mark.parametrize("seed", [7, 2 ** 31 + 9])
def test_kernel_equals_plain_on_training_traffic(card, seed):
    """Eight frames spread over the orbit of the training cell's traffic,
    the spheres' boxes molded as the generator molds them
    (``chip_smoke.traffic_gt``)."""
    import chip_smoke
    from slam_maskrcnn_tpu_torch.models.anchors import get_anchors

    frames, cfg = chip_smoke.traffic_gt(card, seed, 8)
    anchors = rpn_anchors(1024)
    np.testing.assert_array_equal(
        anchors, get_anchors(cfg, cfg.IMAGE_SHAPE)
        * np.array([1023] * 4, np.float32) + np.array([0, 0, 1, 1],
                                                      np.float32))
    positives = []
    for ids, gt in frames:
        assert len(gt) > 0
        _kernel_equals_plain(anchors, *rpn_split(ids, gt), card)
        m = _targets_equal_numpy(anchors, ids, gt, cfg, card)
        positives.append(int((m == 1).sum()))
    assert min(positives) > 0, positives


@pytest.mark.card
def test_trainer_steps_launch_once_an_image(card):
    """Two steps of a small shapes training on the card: one matching
    launch a trained image."""
    from slam_maskrcnn_tpu_torch.data.shapes import (ShapesConfig,
                                                     ShapesDataset)
    from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from slam_maskrcnn_tpu_torch.train.trainer import Trainer

    cfg = type("Small", (ShapesConfig,), dict(
        IMAGES_PER_GPU=2, TRAIN_ROIS_PER_IMAGE=16,
        POST_NMS_ROIS_TRAINING=64, PRE_NMS_LIMIT=256,
        MAX_GT_INSTANCES=4))()
    ds = ShapesDataset()
    ds.load_shapes(6, 128, 128, seed=3)
    ds.prepare()
    model = MaskRCNN("training", cfg, device=card)
    model.init_params(0)
    np.random.seed(0)
    it = Trainer(model).steps(ds, 0.001, "all", seed=1)
    kernels.launches.reset()
    images = sum(next(it).images for _ in range(2))
    torch.cuda.synchronize()
    assert images == 2 * cfg.BATCH_SIZE
    assert kernels.launches.counts["rpn_targets"] == images


@pytest.mark.card
def test_kernel_refuses_other_inputs(card):
    a = torch.zeros(8, 4, device=card)
    with pytest.raises(ValueError, match="f32"):
        targets.rpn_match_cuda(a, torch.zeros(2, 4, device=card,
                                              dtype=torch.float64), 2)
    with pytest.raises(ValueError, match="G >= 1"):
        targets.rpn_match_cuda(a, torch.zeros(2, 4, device=card), 0)
