"""The RPN targets' matching on a device (``build_rpn_targets`` given the
anchors as a tensor) against the host numpy path and the JAX package.

On the CPU the device route is ``rpn_match_plain``, the plain version of
csrc/rpn_targets.cu: its labels, best gt, ``rpn_match`` and ``rpn_bbox``
equal the numpy path's bit for bit, and numpy's global stream is left in
the same state (the subsample draws the same). The cases are
``slam_maskrcnn_tpu_torch.testing.RPN_CASES``, shared with the card test
(tests/test_torch_rpn_targets_card.py) and ``chip_smoke.py``. The
generator with ``device="cpu"`` yields the batches it yields without.
"""

import numpy as np
import pytest
import torch

from slam_maskrcnn_tpu.models.targets import build_rpn_targets as j_rpn
from slam_maskrcnn_tpu_torch.data import dataset as tds
from slam_maskrcnn_tpu_torch.data.augment import Fliplr
from slam_maskrcnn_tpu_torch.data.shapes import ShapesConfig, ShapesDataset
from slam_maskrcnn_tpu_torch.models import targets
from slam_maskrcnn_tpu_torch.testing import RPN_CASES, rpn_case, rpn_split

torch.set_num_threads(2)


def _same_state(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("case", list(RPN_CASES))
def test_plain_route_equals_numpy(case):
    anchors, ids, gt, cfg = rpn_case(case)
    g, crowd = rpn_split(ids, gt)
    if len(g):
        want, want_arg = targets._match_np(anchors, g, crowd)
        got, got_arg = targets.match_anchors(torch.from_numpy(anchors), g,
                                             crowd)
        assert got.dtype == np.int32 and got_arg.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_arg, want_arg)
    np.random.seed(11)
    m_np, b_np = targets.build_rpn_targets(anchors, ids, gt, cfg)
    state = np.random.get_state()
    np.random.seed(11)
    m_t, b_t = targets.build_rpn_targets(
        targets.DeviceAnchors(anchors, "cpu"), ids, gt, cfg)
    assert _same_state(np.random.get_state(), state)
    assert m_t.dtype == m_np.dtype and b_t.dtype == b_np.dtype
    np.testing.assert_array_equal(m_t, m_np)
    np.testing.assert_array_equal(b_t.view(np.int32), b_np.view(np.int32))
    n_pos = int((m_np == 1).sum())
    if case in ("no_gt", "only_crowd"):
        assert not m_np.any()
    else:
        assert 0 < n_pos <= cfg.RPN_TRAIN_ANCHORS_PER_IMAGE // 2
    if case in ("unmatched_gt", "many_positives"):
        # the subsample drew: more positives than half the anchors a batch
        assert (want == 1).sum() > cfg.RPN_TRAIN_ANCHORS_PER_IMAGE // 2
    if case == "column_ties":
        assert (want == 1).sum() == 7     # 2 + 4 tied, 1 on, its copy
    if case == "thresholds":
        # [0, 0, 10, 3] at 0.3f, [0, 0, 10, 7] at 0.7f, [0, 0, 10, 2]
        assert list(want[100:103]) == [0, 1, -1]
    if case == "crowd":
        assert (want == 0).sum() > 0


@pytest.mark.parametrize("case", ["crowd", "class_zero_with_crowd",
                                  "column_ties", "random_128"])
def test_plain_route_matches_jax(case):
    anchors, ids, gt, cfg = rpn_case(case)
    np.random.seed(5)
    jm, jb = j_rpn(anchors, ids, gt, cfg)
    np.random.seed(5)
    tm, tb = targets.build_rpn_targets(
        targets.DeviceAnchors(anchors, "cpu"), ids, gt, cfg)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tb, jb)


@pytest.mark.parametrize("seed", [0, 3])
def test_generator_on_cpu_device_yields_the_same_batches(seed):
    """Four batches of three shapes images with Fliplr(0.5), from the
    generator with ``device="cpu"`` (the plain matching) and without."""
    cfg = type("T", (ShapesConfig,), dict(
        NAME="shapes_gen", IMAGES_PER_GPU=3, MAX_GT_INSTANCES=2,
        RPN_TRAIN_ANCHORS_PER_IMAGE=64))()
    ds = ShapesDataset()
    ds.load_shapes(7, 128, 128, seed=seed + 1)
    ds.prepare()
    out = []
    for device in (None, "cpu"):
        np.random.seed(seed)
        gen = tds.data_generator(ds, cfg, seed=seed,
                                 augmentation=Fliplr(0.5), device=device)
        out.append([next(gen) for _ in range(4)])
        out[-1].append(np.random.get_state())
    (*want, s_want), (*got, s_got) = out
    assert _same_state(s_got, s_want)
    for w, g in zip(want, got):
        assert sorted(w) == sorted(g)
        for k in w:
            assert w[k].dtype == g[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert (np.stack([b["rpn_match"] for b in got]) == 1).sum() > 0
