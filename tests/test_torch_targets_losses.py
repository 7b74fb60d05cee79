"""The port's training targets and losses against the JAX package's on the
CPU: detection_targets (fed the JAX package's own jax.random.uniform
draws) on seeded proposals around seeded ground truth with padding and a
crowd box, build_rpn_targets, and each of the five losses with
total_loss, the empty-mask cases included.

Bars: class ids, validity, the positive/negative choice and the mask
targets bit-equal; rois, deltas and losses to 1e-5 relative (the sums
run in another order than XLA's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_maskrcnn_tpu.models import losses as jl
from slam_maskrcnn_tpu.models.targets import (build_rpn_targets as j_rpn,
                                              detection_targets as j_targets)
from slam_maskrcnn_tpu_torch.models import losses as tl
from slam_maskrcnn_tpu_torch.models.targets import (build_rpn_targets,
                                                    detection_targets)

torch.set_num_threads(2)


def _scene(seed, B=2, P=96, G=5, m=56):
    rng = np.random.default_rng(seed)
    gt = np.zeros((B, G, 4), np.float32)
    cls = np.zeros((B, G), np.int32)
    masks = np.zeros((B, G, m, m), np.float32)
    props = np.zeros((B, P, 4), np.float32)
    yy, xx = np.mgrid[:m, :m]
    for b in range(B):
        n = G - 1 - b                    # padding rows at the end
        c = rng.uniform(0.2, 0.8, (n, 2))
        hw = rng.uniform(0.1, 0.35, (n, 2))
        gt[b, :n] = np.concatenate([c - hw / 2, c + hw / 2], 1)
        cls[b, :n] = rng.integers(1, 4, n)
        cls[b, n - 1] = -1               # a crowd box
        for g in range(n):
            cy, cx, r = rng.uniform(15, 40, 3)
            masks[b, g] = ((yy - cy) ** 2 + (xx - cx) ** 2) < (r * 0.6) ** 2
        k = P - 10                       # the rest stays zero padding
        src = gt[b, rng.integers(0, n, k)]
        jit = rng.normal(0, 0.04, (k, 4)).astype(np.float32)
        props[b, :k] = np.clip(src + jit, 0, 1)
        props[b, :k, 2:] = np.maximum(props[b, :k, 2:],
                                      props[b, :k, :2] + 0.01)
    return props, cls, gt, masks


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detection_targets_match_jax(seed):
    props, cls, gt, masks = _scene(seed)
    B, P = props.shape[:2]
    rois, tcls, tdel, tmask, tvalid = [], [], [], [], []
    noise = []
    for b in range(B):
        key = jax.random.PRNGKey(100 * seed + b)
        out = j_targets(key, jnp.asarray(props[b]), jnp.asarray(cls[b]),
                        jnp.asarray(gt[b]), jnp.asarray(masks[b]),
                        train_rois=24, positive_ratio=0.33, mask_size=28)
        for lst, x in zip((rois, tcls, tdel, tmask, tvalid), out):
            lst.append(np.asarray(x))
        k1, k2 = jax.random.split(key)
        noise.append((np.asarray(jax.random.uniform(k1, (P,))),
                      np.asarray(jax.random.uniform(k2, (P,)))))
    pos = torch.from_numpy(np.stack([n[0] for n in noise]))
    neg = torch.from_numpy(np.stack([n[1] for n in noise]))
    t = lambda a: torch.from_numpy(np.asarray(a))
    got = detection_targets(t(props), t(cls), t(gt), t(masks), pos, neg,
                            train_rois=24, positive_ratio=0.33, mask_size=28)
    want = [np.stack(x) for x in (rois, tcls, tdel, tmask, tvalid)]
    g = [x.numpy() for x in got]
    np.testing.assert_array_equal(g[4], want[4])          # valid
    np.testing.assert_array_equal(g[1], want[1])          # class ids
    assert g[1].dtype == want[1].dtype
    np.testing.assert_allclose(g[0], want[0], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(g[2], want[2], rtol=1e-5, atol=1e-5)
    n_pos = int((want[1] > 0).sum())
    assert n_pos >= 8 and want[4][:, 8:].sum() >= 10, "fixture: +/- rois"
    np.testing.assert_array_equal(g[3], want[3])          # masks
    assert g[3].sum() > 100


def test_build_rpn_targets_matches_jax():
    class Cfg:
        RPN_TRAIN_ANCHORS_PER_IMAGE = 32
        RPN_BBOX_STD_DEV = np.array([0.1, 0.1, 0.2, 0.2])
    rng = np.random.default_rng(4)
    a = rng.uniform(0, 100, (300, 2))
    anchors = np.concatenate([a, a + rng.uniform(5, 30, (300, 2))], 1)
    gt = np.array([[10, 10, 40, 50], [50, 60, 90, 95], [0, 0, 20, 20]],
                  np.float32)
    ids = np.array([1, 2, -1], np.int32)
    np.random.seed(3)
    jm, jb = j_rpn(anchors, ids, gt, Cfg)
    np.random.seed(3)
    tm, tb = build_rpn_targets(anchors, ids, gt, Cfg)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tb, jb)
    assert (tm == 1).sum() > 0 and (tm == -1).sum() > 0


def _loss_inputs(seed, positives=True, rpn_used=True):
    rng = np.random.default_rng(seed)
    B, A, T, C, m = 2, 50, 12, 4, 28
    rpn_match = rng.integers(-1, 2, (B, A)).astype(np.int32)
    if not rpn_used:
        rpn_match[:] = 0
    cls = rng.integers(0, C, (B, T)).astype(np.int32)
    if not positives:
        cls[:] = 0
    return dict(
        outputs=dict(
            rpn_class_logits=rng.normal(0, 2, (B, A, 2)).astype(np.float32),
            rpn_bbox=rng.normal(0, 1, (B, A, 4)).astype(np.float32),
            mrcnn_class_logits=rng.normal(0, 2, (B, T, C)).astype(np.float32),
            mrcnn_bbox=rng.normal(0, 1, (B, T, C, 4)).astype(np.float32),
            mrcnn_masks=rng.uniform(0, 1, (B, T, m, m, C)).astype(np.float32)),
        targets=dict(
            rpn_match=rpn_match,
            rpn_bbox=rng.normal(0, 1, (B, A, 4)).astype(np.float32),
            target_class_ids=cls,
            target_bbox=rng.normal(0, 1, (B, T, 4)).astype(np.float32),
            target_mask=(rng.uniform(0, 1, (B, T, m, m)) < 0.5)
            .astype(np.float32),
            active_class_ids=np.array([[1, 1, 0, 1], [1, 1, 1, 1]],
                                      np.int32),
            roi_valid=rng.uniform(0, 1, (B, T)) < 0.8))


@pytest.mark.parametrize("case", ["full", "no_positives", "no_rpn_anchors"])
def test_losses_match_jax(case):
    d = _loss_inputs(3, positives=case != "no_positives",
                     rpn_used=case != "no_rpn_anchors")
    lw = {"rpn_class_loss": 1.0, "rpn_bbox_loss": 2.0,
          "mrcnn_class_loss": 1.0, "mrcnn_bbox_loss": 0.5,
          "mrcnn_mask_loss": 1.0}
    jt, jparts = jl.total_loss(
        {k: jnp.asarray(v) for k, v in d["outputs"].items()},
        {k: jnp.asarray(v) for k, v in d["targets"].items()}, lw)
    tt, tparts = tl.total_loss(
        {k: torch.from_numpy(v) for k, v in d["outputs"].items()},
        {k: torch.from_numpy(v) for k, v in d["targets"].items()}, lw)
    for k in jparts:
        np.testing.assert_allclose(float(tparts[k]), float(jparts[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-5)
    if case == "no_positives":
        assert float(tparts["mrcnn_bbox_loss"]) == 0.0
        assert float(tparts["mrcnn_mask_loss"]) == 0.0
    if case == "no_rpn_anchors":
        assert float(tparts["rpn_class_loss"]) == 0.0
        assert float(tparts["rpn_bbox_loss"]) == 0.0
    assert float(tt) > 0


def test_loss_gradients_match_jax():
    """The gradient of total_loss with respect to every head output."""
    d = _loss_inputs(5)
    tgt_j = {k: jnp.asarray(v) for k, v in d["targets"].items()}
    gj = jax.grad(lambda o: jl.total_loss(o, tgt_j)[0])(
        {k: jnp.asarray(v) for k, v in d["outputs"].items()})
    outs = {k: torch.from_numpy(v).requires_grad_()
            for k, v in d["outputs"].items()}
    tl.total_loss(outs, {k: torch.from_numpy(v)
                         for k, v in d["targets"].items()})[0].backward()
    for k, v in outs.items():
        want = np.asarray(gj[k])
        np.testing.assert_allclose(v.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-6 * np.abs(want).max(), err_msg=k)
