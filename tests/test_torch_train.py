"""The port's Mask R-CNN training against the JAX package's on the CPU, at
tests/test_train.py's TrainConfig (ResNet-50, 128^2, batch 2, 64 training
proposals, 16 training rois, float32):

* one step from the same variables (numpy-seeded, carried by
  load_jax_params), batch and target-sampling draws (the JAX step's own
  jax.random.uniform draws), for each of the five layer regexes with
  TRAIN_BN off and on: the loss parts, every updated parameter, the
  frozen ones untouched, and with TRAIN_BN the running BatchNorm
  statistics. The JAX side is its Trainer's step for "all" (frozen BN)
  and, for the other nine, the same loss and gradient jitted once per BN
  mode with that step's mask, optax clip_by_global_norm and sgd applied
  to it (checked equal to the Trainer's step, to an ulp, where both
  run);
* the freeze masks of the five regexes, parameter by parameter;
* the epoch resume from find_last, the GPU_COUNT > 1 refusal outside a
  process group of that size;
* the h5 writer: a file written by the port read back by h5py, by the
  JAX package's strict load_h5_weights and by the port's.

Tolerances: loss parts 3e-3 relative plus 1e-5 absolute (the RPN's
deltas differ by 4e-5 with the convolutions' summation order, so the
rois by 3e-7; the box loss's targets are their deltas to gt boxes 0.02
wide, divided by std 0.1-0.2, and differ by 2.3e-3 relative here; the
other parts agree to 1e-5); updated parameters 2e-6 absolute (a step
moves them by up to ~1e-3; the convolutions and sums run in another
order than XLA's), and the update's norm to 5e-3; running statistics
1e-4 of their largest value.

With TRAIN_BN a layer's batch statistics come from two images: the
summation order's 1e-5 relative (bn_conv1 alone, on the same input)
grows, through the backward pass over the backbone's batch-statistics
layers, to 0.3% ("5+"), 2.9% ("3+") and 5.6% ("all") of the update's
norm, and a conv bias ahead of such a layer has a true gradient of 0
and a computed one of rounding noise. Those three cases hold the whole
update to 10% in norm, "heads" per element as above;
``test_batchnorm_train_matches_flax`` holds the layer itself to Flax's
to 1e-5."""

import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from slam_maskrcnn_tpu.data.dataset import data_generator as j_generator
from slam_maskrcnn_tpu.data.shapes import ShapesDataset as JShapes
from slam_maskrcnn_tpu.models import MaskRCNN as JMaskRCNN
from slam_maskrcnn_tpu.models.anchors import get_anchors
from slam_maskrcnn_tpu.models.import_h5 import load_h5_weights as j_load_h5
from slam_maskrcnn_tpu.models.losses import total_loss as j_total_loss
from slam_maskrcnn_tpu.train.trainer import (LAYER_REGEX as J_REGEX,
                                             Trainer as JTrainer,
                                             l2_regularization as j_l2,
                                             trainable_mask as j_mask)
from slam_maskrcnn_tpu_torch.data.shapes import ShapesConfig
from slam_maskrcnn_tpu_torch.data.shapes import ShapesDataset
from slam_maskrcnn_tpu_torch.models.h5 import keras_weights, save_h5_weights
from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
from slam_maskrcnn_tpu_torch.models.weights import (flax_path,
                                                    flax_variables,
                                                    load_jax_params)
from slam_maskrcnn_tpu_torch.train import checkpoint as ckpt
from slam_maskrcnn_tpu_torch.train.trainer import (LAYER_REGEX, Trainer,
                                                   batch_to_device,
                                                   trainable_mask)
from test_torch_north_star import _variables
from test_train import TrainConfig as JTrainConfig

torch.set_num_threads(2)

LR = 0.002
LAYERS = ["heads", "3+", "4+", "5+", "all"]


class TrainConfig(ShapesConfig):
    """= tests/test_train.py TrainConfig."""
    NAME = "shapes_train_test"
    IMAGES_PER_GPU = 2
    GPU_COUNT = 1
    IMAGE_MIN_DIM = 128
    IMAGE_MAX_DIM = 128
    RPN_ANCHOR_SCALES = (8, 16, 32, 64, 128)
    TRAIN_ROIS_PER_IMAGE = 16
    POST_NMS_ROIS_TRAINING = 64
    PRE_NMS_LIMIT = 256
    MAX_GT_INSTANCES = 4
    STEPS_PER_EPOCH = 2
    COMPUTE_DTYPE = "float32"


def _cfgs(train_bn):
    j = type("J", (JTrainConfig,), dict(TRAIN_BN=train_bn))()
    t = type("T", (TrainConfig,), dict(TRAIN_BN=train_bn))()
    return j, t


def _walk(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


@pytest.fixture(scope="module")
def setup():
    """Variables, a batch and the draws of one step; the JAX loss and
    gradient jitted per BN mode."""
    jcfg, _ = _cfgs(False)
    jm = JMaskRCNN("training", jcfg)
    v = _variables(jm, 21)
    # RPN heads small: proposals near their anchors, so that some rois are
    # positive and every loss has work
    rpn = v["params"]["rpn_model"]
    rpn["rpn_class_raw"]["kernel"] *= 0.05
    rpn["rpn_bbox_pred"]["kernel"] *= 0.05
    cls = v["params"]["fpn_classifier"]
    cls["mrcnn_class_logits"]["kernel"] *= 0.05
    cls["mrcnn_bbox_fc"]["kernel"] *= 0.05
    # TRAIN_BN: the RPN's output layers zeroed but for an objectness bias
    # by anchor ratio, so that the proposals are the anchors, squares
    # first, on both sides (batch statistics over two images carry the
    # summation order's 1e-5 a layer to 1e-3 relative at C5, enough to
    # reorder random RPN scores and so the sampled rois)
    v_bn = jax.tree.map(np.copy, v)
    rpn_bn = v_bn["params"]["rpn_model"]
    for head in ("rpn_class_raw", "rpn_bbox_pred"):
        rpn_bn[head]["kernel"][:] = 0
        rpn_bn[head]["bias"][:] = 0
    rpn_bn["rpn_class_raw"]["bias"][1::2] = (1.0, 2.0, 0.0)
    variables = {False: v, True: v_bn}
    ds = JShapes()
    ds.load_shapes(6, 128, 128, seed=3)
    ds.prepare()
    np.random.seed(0)
    batch = next(j_generator(ds, jcfg, seed=1))
    anchors = get_anchors(jcfg, jcfg.IMAGE_SHAPE)
    # random RPN heads propose few boxes near the shapes: make the gt boxes
    # two proposals of each BN mode (the port's, equal to the JAX ones to
    # 1e-6), shrunk a little, so that every loss has positive rois
    batch["gt_boxes"] = _proposal_gt(variables, batch, anchors)
    batch["gt_class_ids"][:] = [1, 2, 3, 1]
    empty = batch["gt_masks"].sum((2, 3)) == 0
    batch["gt_masks"][empty] = batch["gt_masks"][0, 0]
    rng = jax.random.PRNGKey(7)
    B, P = 2, jcfg.POST_NMS_ROIS_TRAINING
    draws = [jax.random.split(k) for k in jax.random.split(rng, B)]
    pos = np.stack([np.asarray(jax.random.uniform(k[0], (P,))) for k in draws])
    neg = np.stack([np.asarray(jax.random.uniform(k[1], (P,))) for k in draws])
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    jb["anchors"] = jnp.asarray(anchors)
    module = jm.module

    def loss_fn(p, variables, train_bn):
        # the JAX Trainer's loss_fn (trainer.py:104-124)
        var = dict(variables, params=p)
        kw = dict(train_rois=jcfg.TRAIN_ROIS_PER_IMAGE,
                  positive_ratio=jcfg.ROI_POSITIVE_RATIO,
                  method=module.train_forward)
        args = (jb["images"], jb["anchors"], rng, jb["gt_class_ids"],
                jb["gt_boxes"], jb["gt_masks"])
        if train_bn:
            (outputs, targets), mut = module.apply(
                var, *args, train_bn=True, mutable=["batch_stats"], **kw)
        else:
            outputs, targets = module.apply(var, *args, **kw)
            mut = {}
        targets["rpn_match"] = jb["rpn_match"]
        targets["rpn_bbox"] = jb["rpn_bbox"]
        targets["active_class_ids"] = jb["active_class_ids"]
        loss, parts = j_total_loss(outputs, targets, jcfg.LOSS_WEIGHTS)
        loss = loss + j_l2(p, jcfg.WEIGHT_DECAY)
        return loss, (parts, mut)

    grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True),
                   static_argnums=2)
    graded = {}
    for bn in (False, True):
        jv = jax.tree.map(jnp.asarray, variables[bn])
        graded[bn] = grad(jv["params"], jv, bn)
    return dict(v=v, variables=variables, batch=batch, anchors=anchors,
                rng=rng, jb=jb, pos=pos, neg=neg, graded=graded, jm=jm)


def _proposal_gt(variables, batch, anchors):
    from slam_maskrcnn_tpu_torch.models.proposal import generate_proposals
    gt = np.zeros_like(batch["gt_boxes"])
    for k, bn in enumerate((False, True)):
        _, tcfg = _cfgs(bn)
        tm = MaskRCNN("training", tcfg, device="cpu")
        load_jax_params(variables[bn], tm, device="cpu")
        m = tm.module.train(bn)
        with torch.no_grad():
            pyr = m.features(torch.from_numpy(batch["images"]))
            _, probs, deltas = m.rpn_outputs(pyr)
            props, _ = generate_proposals(
                probs, deltas, torch.from_numpy(anchors), m.proposal_count,
                m.rpn_nms_threshold, m.pre_nms_limit, m.rpn_bbox_std)
        # two of them a few apart
        for b in range(props.shape[0]):
            box = props[b, [0, 4]].numpy()
            # shrunk by 10% about its centre: IoU 0.81 with the roi, and
            # no mask-target sample on the gt box's edge
            c, hw = (box[:, :2] + box[:, 2:]) / 2, box[:, 2:] - box[:, :2]
            gt[b, 2 * k:2 * k + 2] = np.concatenate(
                [c - 0.45 * hw, c + 0.45 * hw], 1)
    return gt


def _jax_step(setup, layers, train_bn):
    """The JAX reference step from the jitted loss and gradient: the
    trainer's freeze mask, optax clip_by_global_norm + sgd. Returns
    (variables, loss, parts)."""
    jcfg, _ = _cfgs(train_bn)
    (loss, (parts, mut)), grads = setup["graded"][train_bn]
    v = jax.tree.map(jnp.asarray, setup["variables"][train_bn])
    params = v["params"]
    grads = jax.tree.map(lambda g, m: g * m, grads,
                         j_mask(params, J_REGEX[layers]))
    opt = optax.chain(optax.clip_by_global_norm(jcfg.GRADIENT_CLIP_NORM),
                      optax.sgd(LR, momentum=jcfg.LEARNING_MOMENTUM))
    updates, _ = opt.update(grads, opt.init(params), params)
    out = dict(v, params=optax.apply_updates(params, updates))
    if train_bn:
        out["batch_stats"] = mut["batch_stats"]
    return jax.tree.map(np.asarray, out), float(loss), parts


def _port_step(setup, layers, train_bn):
    _, tcfg = _cfgs(train_bn)
    tm = MaskRCNN("training", tcfg, device="cpu")
    load_jax_params(setup["variables"][train_bn], tm, device="cpu")
    step = Trainer(tm).make_step(LR, LAYER_REGEX[layers])
    b = batch_to_device(setup["batch"], "cpu")
    b["anchors"] = torch.from_numpy(setup["anchors"])
    loss, parts = step(b, torch.from_numpy(setup["pos"]),
                       torch.from_numpy(setup["neg"]))
    return tm, float(loss), parts


def test_decomposed_step_is_the_trainer_step(setup):
    """The JAX Trainer's own step ("all", frozen BN) equals the reference
    the other cases use: the same loss, parameters within an ulp (XLA
    fuses the update into the step's program there and runs it eagerly
    here)."""
    jcfg, _ = _cfgs(False)
    jm = setup["jm"]
    step, opt = JTrainer(jm, jcfg)._make_step(LR, J_REGEX["all"])
    v = jax.tree.map(jnp.asarray, setup["v"])
    v2, _, loss, parts = step(v, opt.init(v["params"]), setup["rng"],
                              setup["jb"])
    want, wloss, wparts = _jax_step(setup, "all", False)
    assert float(loss) == wloss
    for k, w in wparts.items():
        assert float(parts[k]) == float(w), k
    for path, a in _walk(jax.tree.map(np.asarray, v2)):
        np.testing.assert_allclose(a, _at(want, path), rtol=2e-7,
                                   atol=1e-9)


@pytest.mark.parametrize("train_bn", [False, True])
@pytest.mark.parametrize("layers", LAYERS)
def test_train_step_matches_jax(setup, layers, train_bn):
    want, wloss, wparts = _jax_step(setup, layers, train_bn)
    tm, loss, parts = _port_step(setup, layers, train_bn)
    for k, w in wparts.items():
        np.testing.assert_allclose(float(parts[k]), float(w), rtol=3e-3,
                                   atol=1e-5, err_msg=k)
    assert float(wparts["mrcnn_mask_loss"]) > 0, "fixture: positive rois"
    np.testing.assert_allclose(loss, wloss, rtol=3e-3)
    got = flax_variables(tm)
    before = setup["variables"][train_bn]
    mask = trainable_mask(tm, LAYER_REGEX[layers])
    # with TRAIN_BN, a gradient that crosses the backbone's batch-statistics
    # BatchNorm layers is held in norm (see the module docstring)
    per_element = not train_bn or layers == "heads"
    n_moved, num, den = 0, 0.0, 0.0
    for name in mask:
        path = flax_path(tm.module, name)
        g, w, b = _at(got, path), _at(want, path), _at(before, path)
        if mask[name]:
            if per_element:
                np.testing.assert_allclose(g, w, rtol=0, atol=2e-6,
                                           err_msg=str(path))
            num += float(((g.astype(np.float64) - w) ** 2).sum())
            den += float(((w.astype(np.float64) - b) ** 2).sum())
            n_moved += int((w != b).any())
        else:
            np.testing.assert_array_equal(g, b, err_msg=str(path))
            np.testing.assert_array_equal(w, b, err_msg=str(path))
    assert n_moved > 10
    assert np.sqrt(num / den) <= (5e-3 if per_element else 0.1)
    stats = [(p, a) for p, a in _walk(got) if p[0] == "batch_stats"]
    for path, a in stats:
        w, b = _at(want, path), _at(before, path)
        if train_bn:
            np.testing.assert_allclose(a, w, rtol=0,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=str(path))
            assert not np.array_equal(a, b)
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mean,shape", [(0.0, (2, 8, 8, 16)),
                                        (2.0, (2, 8, 8, 16)),
                                        (0.0, (32, 1, 1, 64))])
def test_batchnorm_train_matches_flax(mean, shape):
    """The batch-statistics BatchNorm against Flax's (epsilon 1e-3,
    momentum 0.99, fast variance) on one input: output, running
    statistics and the input's gradient to 1e-5 of their scale."""
    import flax.linen as nn
    from slam_maskrcnn_tpu_torch.models.backbone import BatchNorm

    rng = np.random.default_rng(int(mean) + shape[0])
    C = shape[-1]
    x = rng.normal(mean, 1.0, shape).astype(np.float32)
    r = rng.normal(0, 1.0, shape).astype(np.float32)    # d loss / d y
    params = {"scale": rng.uniform(0.8, 1.2, C).astype(np.float32),
              "bias": rng.normal(0, 0.1, C).astype(np.float32)}
    stats = {"mean": rng.normal(0, 0.1, C).astype(np.float32),
             "var": rng.uniform(0.8, 1.2, C).astype(np.float32)}
    bn = nn.BatchNorm(use_running_average=False, epsilon=1e-3,
                      momentum=0.99)

    def f(xx):
        y, mut = bn.apply({"params": params, "batch_stats": stats}, xx,
                          mutable=["batch_stats"])
        return (y * r).sum(), (y, mut)

    (_, (jy, mut)), jg = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    t = BatchNorm(C).train(True)
    with torch.no_grad():
        for k, v in {**params, **stats}.items():
            getattr(t, k).copy_(torch.from_numpy(v))
    xt = torch.from_numpy(x).requires_grad_()
    ty = t(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    (ty * torch.from_numpy(r)).sum().backward()
    close = lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), rtol=0, atol=1e-5 * float(np.abs(b).max()))
    close(ty.detach().numpy(), jy)
    close(t.mean.numpy(), mut["batch_stats"]["mean"])
    close(t.var.numpy(), mut["batch_stats"]["var"])
    close(xt.grad.numpy(), jg)


@pytest.mark.parametrize("layers", LAYERS)
def test_trainable_mask_matches_jax(setup, layers):
    _, tcfg = _cfgs(False)
    tm = MaskRCNN("training", tcfg, device="cpu")
    got = trainable_mask(tm, LAYER_REGEX[layers])
    want = dict(_walk(j_mask(setup["v"]["params"], J_REGEX[layers])))
    assert len(got) == len(want)
    for name, m in got.items():
        assert m == float(want[flax_path(tm.module, name)[1:]]), name
    if layers != "all":
        assert 0 < sum(got.values()) < len(got)


def test_training_mode_and_refusals(tmp_path):
    _, tcfg = _cfgs(False)
    tm = MaskRCNN("training", tcfg, device="cpu")
    assert tm.module.proposal_count == tcfg.POST_NMS_ROIS_TRAINING
    assert MaskRCNN("inference", tcfg, device="cpu").module.proposal_count \
        == tcfg.POST_NMS_ROIS_INFERENCE
    multi = type("M", (TrainConfig,), dict(GPU_COUNT=2))()
    ds = ShapesDataset()
    ds.load_shapes(2, 128, 128)
    ds.prepare()
    # data-parallel training needs a process group of GPU_COUNT ranks
    with pytest.raises(RuntimeError, match="GPU_COUNT = 2"):
        Trainer(MaskRCNN("training", multi, device="cpu")).train(ds)
    with pytest.raises(ValueError, match="mode"):
        MaskRCNN("testing", tcfg, device="cpu")


def test_train_epochs_and_resume_from_find_last(setup, tmp_path):
    """Two epochs of one step through MaskRCNN.train write a checkpoint
    each in a dated run directory; a new model resumes from the newest at
    its epoch and with its tensors."""
    _, tcfg = _cfgs(False)
    tcfg.STEPS_PER_EPOCH = 1
    tm = MaskRCNN("training", tcfg, model_dir=str(tmp_path), device="cpu")
    load_jax_params(setup["v"], tm, device="cpu")
    ds = ShapesDataset()
    ds.load_shapes(4, 128, 128, seed=3)
    ds.prepare()
    hist = tm.train(ds, learning_rate=LR, epochs=2, layers="heads",
                    verbose=0)
    assert len(hist) == 2 and np.isfinite(hist).all()
    last = tm.find_last()
    assert last.endswith("_0002") and ckpt.epoch_from_path(last) == 2
    assert len(os.listdir(os.path.dirname(last))) == 2
    tm2 = MaskRCNN("training", tcfg, model_dir=str(tmp_path), device="cpu")
    tr = Trainer(tm2)
    assert tr.load_weights("last", model_dir=str(tmp_path)) == last
    assert tr.epoch == 2 and tr.run_directory == os.path.dirname(last)
    for (n, a), (_, b) in zip(tm.module.state_dict().items(),
                              tm2.module.state_dict().items()):
        assert torch.equal(a, b), n
    assert tr.train(ds, epochs=2, verbose=0) == []   # nothing left to do


def test_h5_writer_read_by_h5py_jax_and_port(setup, tmp_path):
    """A Keras-layout h5 written by the port: h5py sees every layer group
    and dataset with the Keras names, shapes and values; the JAX package's
    strict loader fills its variables with the port's values; the port's
    strict loader restores every tensor."""
    _, tcfg = _cfgs(False)
    tm = MaskRCNN("inference", tcfg, device="cpu")
    load_jax_params(setup["v"], tm, device="cpu")
    path = save_h5_weights(str(tmp_path / "w.h5"), tm)
    want = keras_weights(tm)
    n = 0
    with h5py.File(path, "r") as f:
        assert set(f["model_weights"]) == set(want)
        for layer, weights in want.items():
            g = f["model_weights"][layer][layer]
            assert set(g) == set(weights)
            for name, arr in weights.items():
                np.testing.assert_array_equal(g[name][...], arr)
                n += 1
    assert n == len(list(tm.module.parameters())) + len(
        list(tm.module.buffers()))
    jm = JMaskRCNN("inference", _cfgs(False)[0])
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                         jax.tree.map(np.asarray, setup["v"]))
    loaded = j_load_h5(path, zeros, strict=True)
    del jm
    for p, a in _walk(flax_variables(tm)):
        np.testing.assert_array_equal(_at(loaded, p), a, err_msg=str(p))
    back = MaskRCNN("inference", tcfg, device="cpu")
    back.load_weights(path)
    for (k, a), (_, b) in zip(tm.module.state_dict().items(),
                              back.module.state_dict().items()):
        assert torch.equal(a, b), k
