"""The balloon smoke gate's first steps in both packages, side by side.

Not collected by pytest (no ``test_`` prefix). On the CPU, the JAX
package's balloon training config (float32, TRAIN_BN, "square" at
``--size``) and the port's train from the same variables (the JAX init,
carried into the port by ``models/weights.load_jax_params``) on the same
batches (one data generator feeds both) and the same target-sampling
draws (the JAX step's own ``jax.random.uniform``; the port gets them as
``pos_noise`` / ``neg_noise``). Each step records, for each package, the
five loss components, the positive rois the detection-target layer kept,
the mean of their mask targets and the norm of the mask head's gradient;
before the first step, both packages' RPN outputs and proposals on its
batch are set side by side, with BatchNorm frozen and in train mode.
The JAX step is its Trainer's (loss, gradient, optax clip and sgd)
written out so that it also returns those three diagnostics.

    JAX_PLATFORMS=cpu python tests/jax_smoke_side_by_side.py \\
        --steps 25 --out build/smoke_side_by_side.json

At 1024^2 (the gate's size) a step takes minutes of CPU in each package.
With ``--layers`` it runs no step: both packages' first forward in
train-mode BatchNorm on the first batch, every BatchNorm's output against
a float64 reference (``first_forward_layers``; about 3 minutes):

    JAX_PLATFORMS=cpu python tests/jax_smoke_side_by_side.py --layers \\
        --out build/smoke_first_forward.json
"""

from __future__ import annotations

import argparse
import copy
import functools
import json
import math
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

STEM = "resnet.bn_conv1"
PARTS = ("rpn_class_loss", "rpn_bbox_loss", "mrcnn_class_loss",
         "mrcnn_bbox_loss", "mrcnn_mask_loss")


def configs(size: int):
    from slam_maskrcnn_tpu.samples.balloon import BalloonConfig as JBalloon
    from slam_maskrcnn_tpu_torch.samples.balloon import BalloonConfig

    over = dict(COMPUTE_DTYPE="float32", TRAIN_BN=True)
    if size != 1024:
        over.update(IMAGE_MIN_DIM=size, IMAGE_MAX_DIM=size)
    return (type("JSmoke", (JBalloon,), over)(),
            type("TSmoke", (BalloonConfig,), over)())


def jax_step_fn(jm, cfg, lr):
    """The JAX Trainer's step (trainer.py:85-137, layers "all", TRAIN_BN)
    returning the diagnostics beside the loss parts."""
    from slam_maskrcnn_tpu.models.losses import total_loss
    from slam_maskrcnn_tpu.train.trainer import l2_regularization

    module = jm.module
    opt = optax.chain(optax.clip_by_global_norm(cfg.GRADIENT_CLIP_NORM),
                      optax.sgd(lr, momentum=cfg.LEARNING_MOMENTUM))

    @jax.jit
    def step(variables, opt_state, rng, batch):
        def loss_fn(p):
            (outputs, targets), mut = module.apply(
                dict(variables, params=p), batch["images"], batch["anchors"],
                rng, batch["gt_class_ids"], batch["gt_boxes"],
                batch["gt_masks"], train_rois=cfg.TRAIN_ROIS_PER_IMAGE,
                positive_ratio=cfg.ROI_POSITIVE_RATIO, train_bn=True,
                mutable=["batch_stats"], method=module.train_forward)
            targets["rpn_match"] = batch["rpn_match"]
            targets["rpn_bbox"] = batch["rpn_bbox"]
            targets["active_class_ids"] = batch["active_class_ids"]
            loss, parts = total_loss(outputs, targets, cfg.LOSS_WEIGHTS)
            loss = loss + l2_regularization(p, cfg.WEIGHT_DECAY)
            pos = targets["target_class_ids"] > 0
            n = jnp.sum(pos)
            tmean = (jnp.sum(targets["target_mask"].mean((-1, -2)) * pos)
                     / jnp.maximum(n, 1))
            return loss, (parts, mut, n, tmean)

        (loss, (parts, mut, n, tmean)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(variables["params"])
        gnorm = jnp.sqrt(sum(jnp.sum(g * g) for g in
                             jax.tree.leaves(grads["fpn_mask"])))
        updates, opt_state = opt.update(grads, opt_state,
                                        variables["params"])
        params = optax.apply_updates(variables["params"], updates)
        variables = dict(variables, params=params,
                         batch_stats=mut["batch_stats"])
        return variables, opt_state, loss, parts, n, tmean, gnorm

    return step, opt


def first_proposals(jm, jvars, tm, batch, anchors, cfg) -> dict:
    """Both packages' RPN outputs and proposals on one batch from the same
    variables, before any step, with BatchNorm frozen and in train mode
    (TRAIN_BN): the largest difference of the RPN probabilities, and how
    many proposal slots hold the same box to 1e-4 (near-tied scores
    reorder under the backbones' ulps)."""
    from slam_maskrcnn_tpu.models.proposal import \
        generate_proposals as j_proposals
    from slam_maskrcnn_tpu_torch.models.proposal import generate_proposals

    module = jm.module
    out = {}
    for train in (False, True):
        def j_fn(v, images):
            if train:
                pyr = module.apply(v, images, True, method=module.features,
                                   mutable=["batch_stats"])[0]
            else:
                pyr = module.apply(v, images, False, method=module.features)
            _, probs, deltas = module.apply(v, pyr,
                                            method=module.rpn_outputs)
            return probs, deltas

        jp, jd = jax.jit(j_fn)(jvars, jnp.asarray(batch["images"]))
        jprops, _ = j_proposals(jp, jd, jnp.asarray(anchors),
                                cfg.POST_NMS_ROIS_TRAINING,
                                cfg.RPN_NMS_THRESHOLD, cfg.PRE_NMS_LIMIT,
                                np.asarray(cfg.RPN_BBOX_STD_DEV, np.float32))
        m = tm.module.train(train)
        with torch.no_grad():
            _, tp, td = m.rpn_outputs(m.features(torch.from_numpy(
                batch["images"])))
            tprops, _ = generate_proposals(
                tp, td, torch.from_numpy(anchors), m.proposal_count,
                m.rpn_nms_threshold, m.pre_nms_limit, m.rpn_bbox_std)
        m.eval()
        a, b = np.asarray(jprops), tprops.numpy()
        same = np.abs(a - b).max(-1) <= 1e-4
        out["train_bn" if train else "frozen_bn"] = dict(
            rpn_probs_max_abs_diff=float(np.abs(np.asarray(jp)
                                                - tp.numpy()).max()),
            rpn_deltas_max_abs_diff=float(np.abs(np.asarray(jd)
                                                 - td.numpy()).max()),
            slots_equal_to_1e4=float(same.mean()),
            first_differing_slot=[int(np.argmin(r)) if not r.all()
                                  else len(r) for r in same])
    return out


def _float64_copy(module):
    """A float64 copy of the port's module: parameters, the convolutions'
    compute dtype and every BatchNorm (train mode: the batch statistics by
    backbone.BatchNorm's formula, E[x^2] - E[x]^2, in float64)."""
    from slam_maskrcnn_tpu_torch.models.backbone import BatchNorm

    def bn64(bn, x):
        shape = (1, -1, 1, 1)
        mean = x.mean((0, 2, 3))
        var = ((x * x).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + bn.eps) * bn.scale
        return (x - mean.view(shape)) * mul.view(shape) + bn.bias.view(shape)

    m = copy.deepcopy(module).double().train(True)
    for mod in m.modules():
        if getattr(mod, "dtype", None) == torch.float32:
            mod.dtype = torch.float64
        if isinstance(mod, BatchNorm):
            mod.forward = functools.partial(bn64, mod)
    return m


def first_forward_layers(jm, jvars, tm, batch) -> dict:
    """Both packages' first forward with train-mode BatchNorm (TRAIN_BN) on
    one batch, layer by layer, against a float64 reference.

    The reference is the port's module in float64 (``_float64_copy``).
    For every BatchNorm in forward order: the largest difference of its
    output between the packages (float32), and each package's largest
    difference from the reference; with the largest cancellation E[x^2] /
    var over its channels (from the reference's input), by which the fast
    variance magnifies the relative rounding of E[x^2]. Then the same three
    for the RPN probabilities. If the JAX package's float32 output lies as
    close to the float64 reference as the port's own float32 output does,
    the packages compute one function and the gap between them is float32
    rounding that the network magnifies.

    ``stem``, a witness that needs no port code: both packages' conv1
    outputs against the reference's, and each package's first BatchNorm
    output against the float64 value of the formula (numpy) on that
    package's own conv1 output, beside what statistics summed in float32
    one element after another would give."""
    from slam_maskrcnn_tpu.models.backbone import BatchNorm as JBatchNorm
    from slam_maskrcnn_tpu_torch.models.backbone import BatchNorm

    module = jm.module

    @jax.jit
    def j_fn(v, images):
        pyr, mut = module.apply(
            v, images, True, method=module.features,
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda mdl, _: (isinstance(mdl, JBatchNorm)
                                                  or mdl.name == "conv1"))
        _, probs, _ = module.apply(v, pyr, method=module.rpn_outputs)
        return probs, mut["intermediates"]

    def j_layers(tree, prefix=()):
        for k, v in tree.items():
            if k == "__call__":
                yield ".".join(prefix), np.asarray(v[0])
            else:
                yield from j_layers(v, prefix + (k,))

    def port_forward(m, images):
        """(RPN probs, {BatchNorm: output as f32 NHWC}, {BatchNorm: the
        largest cancellation of its input}, forward order)."""
        outs, cancel, order = {}, {}, []

        def hook(name):
            def fn(mod, inp, out):
                x = inp[0].detach().double()
                ex = x.mean((0, 2, 3))
                ex2 = (x * x).mean((0, 2, 3))
                cancel[name] = float((ex2 / (ex2 - ex * ex).clamp_min(
                    1e-30)).max())
                outs[name] = out.detach().float().permute(
                    0, 2, 3, 1).numpy().copy()
                order.append(name)
                if name == STEM:
                    outs["conv1"] = inp[0].detach().double().permute(
                        0, 2, 3, 1).numpy()
            return fn

        hooks = [mod.register_forward_hook(hook(n))
                 for n, mod in m.named_modules()
                 if isinstance(mod, BatchNorm)]
        with torch.no_grad():
            _, probs, _ = m.rpn_outputs(m.features(images))
        for h in hooks:
            h.remove()
        return probs.double().numpy(), outs, cancel, order

    images = np.asarray(batch["images"], np.float32)
    ref_p, ref, cancel, order = port_forward(
        _float64_copy(tm.module), torch.from_numpy(images).double())
    tp, tl, _, _ = port_forward(tm.module.train(True),
                                torch.from_numpy(images))
    tm.module.eval()
    jp, jinter = j_fn(jvars, jnp.asarray(images))
    jl = dict(j_layers(jax.tree.map(np.asarray, jinter)))
    del jinter
    j_conv1 = jl.pop("resnet.conv1")
    if set(jl) != set(order):
        raise RuntimeError(f"BatchNorm layers differ: "
                           f"{sorted(set(jl) ^ set(order))}")

    gap = lambda a, b: float(np.abs(a.astype(np.float64) - b).max())
    layers = [dict(layer=n, shape=list(jl[n].shape),
                   jax_vs_port=gap(jl[n], tl[n]),
                   jax_vs_f64=gap(jl[n], ref[n]),
                   port_vs_f64=gap(tl[n], ref[n]),
                   max_cancellation=cancel[n]) for n in order]
    # the first BatchNorm of each package on its own input, in float64
    bn = jax.tree.map(np.asarray, jvars["params"]["resnet"]["bn_conv1"]["bn"])

    def bn64(x, one_pass_f32=False):
        x = x.astype(np.float64)
        if one_pass_f32:
            # the statistics as a float32 loop sums, one element after
            # another (cumsum does not pair)
            f = x.reshape(-1, x.shape[-1]).astype(np.float32)
            n = np.float32(f.shape[0])
            mean = np.cumsum(f, 0)[-1] / n
            var = np.cumsum(f * f, 0)[-1] / n - mean * mean
            mean, var = mean.astype(np.float64), var.astype(np.float64)
        else:
            mean = x.mean((0, 1, 2))
            var = (x * x).mean((0, 1, 2)) - mean * mean
        var = np.maximum(var, 0.0)
        return (x - mean) / np.sqrt(var + 1e-3) * bn["scale"] + bn["bias"]

    scale = float(np.abs(ref["conv1"]).max())
    stem = dict(
        conv1_rel=dict(jax_vs_f64=gap(j_conv1, ref["conv1"]) / scale,
                       port_vs_f64=gap(tl["conv1"], ref["conv1"]) / scale),
        bn_conv1_vs_f64_of_own_input=dict(
            jax=gap(jl[STEM], bn64(j_conv1)),
            port=gap(tl[STEM], bn64(tl["conv1"])),
            one_pass_f32_statistics=gap(bn64(j_conv1, True),
                                        bn64(j_conv1))))
    jp = np.asarray(jp)
    return dict(
        stem=stem, layers=layers,
        first_layer_past_1e5=next((r for r in layers
                                   if r["jax_vs_port"] > 1e-5), None),
        rpn_probs=dict(jax_vs_port=gap(jp, tp), jax_vs_f64=gap(jp, ref_p),
                       port_vs_f64=gap(tp.astype(np.float32), ref_p)))


def main(argv=None):
    from slam_maskrcnn_tpu.models import MaskRCNN as JMaskRCNN
    from slam_maskrcnn_tpu_torch.data.dataset import data_generator
    from slam_maskrcnn_tpu_torch.models.anchors import get_anchors
    from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from slam_maskrcnn_tpu_torch.models.weights import load_jax_params
    from slam_maskrcnn_tpu_torch.samples.balloon import BalloonDataset
    from slam_maskrcnn_tpu_torch.samples.sample_train_smoke import (
        attach_diagnostics, make_balloon_tree)
    from slam_maskrcnn_tpu_torch.train.trainer import (LAYER_REGEX, Trainer,
                                                       batch_to_device)

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--train-images", type=int, default=8)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(
        REPO, "build", "smoke_side_by_side.json"))
    ap.add_argument("--layers", action="store_true",
                    help="only first_forward_layers on the first batch")
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)

    jcfg, tcfg = configs(args.size)
    root = tempfile.mkdtemp()
    make_balloon_tree(root, n=args.train_images)
    ds = BalloonDataset()
    ds.load_balloon(root, "train")
    ds.prepare()

    jm = JMaskRCNN("training", jcfg)
    variables = jax.tree.map(np.asarray, jm.init_params(0))
    tm = MaskRCNN("training", tcfg, device="cpu")
    load_jax_params(variables, tm, "cpu")
    tm.initialized = True
    records = attach_diagnostics(tm)
    tstep = Trainer(tm, tcfg).make_step(args.lr, LAYER_REGEX["all"])
    jstep, opt = jax_step_fn(jm, jcfg, args.lr)
    jvars = jax.tree.map(jnp.asarray, variables)
    opt_state = opt.init(jvars["params"])

    anchors = get_anchors(tcfg, tcfg.IMAGE_SHAPE)
    np.random.seed(0)
    gen = data_generator(ds, tcfg, shuffle=True, seed=0)
    rng = jax.random.PRNGKey(0)
    B, P = tcfg.BATCH_SIZE, tcfg.POST_NMS_ROIS_TRAINING
    steps = []
    proposals = None
    if args.layers:
        out = first_forward_layers(jm, jvars, tm, next(gen))
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(json.dumps({k: v for k, v in out.items() if k != "layers"}))
        return
    for s in range(args.steps):
        t0 = time.time()
        batch = next(gen)
        rng, sub = jax.random.split(rng)
        draws = [jax.random.split(k) for k in jax.random.split(sub, B)]
        pos = torch.from_numpy(np.stack(
            [np.asarray(jax.random.uniform(k[0], (P,))) for k in draws]))
        neg = torch.from_numpy(np.stack(
            [np.asarray(jax.random.uniform(k[1], (P,))) for k in draws]))
        if proposals is None:
            proposals = first_proposals(jm, jvars, tm, batch, anchors, jcfg)
            print(json.dumps(proposals), flush=True)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jb["anchors"] = jnp.asarray(anchors)
        jvars, opt_state, jloss, jparts, jn, jmean, jg = jstep(
            jvars, opt_state, sub, jb)
        tj = time.time() - t0
        tb = batch_to_device(batch, "cpu")
        tb["anchors"] = torch.from_numpy(anchors)
        tloss, tparts = tstep(tb, pos, neg)
        r = records[-1]
        row = dict(
            step=s,
            jax={**{k: float(jparts[k]) for k in PARTS},
                 "loss": float(jloss), "positive_rois": int(jn),
                 "mask_target_mean": float(jmean),
                 "mask_grad_norm": float(jg)},
            port={**{k: float(tparts[k]) for k in PARTS},
                  "loss": float(tloss), "positive_rois": r["positive_rois"],
                  "mask_target_mean": r["mask_target_mean"],
                  "mask_grad_norm": math.sqrt(r["mask_grad_sq"])},
            seconds=dict(jax=round(tj, 1),
                         port=round(time.time() - t0 - tj, 1)))
        steps.append(row)
        print(json.dumps(row), flush=True)

    ln2 = math.log(2.0)
    out = dict(size=args.size, first_proposals=proposals, steps=steps)
    for side in ("jax", "port"):
        with_pos = [r[side]["mrcnn_mask_loss"] for r in steps
                    if r[side]["positive_rois"] > 0]
        out[f"{side}_mask_loss_mean_with_positives"] = (
            float(np.mean(with_pos)) if with_pos else None)
        out[f"{side}_mask_loss_within_0.02_of_ln2"] = (
            bool(with_pos) and all(abs(v - ln2) <= 0.02 for v in with_pos))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "steps"}))


if __name__ == "__main__":
    main()
