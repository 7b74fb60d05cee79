"""Training loop: SGD with momentum, gradient clipping, layer freezing, L2.

Port of slam_maskrcnn_tpu/train/trainer.py (``MaskRCNN.train`` /
``compile`` / ``set_trainable``, ``Mask_RCNN/mrcnn/model.py:2117-2330``):
SGD(lr, momentum 0.9, clipnorm 5), weight decay as an additive L2 on the
kernels (model.py:2134-2141), the layer-selection regexes
(model.py:2269-2280) and per-epoch checkpoints in dated run directories.

The step is the JAX package's (trainer.py:85-137) written out:

* the loss: the five losses of models/losses.py on ``train_forward``'s
  outputs, plus ``l2_regularization`` over every kernel, frozen ones
  included;
* the gradient of every parameter whose Flax path (models/weights.py
  ``flax_path``) has a component matching the layer regex; the others are
  frozen (their gradient is zero, as the JAX mask makes it; autograd
  skips computing it);
* optax's ``clip_by_global_norm``: g unchanged if the global norm is below
  GRADIENT_CLIP_NORM, else (g / norm) * GRADIENT_CLIP_NORM;
* optax's ``sgd(lr, momentum)``: trace = g + momentum * trace, then
  param += trace * (-lr).

With TRAIN_BN the module runs in train mode (batch-statistics BatchNorm,
running averages updated by the step); without, BatchNorm is frozen. A
float32 model runs the step with TF32 off, so "float32" is f32 on the
card too.

GPU_COUNT > 1 trains data-parallel, inside an initialized process group
of GPU_COUNT ranks (parallel/sharding.py ``launch``; a RuntimeError naming
both sizes otherwise): one step on the global batch of IMAGES_PER_GPU *
GPU_COUNT images, as the JAX package's jit over a sharded batch
(trainer.py:179-205). Every rank draws the same global batch and the same
target-sampling draws (a seed broadcast from rank 0) and keeps its slice,
so a per-image draw follows the global image index; each loss divides its
rank's numerator by the global count, rank 0 adds the L2 term, the
gradients are summed over the ranks and then clipped as one, and with
TRAIN_BN BatchNorm takes the global batch's statistics
(``batch_stats_over``). Averaging per-rank means instead would be wrong
wherever the ranks hold different counts of positive anchors or rois.
Only rank 0 prints and writes checkpoints.

``Trainer.steps`` is the step loop of ``train`` as an iterator, one
``StepRecord`` a step: what a caller that drives training step by step
(the benchmark) needs to time and to check one step. Under a profiler the
step records the port's spans (utils/profiling.py): the root
``train_step``; ``batch`` (the data generator's next batch and the
target-sampling draws), ``upload``, ``train_forward`` (its sub-layers in
models/mask_rcnn.py), ``loss``, ``backward``, ``optimizer`` (the clip and
SGD); the host read-backs ``sync.train.clip`` and ``sync.train.loss``
and the batch's uploads ``sync.train.upload``.
"""

from __future__ import annotations

import dataclasses
import os
import re
import time

import numpy as np
import torch

from slam_maskrcnn_tpu_torch.models.anchors import get_anchors
from slam_maskrcnn_tpu_torch.models.losses import total_loss
from slam_maskrcnn_tpu_torch.models.mask_rcnn import _exact_f32
from slam_maskrcnn_tpu_torch.models.targets import draw_target_noise
from slam_maskrcnn_tpu_torch.models.weights import flax_path
from slam_maskrcnn_tpu_torch.parallel import sharding
from slam_maskrcnn_tpu_torch.train import checkpoint as ckpt
from slam_maskrcnn_tpu_torch.utils.profiling import span, sync

# layer-selection regexes, reference model.py:2269-2280
LAYER_REGEX = {
    "heads": r"(mrcnn\_.*)|(rpn\_.*)|(fpn\_.*)",
    "3+": r"(res3.*)|(bn3.*)|(res4.*)|(bn4.*)|(res5.*)|(bn5.*)|(mrcnn\_.*)|(rpn\_.*)|(fpn\_.*)",
    "4+": r"(res4.*)|(bn4.*)|(res5.*)|(bn5.*)|(mrcnn\_.*)|(rpn\_.*)|(fpn\_.*)",
    "5+": r"(res5.*)|(bn5.*)|(mrcnn\_.*)|(rpn\_.*)|(fpn\_.*)",
    "all": ".*",
}

BATCH_KEYS = ("images", "rpn_match", "rpn_bbox", "gt_class_ids", "gt_boxes",
              "gt_masks", "active_class_ids")


def trainable_mask(model, layers_regex: str) -> dict:
    """{parameter name: 1.0 or 0.0}: 1 where a component of the
    parameter's Flax path (the JAX package's tree below "params") matches
    ``layers_regex`` at its start, as the JAX ``trainable_mask``."""
    module = model.module
    out = {}
    for name, _ in module.named_parameters():
        keys = flax_path(module, name)[1:]
        out[name] = (1.0 if any(re.match(layers_regex, str(k)) for k in keys)
                     else 0.0)
    return out


def _kernels(model):
    module = model.module
    return [p for n, p in module.named_parameters()
            if flax_path(module, n)[-1] == "kernel"]


def l2_regularization(model, weight_decay: float) -> torch.Tensor:
    """L2 on every kernel, each sum of squares divided by its size, as the
    reference (model.py:2137-2141 divides by tf.size)."""
    total = sum(torch.sum(p.float() ** 2) / p.numel() for p in _kernels(model))
    return weight_decay * total


def batch_to_device(batch: dict, device) -> dict:
    """data_generator's numpy batch as tensors on ``device`` (each a
    blocking upload)."""
    out = {}
    for k in BATCH_KEYS:
        t = torch.from_numpy(np.ascontiguousarray(batch[k]))
        if torch.device(device).type == "cpu":
            out[k] = t
            continue
        with sync("train.upload"):
            out[k] = t.to(device)
    return out


@dataclasses.dataclass
class StepRecord:
    """One step of ``Trainer.steps``. ``loss``: the step's loss read back
    to the host (a float, as ``train`` reads it); ``parts``: the five
    losses and ``l2``: the L2 term, 0-dim tensors on the device (``loss``
    is their sum); ``images``: the batch's image count; ``batch``: the
    batch on the device as the step took it ("anchors" included);
    ``pos_noise``, ``neg_noise``: the target-sampling draws; ``rois``,
    ``roi_class_ids``: the sampled rois [B, T, 4] and their target classes
    [B, T]. With several ranks, the batch, draws and rois are this rank's
    slice and the losses the global batch's."""

    loss: float
    parts: dict
    l2: torch.Tensor
    images: int
    batch: dict
    pos_noise: torch.Tensor
    neg_noise: torch.Tensor
    rois: torch.Tensor
    roi_class_ids: torch.Tensor


class Trainer:
    """Drives training of a MaskRCNN wrapper (mode 'training')."""

    def __init__(self, model, config=None):
        self.model = model
        self.config = config or model.config
        self.run_directory = None
        self.epoch = 0

    def make_step(self, lr: float, layers_regex: str, mesh=None):
        """The step for a learning rate and layer regex: ``step(batch,
        pos_noise, neg_noise)`` updates the model in place and returns
        (loss, {loss name: value}) as 0-dim tensors. ``batch``: tensors on
        the model's device (``batch_to_device``) plus "anchors". With a
        ``mesh`` (parallel/sharding.py) of several ranks, ``batch`` and the
        draws are this rank's slice of the global batch, the step is the
        global batch's and the returned losses are the global ones."""
        run = self._step_fn(lr, layers_regex, mesh)

        def step(batch, pos_noise, neg_noise):
            loss, parts, _, _ = run(batch, pos_noise, neg_noise)
            return loss, parts

        return step

    def _step_fn(self, lr: float, layers_regex: str, mesh=None):
        """``make_step``'s step as ``run(batch, pos_noise, neg_noise,
        mark=None)`` -> (loss, parts, l2, targets): the L2 term apart and
        the sampled targets too; ``mark(stage)``, if given, is called
        after "forward" (the loss with its L2 term), "backward" and
        "optimizer". The momentum trace of the step's live parameters is
        ``self.momentum`` ({parameter name: tensor}), zero at the start."""
        cfg = self.config
        model = self.model
        module = model.module
        params = dict(module.named_parameters())
        mask = trainable_mask(model, layers_regex)
        live = [n for n in params if mask[n]]
        for n, p in params.items():
            p.requires_grad_(bool(mask[n]))
        trace = [torch.zeros_like(params[n]) for n in live]
        self.momentum = dict(zip(live, trace))
        live_p = [params[n] for n in live]
        train_bn = bool(getattr(cfg, "TRAIN_BN", False))
        f32 = module.dtype == torch.float32
        max_norm = float(cfg.GRADIENT_CLIP_NORM)
        momentum = float(cfg.LEARNING_MOMENTUM)
        dp = mesh is not None and mesh.size > 1
        # each loss's count over the whole mesh (models/losses.py)
        reduce = ((lambda c: sharding.all_reduce(c.detach(), "sum", mesh))
                  if dp else None)
        sharding.batch_stats_over(module, mesh)

        def run(batch, pos_noise, neg_noise, mark=None):
            module.train(train_bn)
            for p in live_p:
                p.grad = None
            with _exact_f32(f32):
                with span("train_forward"):
                    outputs, targets = module.train_forward(
                        batch["images"], batch["anchors"],
                        batch["gt_class_ids"], batch["gt_boxes"],
                        batch["gt_masks"], pos_noise, neg_noise,
                        train_rois=cfg.TRAIN_ROIS_PER_IMAGE,
                        positive_ratio=cfg.ROI_POSITIVE_RATIO)
                with span("loss"):
                    targets["rpn_match"] = batch["rpn_match"]
                    targets["rpn_bbox"] = batch["rpn_bbox"]
                    targets["active_class_ids"] = batch["active_class_ids"]
                    loss, parts = total_loss(outputs, targets,
                                             cfg.LOSS_WEIGHTS, reduce)
                    if not dp or mesh.rank == 0:
                        l2 = l2_regularization(model, cfg.WEIGHT_DECAY)
                        loss = loss + l2
                    else:
                        l2 = torch.zeros((), device=loss.device)
                if mark is not None:
                    mark("forward")
                with span("backward"):
                    loss.backward()
                if mark is not None:
                    mark("backward")
            module.eval()
            with span("optimizer"), torch.no_grad():
                grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                         for p in live_p]
                if dp:
                    grads = sharding.reduce_gradients(grads, mesh)
                    loss = sharding.all_reduce(loss.detach(), "sum", mesh)
                    l2 = sharding.all_reduce(l2.detach(), "sum", mesh)
                    parts = {k: sharding.all_reduce(v.detach(), "sum", mesh)
                             for k, v in parts.items()}
                # optax clip_by_global_norm (the frozen zeros add nothing)
                norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                with sync("train.clip"):
                    below = bool(norm < max_norm)
                if not below:
                    grads = [(g / norm) * max_norm for g in grads]
                # optax sgd: trace = g + momentum * trace; p += trace * -lr
                torch._foreach_mul_(trace, momentum)
                torch._foreach_add_(trace, grads)
                torch._foreach_add_(live_p, torch._foreach_mul(trace, -lr))
            if mark is not None:
                mark("optimizer")
            return (loss.detach(), {k: v.detach() for k, v in parts.items()},
                    l2.detach(), targets)

        return run

    def _mesh(self):
        """None for one card; for GPU_COUNT > 1 this rank's mesh of the
        initialized process group, which must hold GPU_COUNT ranks."""
        n = int(self.config.GPU_COUNT)
        if n <= 1:
            return None
        import torch.distributed as dist
        have = (dist.get_world_size() if dist.is_available()
                and dist.is_initialized() else None)
        if have != n:
            raise RuntimeError(
                f"GPU_COUNT = {n} trains data-parallel inside an "
                f"initialized process group of {n} ranks "
                f"(parallel/sharding.py launch); this process is "
                + ("in none" if have is None else f"in one of {have}"))
        return sharding.make_mesh(n, self.model.device)

    def load_weights(self, path: str = "last", model_dir: str = "./logs"):
        """Restore a checkpoint and resume its epoch counter (model.py:
        2079-2115, 2208-2242). path='last' takes the newest run's newest
        checkpoint (find_last)."""
        if path == "last":
            path = ckpt.find_last(model_dir, self.config.NAME or "model")
        ckpt.restore_params(path, self.model)
        self.epoch = ckpt.epoch_from_path(path)
        self.run_directory = os.path.dirname(os.path.abspath(path))
        return path

    def steps(self, train_dataset, learning_rate=None, layers="all",
              augmentation=None, mark=None, augment=False, seed=None):
        """``train``'s step loop as an endless iterator of ``StepRecord``s,
        one a step: the data generator's next batch (shuffled, from
        ``seed``, or from a seed broadcast from rank 0 with several ranks;
        ``augmentation``: an Augmenter of data/augment.py), the two
        target-sampling draws (a generator seeded with ``self.epoch``), the
        batch's upload and the step. The set-up (the mesh, the freeze mask,
        a fresh momentum trace in ``self.momentum``) runs on this call.
        ``mark(stage)``, if given, is called after "upload" (the batch on
        the device), "forward", "backward" and "optimizer" (the same
        callable every step: a caller that times steps apart swaps what it
        calls)."""
        from slam_maskrcnn_tpu_torch.data.dataset import data_generator

        cfg = self.config
        mesh = self._mesh()
        lr = learning_rate or cfg.LEARNING_RATE
        layers_regex = LAYER_REGEX.get(layers, layers)
        model = self.model
        dev = model.device
        if not model.initialized:
            model.init_params()
        if mesh is not None:
            # one global batch stream on every rank: the generator's draws
            # and build_rpn_targets' global numpy draws from one seed
            sharding.shard_params(model.module, mesh)
            seed = sharding.broadcast_seed(mesh)
            np.random.seed(seed % 2 ** 32)
        run = self._step_fn(lr, layers_regex, mesh)
        anchors = torch.from_numpy(get_anchors(cfg, cfg.IMAGE_SHAPE)).to(dev)
        # one card matches each image's anchors there; the ranks of a mesh
        # keep the numpy batch that sharding.shard_batch takes
        gen = data_generator(train_dataset, cfg, shuffle=True,
                             augment=augment, augmentation=augmentation,
                             seed=seed, device=dev if mesh is None else None)
        noise = torch.Generator(device=dev).manual_seed(self.epoch)

        def records():
            while True:
                with span("train_step"):
                    with span("batch"):
                        batch = next(gen)
                        B = batch["images"].shape[0]
                        pos, neg = draw_target_noise(
                            B, model.module.proposal_count, noise, dev)
                    with span("upload"):
                        if mesh is None:
                            batch = batch_to_device(batch, dev)
                        else:
                            batch = sharding.shard_batch(
                                dict({k: batch[k] for k in BATCH_KEYS},
                                     pos=pos, neg=neg), mesh)
                            pos, neg = batch.pop("pos"), batch.pop("neg")
                        batch["anchors"] = anchors
                    if mark is not None:
                        mark("upload")
                    loss, parts, l2, targets = run(batch, pos, neg, mark)
                    with sync("train.loss"):
                        value = float(loss)
                yield StepRecord(
                    loss=value, parts=parts, l2=l2,
                    images=int(batch["images"].shape[0]), batch=batch,
                    pos_noise=pos, neg_noise=neg, rois=targets["rois"],
                    roi_class_ids=targets["target_class_ids"])

        return records()

    def train(self, train_dataset, val_dataset=None, learning_rate=None,
              epochs=1, layers="all", augment=False, steps_per_epoch=None,
              verbose=1, checkpoint=True, augmentation=None):
        """= MaskRCNN.train (model.py:2244-2330). layers: a regex or one of
        heads|3+|4+|5+|all. Trains from self.epoch to ``epochs``; returns
        the mean loss of each epoch. ``augmentation``: an Augmenter of
        data/augment.py, applied to every training image."""
        cfg = self.config
        lr = learning_rate or cfg.LEARNING_RATE
        steps = steps_per_epoch or cfg.STEPS_PER_EPOCH
        model = self.model
        records = self.steps(train_dataset, lr, layers,
                             augmentation=augmentation, augment=augment)
        mesh = self._mesh()
        # with several ranks only rank 0 logs and writes checkpoints: the
        # ranks hold the same parameters after every step
        lead = mesh is None or mesh.rank == 0
        checkpoint = checkpoint and lead
        verbose = verbose and lead
        if self.run_directory is None and checkpoint:
            self.run_directory = ckpt.run_dir(model.model_dir,
                                              cfg.NAME or "model")
        history = []
        for epoch in range(self.epoch, epochs):
            t0 = time.time()
            losses = []
            for _ in range(steps):
                rec = next(records)
                losses.append(rec.loss)
            mean_loss = float(np.mean(losses))
            history.append(mean_loss)
            if verbose:
                part_s = " ".join(f"{k}={float(v):.3f}"
                                  for k, v in sorted(rec.parts.items()))
                print(f"epoch {epoch + 1}/{epochs} loss {mean_loss:.4f} "
                      f"({time.time() - t0:.1f}s, lr {lr}, layers {layers}) "
                      f"[{part_s}]")
            if checkpoint:
                ckpt.save_params(model, ckpt.checkpoint_path(
                    self.run_directory, cfg.NAME or "model", epoch + 1))
        self.epoch = epochs
        return history
