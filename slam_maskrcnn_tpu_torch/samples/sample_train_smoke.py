"""Balloon + nucleus training gates on synthetic trees.

Port of tools/sample_train_smoke.py: the balloon and nucleus TRAINING
configs at full width (balloon: ResNet-101, "square" 1024^2, batch 2;
nucleus: ResNet-50, "crop" 512^2, batch 6) train from seeded weights on
synthetic trees in each sample's on-disk layout (VIA polygon JSON for
balloon, DSB2018 folders for nucleus), drawn with data/draw.py and written
with data/png.py (the same draws and pixels as the JAX tool's cv2 trees).
The protocol is the JAX tool's ``run_one``: float32 with TRAIN_BN, SGD at
``--lr``, the learning rate divided by 10 after ``--decay-after`` of the
epochs, then mAP@50 (eval/metrics.py ``compute_ap``) on 8 held-out images
at a 0.5 detection confidence, gated by ``--min-map``; 8 training images a
sample, as the JAX package's gate runs. Results go to a JSON file under
build/.

    python -m slam_maskrcnn_tpu_torch.samples.sample_train_smoke \\
        --min-map 0.5 --decay-after 0.5

Each sample's schedule defaults to the JAX package's gate runs (balloon 12
epochs x 25 steps, nucleus 16 epochs x 50 steps); ``--epochs`` and
``--steps`` set both.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SCHEDULES = {"balloon": (12, 25), "nucleus": (16, 50)}   # epochs, steps


def make_balloon_tree(root: str, n: int = 4, size: int = 96,
                      seed: int = 0, subset: str = "train"):
    """<root>/<subset>/b<i>.png + via_region_data.json: a red disc of
    radius 15 on noise, its VIA polygon the disc's 12 vertices truncated
    to int (tools/sample_train_smoke.py ``make_balloon_tree``)."""
    from slam_maskrcnn_tpu_torch.data.draw import circle
    from slam_maskrcnn_tpu_torch.data.png import write_png

    tdir = os.path.join(root, subset)
    os.makedirs(tdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    via = {}
    for i in range(n):
        img = (rng.random((size, size, 3)) * 80).astype(np.uint8)
        cx, cy, r = rng.integers(25, size - 25, 2).tolist() + [15]
        circle(img, (cx, cy), r, (30, 30, 200))
        fname = f"b{i}.png"
        write_png(os.path.join(tdir, fname), img)
        th = np.linspace(0, 2 * np.pi, 12, endpoint=False)
        via[fname] = {
            "filename": fname,
            "regions": {"0": {"shape_attributes": {
                "all_points_x": (cx + r * np.cos(th)).astype(int).tolist(),
                "all_points_y": (cy + r * np.sin(th)).astype(int).tolist(),
            }}},
        }
    with open(os.path.join(tdir, "via_region_data.json"), "w") as f:
        json.dump(via, f)


def make_nucleus_tree(root: str, n: int = 4, size: int = 128,
                      seed: int = 1):
    """<root>/stage1_train/nuc<i>/{images,masks}/*.png: three nuclei of
    radius 8-12 on noise (tools/sample_train_smoke.py
    ``make_nucleus_tree``)."""
    from slam_maskrcnn_tpu_torch.data.draw import circle
    from slam_maskrcnn_tpu_torch.data.png import write_png

    sdir = os.path.join(root, "stage1_train")
    rng = np.random.default_rng(seed)
    for i in range(n):
        iid = f"nuc{i}"
        os.makedirs(os.path.join(sdir, iid, "images"), exist_ok=True)
        os.makedirs(os.path.join(sdir, iid, "masks"), exist_ok=True)
        img = (rng.random((size, size, 3)) * 60).astype(np.uint8)
        for j in range(3):
            m = np.zeros((size, size), np.uint8)
            cx, cy = rng.integers(18, size - 18, 2).tolist()
            r = int(rng.integers(8, 13))
            circle(m, (cx, cy), r, 255)
            img[m > 0] = (180, 180, 200)
            write_png(os.path.join(sdir, iid, "masks", f"m{j}.png"), m)
        write_png(os.path.join(sdir, iid, "images", iid + ".png"), img)


def inference_twin(model, inf_cfg):
    """An inference MaskRCNN holding ``model``'s trained tensors, in
    float32 with frozen BatchNorm and a 0.5 detection confidence (the
    smoke protocol's evaluation config)."""
    from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN

    inf_cfg.COMPUTE_DTYPE = "float32"
    inf_cfg.TRAIN_BN = False
    # a few-hundred-step detector's scores sit below the samples'
    # production confidence bars (balloon ships 0.9): gate at 0.5
    inf_cfg.DETECTION_MIN_CONFIDENCE = 0.5
    inf_cfg.__init__()
    inf = MaskRCNN("inference", inf_cfg, device=model.device)
    inf.module.load_state_dict(model.module.state_dict())
    inf.module.to(inf.device)
    inf.initialized = True
    return inf


def attach_diagnostics(model) -> list:
    """Record each training step of ``model`` into the returned list, one
    dict a step: the positive rois the detection-target layer keeps, the
    mean of their mask targets, the mask and box losses, and the norm of
    the mask head's gradient (before clipping). A wrapper on the module's
    ``train_forward`` and gradient hooks on the mask head's parameters;
    the step itself is unchanged."""
    from slam_maskrcnn_tpu_torch.models.losses import (mrcnn_bbox_loss,
                                                       mrcnn_mask_loss)

    module = model.module
    records: list = []
    forward = module.train_forward

    def recorded(*args, **kwargs):
        outputs, targets = forward(*args, **kwargs)
        with torch.no_grad():
            cls = targets["target_class_ids"]
            pos = cls > 0
            n = int(pos.sum())
            records.append(dict(
                positive_rois=n,
                mask_target_mean=(float(targets["target_mask"][pos].mean())
                                  if n else None),
                mask_loss=float(mrcnn_mask_loss(
                    targets["target_mask"], cls, outputs["mrcnn_masks"])),
                bbox_loss=float(mrcnn_bbox_loss(
                    targets["target_bbox"], cls, outputs["mrcnn_bbox"])),
                mask_grad_sq=0.0))
        return outputs, targets

    def hook(grad):
        records[-1]["mask_grad_sq"] += float(grad.float().pow(2).sum())

    module.train_forward = recorded
    for p in module.fpn_mask.parameters():
        p.register_hook(hook)
    return records


def summarize_diagnostics(records: list) -> dict:
    """The per-step lists of ``attach_diagnostics``' records."""
    return dict(
        positive_rois=[r["positive_rois"] for r in records],
        mask_target_mean=[None if r["mask_target_mean"] is None
                          else round(r["mask_target_mean"], 4)
                          for r in records],
        mask_loss=[round(r["mask_loss"], 4) for r in records],
        bbox_loss=[round(r["bbox_loss"], 4) for r in records],
        mask_grad_norm=[round(r["mask_grad_sq"] ** 0.5, 6) for r in records])


def mask_target_dump(model, cfg, dataset) -> dict:
    """The first image's detection targets beside their source. The model's
    proposals for the image (frozen BatchNorm, no gradient), the first
    three replaced by its gt boxes shifted by a tenth of their size so
    that some roi is positive, go through ``detection_targets`` with the
    image's mini-masks, as the training batches carry them; the first
    positive roi's 28x28 target is set beside the crop of the image's full
    molded gt mask by the same roi (the reference's non-mini-mask target,
    model.py:637-655). The two agree up to the mini-mask's resampling
    where the targets are aligned."""
    from slam_maskrcnn_tpu_torch.data.dataset import load_image_gt
    from slam_maskrcnn_tpu_torch.models.anchors import get_anchors
    from slam_maskrcnn_tpu_torch.models.proposal import generate_proposals
    from slam_maskrcnn_tpu_torch.models.targets import (detection_targets,
                                                        draw_target_noise)
    from slam_maskrcnn_tpu_torch.ops.boxes import compute_iou_matrix
    from slam_maskrcnn_tpu_torch.ops.roi_align import crop_and_resize

    dev = model.device
    module = model.module
    image_id = dataset.image_ids[0]
    image, cls, boxes, mini, _, _ = load_image_gt(dataset, cfg, image_id,
                                                  use_mini_mask=True)
    *_, full, _, _ = load_image_gt(dataset, cfg, image_id,
                                   use_mini_mask=False)
    H, W = image.shape[:2]
    scale = np.array([H - 1, W - 1, H - 1, W - 1], np.float32)
    shift = np.array([0, 0, 1, 1], np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    images = t((image.astype(np.float32) - cfg.MEAN_PIXEL)[None]
               .astype(np.float32))
    gt_boxes = t(((boxes.astype(np.float32) - shift) / scale)[None])
    gt_masks = t(np.transpose(mini, (2, 0, 1)).astype(np.float32)[None])
    module.eval()
    with torch.no_grad():
        _, probs, deltas = module.rpn_outputs(module.features(images))
        proposals, _ = generate_proposals(
            probs, deltas, t(get_anchors(cfg, cfg.IMAGE_SHAPE)),
            module.proposal_count, module.rpn_nms_threshold,
            module.pre_nms_limit, module.rpn_bbox_std)
    g0 = gt_boxes[0, 0]
    hw = (g0[2:] - g0[:2]).repeat(2)
    moves = torch.tensor([[0.1, 0.1, 0.1, 0.1], [-0.1, 0.05, -0.1, 0.05],
                          [0.05, -0.1, 0.05, -0.1]], device=dev)
    proposals[0, :3] = (g0 + moves * hw).clamp(0.0, 1.0)
    gen = torch.Generator(device=dev).manual_seed(0)
    pos, neg = draw_target_noise(1, proposals.shape[1], gen, dev)
    rois, tcls, _, tmask, _ = detection_targets(
        proposals, t(cls[None].astype(np.int32)), gt_boxes, gt_masks, pos,
        neg, train_rois=cfg.TRAIN_ROIS_PER_IMAGE,
        positive_ratio=cfg.ROI_POSITIVE_RATIO,
        mask_size=module.mask_pool_size * 2, bbox_std=module.bbox_std)
    positive = (tcls[0] > 0).nonzero()[:, 0]
    out = dict(image_id=int(image_id), positive_rois=int(len(positive)))
    if not len(positive):
        return out
    i = int(positive[0])
    roi = rois[0, i]
    target = tmask[0, i].cpu().numpy()
    # the roi's gt: the box of highest IoU, as the target layer picks it
    g = int(compute_iou_matrix(roi[None], gt_boxes[0]).argmax())
    crop = crop_and_resize(t(full[:, :, g:g + 1].astype(np.float32)),
                           roi[None], target.shape)[0, :, :, 0]
    crop = torch.round(crop).cpu().numpy()
    rows = lambda m: ["".join("#" if v > 0.5 else "." for v in r) for r in m]
    out.update(roi=[round(float(v), 5) for v in roi.cpu()], gt_index=g,
               target_mean=float(target.mean()),
               full_crop_mean=float(crop.mean()),
               agreement=float((target == crop).mean()),
               target=rows(target), full_crop=rows(crop))
    return out


def run_one(name: str, model, cfg, dataset, steps: int, epochs: int = 1,
            lr: float | None = None, val_ds=None, min_map=None,
            inf_cfg=None, decay_after: float | None = None):
    """epochs x steps optimizer steps with the loss curve; with ``val_ds``
    the trained tensors go into an inference model and mAP@50 over the
    held-out images is recorded (and gated with ``min_map``).
    ``decay_after``: the fraction of the epochs after which the learning
    rate drops 10x (the reference's stage-wise schedule, coco.py:510-535)."""
    from slam_maskrcnn_tpu_torch.data.dataset import load_image_gt
    from slam_maskrcnn_tpu_torch.eval.metrics import (compute_ap,
                                                      compute_overlaps_boxes)
    from slam_maskrcnn_tpu_torch.train.trainer import Trainer

    trainer = Trainer(model, cfg)
    records = attach_diagnostics(model)
    kw = dict(layers="all", steps_per_epoch=steps, checkpoint=False)
    t0 = time.time()
    lr0 = lr if lr is not None else cfg.LEARNING_RATE
    if decay_after is None:
        history = trainer.train(dataset, epochs=epochs, learning_rate=lr0,
                                **kw)
    else:
        e1 = max(1, int(round(epochs * decay_after)))
        history = trainer.train(dataset, epochs=e1, learning_rate=lr0, **kw)
        if e1 < epochs:
            history += trainer.train(dataset, epochs=epochs,
                                     learning_rate=lr0 / 10.0, **kw)
    secs = time.time() - t0
    first, last = (history[0], history[-1]) if history else (None, None)
    out = {"sample": name, "steps": steps * epochs,
           "loss_curve": [round(float(h), 3) for h in history],
           "loss_first_epoch": None if first is None else round(first, 3),
           "loss_last_epoch": None if last is None else round(last, 3),
           "decrease_ratio": (None if not history or not last
                              else round(first / last, 2)),
           "seconds": round(secs, 1),
           "diagnostics": summarize_diagnostics(records)}
    if val_ds is not None:
        out["target_dump"] = mask_target_dump(model, cfg, val_ds)
        inf = inference_twin(model, inf_cfg)
        icfg = inf.config
        t0 = time.time()
        aps, per_image = [], []
        for iid in val_ds.image_ids:
            image, gt_cls, gt_box, gt_mask, _, _ = load_image_gt(
                val_ds, icfg, iid, use_mini_mask=False)
            r = inf.detect([image])[0]
            ap, _, _, _ = compute_ap(
                gt_box.astype(np.float32), gt_cls, gt_mask,
                r["rois"].astype(np.float32), r["class_ids"], r["scores"],
                r["masks"], iou_threshold=0.5)
            aps.append(float(ap))
            # what the AP turns on: detections, and each gt's best box IoU
            iou = compute_overlaps_boxes(r["rois"].astype(np.float32),
                                         gt_box.astype(np.float32))
            per_image.append(dict(
                ap=float(ap), detections=len(r["scores"]),
                best_box_iou=(iou.max(0).tolist() if iou.size
                              else [0.0] * len(gt_box))))
        out["map50"] = round(float(np.mean(aps)), 3)
        out["per_image"] = per_image
        out["eval_images"] = len(aps)
        out["eval_seconds"] = round(time.time() - t0, 1)
        if min_map is not None:
            out["map50_gate"] = min_map
            out["map50_pass"] = out["map50"] >= min_map
    return out


def balloon_setup(root: str, train_images: int, eval_images: int,
                  with_val: bool):
    """(training config, train dataset, val dataset or None, inference
    config) of the balloon gate, its trees written under ``root``."""
    from slam_maskrcnn_tpu_torch.samples.balloon import (BalloonConfig,
                                                         BalloonDataset)

    make_balloon_tree(root, n=train_images)
    ds = BalloonDataset()
    ds.load_balloon(root, "train")
    ds.prepare()
    val_ds = None
    if with_val:
        make_balloon_tree(root, n=eval_images, seed=7, subset="val")
        val_ds = BalloonDataset()
        val_ds.load_balloon(root, "val")
        val_ds.prepare()

    class BalloonSmokeConfig(BalloonConfig):
        # f32 as the reference's TF1 trains, and live BatchNorm: frozen
        # BatchNorm from random init amplifies activations until the RPN
        # losses go NaN (train/trainer.py)
        COMPUTE_DTYPE = "float32"
        TRAIN_BN = True

    class BalloonSmokeInference(BalloonConfig):
        GPU_COUNT = 1
        IMAGES_PER_GPU = 1

    return BalloonSmokeConfig(), ds, val_ds, BalloonSmokeInference()


def nucleus_setup(root: str, train_images: int, eval_images: int,
                  with_val: bool):
    """As ``balloon_setup``, for the nucleus gate."""
    from slam_maskrcnn_tpu_torch.samples.nucleus import (
        NucleusConfig, NucleusDataset, NucleusInferenceConfig)

    make_nucleus_tree(root, n=train_images)
    ds = NucleusDataset()
    ds.load_nucleus(root, "stage1_train")
    ds.prepare()
    val_ds = None
    if with_val:
        vroot = os.path.join(root, "valtree")
        make_nucleus_tree(vroot, n=eval_images, seed=9)
        val_ds = NucleusDataset()
        val_ds.load_nucleus(vroot, "stage1_train")
        val_ds.prepare()

    class NucleusSmokeConfig(NucleusConfig):
        COMPUTE_DTYPE = "float32"
        TRAIN_BN = True

    return NucleusSmokeConfig(), ds, val_ds, NucleusInferenceConfig()


def main(argv=None):
    from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=None,
                    help="steps per epoch (default: each sample's gate "
                         "schedule)")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--lr", type=float, default=1e-3,
                    help="the smoke learning rate (stable from random "
                         "init with live BatchNorm)")
    ap.add_argument("--out", default=os.path.join(
        REPO, "build", "sample_train_smoke.json"))
    # the JAX package's gate runs trained on 8 images a sample (its
    # ROUND5_NOTES.md; its tool's own default is 4)
    ap.add_argument("--train-images", type=int, default=8)
    ap.add_argument("--eval-images", type=int, default=8)
    ap.add_argument("--min-map", type=float, default=None,
                    help="evaluate mAP@50 on the held-out images and "
                         "record pass/fail against this floor")
    ap.add_argument("--decay-after", type=float, default=None,
                    help="fraction of epochs after which the learning "
                         "rate drops 10x")
    ap.add_argument("--samples", default="balloon,nucleus")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    which = [s.strip() for s in args.samples.split(",") if s.strip()]
    setups = {"balloon": balloon_setup, "nucleus": nucleus_setup}

    results = []
    for name in which:
        epochs, steps = SCHEDULES[name]
        epochs = args.epochs or epochs
        steps = args.steps or steps
        with tempfile.TemporaryDirectory() as root:
            cfg, ds, val_ds, inf_cfg = setups[name](
                root, args.train_images, args.eval_images,
                args.min_map is not None)
            cfg.STEPS_PER_EPOCH = steps
            model = MaskRCNN("training", cfg, device=args.device)
            model.init_params(0)
            print(f"[smoke] {name}: {epochs} epochs x {steps} steps",
                  flush=True)
            results.append(run_one(name, model, cfg, ds, steps, epochs,
                                   lr=args.lr, val_ds=val_ds,
                                   min_map=args.min_map, inf_cfg=inf_cfg,
                                   decay_after=args.decay_after))
            del model
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
