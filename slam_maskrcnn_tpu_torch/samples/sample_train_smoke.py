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
           "seconds": round(secs, 1)}
    if val_ds is not None:
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
