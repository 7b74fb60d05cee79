"""Train-on-shapes walkthrough and its mAP@50 gate.

Port of slam_maskrcnn_tpu/samples/train_shapes.py (the reference's
``samples/shapes/train_shapes.ipynb``): train the synthetic-shapes config
from seeded random weights on the card, then score mAP@50 on held-out
shapes images with eval/metrics.py ``compute_ap`` and optionally fail
below a gate. ``evaluate_map`` scores (image, gt_boxes, gt_class_ids,
gt_masks) scenes: ``dataset_scenes`` makes them from a dataset,
``detect_scenes()`` reads the 20 committed parity scenes.

    python -m slam_maskrcnn_tpu_torch.samples.train_shapes \\
        --epochs 14 --steps 100 --layers all --eval-images 25 \\
        --min-map 0.5 --save shapes.h5

    from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    model = MaskRCNN("inference", InferenceShapesConfig())
    model.load_weights("weights/shapes_r2_f16.h5")
    print(evaluate_map(model, detect_scenes()))
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from slam_maskrcnn_tpu_torch.data.shapes import ShapesConfig
from slam_maskrcnn_tpu_torch.eval.metrics import compute_ap

SCENES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "detect_scenes.npz")


class TrainShapesConfig(ShapesConfig):
    """The train_shapes.ipynb config analog."""

    NAME = "shapes"
    IMAGES_PER_GPU = 8
    GPU_COUNT = 1
    STEPS_PER_EPOCH = 100


class InferenceShapesConfig(TrainShapesConfig):
    IMAGES_PER_GPU = 1
    DETECTION_MIN_CONFIDENCE = 0.7


def detect_scenes(path: str = SCENES):
    """The 20 deterministic parity scenes with their ground truth: a list
    of (image u8 [H, W, 3] RGB, gt_boxes i32 [N, 4], gt_class_ids i32 [N],
    gt_masks bool [H, W, N])."""
    z = np.load(path)
    return [(z[f"image{i}"], z[f"boxes{i}"], z[f"class_ids{i}"],
             z[f"masks{i}"]) for i in range(int(z["n"]))]


def evaluate_map(model, scenes, iou_threshold: float = 0.5,
                 verbose: int = 0, results=None) -> float:
    """mAP over (image, gt_boxes, gt_class_ids, gt_masks) scenes (the
    notebook's final cell). ``results``: detections already made for the
    scenes (a list of detect() dicts); else ``model.detect`` runs."""
    aps = []
    for k, (image, gt_bbox, gt_class_id, gt_mask) in enumerate(scenes):
        r = results[k] if results is not None else model.detect([image])[0]
        ap, _, _, _ = compute_ap(
            np.asarray(gt_bbox, np.float32), gt_class_id, gt_mask,
            r["rois"].astype(np.float32), r["class_ids"], r["scores"],
            r["masks"], iou_threshold=iou_threshold)
        aps.append(ap)
        if verbose:
            print(f"  scene {k}: AP@{iou_threshold:.2f} = {ap:.3f}")
    return float(np.mean(aps)) if aps else 0.0


def dataset_scenes(dataset, config, image_ids=None):
    """(image, gt_boxes, gt_class_ids, gt_masks) of dataset images, molded
    as ``config`` molds them (full-size masks), for ``evaluate_map``."""
    from slam_maskrcnn_tpu_torch.data.dataset import load_image_gt

    out = []
    for i in (dataset.image_ids if image_ids is None else image_ids):
        image, class_ids, bbox, mask, _, _ = load_image_gt(
            dataset, config, i, use_mini_mask=False)
        out.append((image, bbox, class_ids, mask))
    return out


def main(argv=None):
    from slam_maskrcnn_tpu_torch.data.shapes import ShapesDataset
    from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from slam_maskrcnn_tpu_torch.train.trainer import Trainer

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--train-images", type=int, default=500)
    ap.add_argument("--eval-images", type=int, default=25)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--layers", default="heads",
                    help="heads|3+|4+|5+|all (the notebook trains heads)")
    ap.add_argument("--min-map", type=float, default=None,
                    help="exit nonzero if mAP@50 falls below this")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--decay-epochs", type=int, default=0,
                    help="extra epochs at lr/10 after the main schedule "
                         "(the reference's final-stage lr drop, "
                         "coco.py:514-520)")
    ap.add_argument("--augment", action="store_true",
                    help="legacy fliplr augmentation during training")
    ap.add_argument("--save", default=None,
                    help="write trained weights (Keras-layout h5) + a "
                         ".eval.json log next to it")
    args = ap.parse_args(argv)

    cfg = TrainShapesConfig()
    cfg.STEPS_PER_EPOCH = args.steps
    H, W = int(cfg.IMAGE_SHAPE[0]), int(cfg.IMAGE_SHAPE[1])

    train_ds = ShapesDataset()
    train_ds.load_shapes(args.train_images, H, W, seed=args.seed)
    train_ds.prepare()
    val_ds = ShapesDataset()
    val_ds.load_shapes(args.eval_images, H, W, seed=args.seed + 1)
    val_ds.prepare()

    model = MaskRCNN("training", cfg, device=args.device)
    model.init_params(args.seed)
    trainer = Trainer(model, cfg)
    t0 = time.time()
    trainer.train(train_ds, learning_rate=args.lr, epochs=args.epochs,
                  layers=args.layers, augment=args.augment,
                  checkpoint=False)
    if args.decay_epochs:
        lr = args.lr if args.lr is not None else cfg.LEARNING_RATE
        trainer.train(train_ds, learning_rate=lr / 10.0,
                      epochs=args.epochs + args.decay_epochs,
                      layers=args.layers, augment=args.augment,
                      checkpoint=False)
    train_s = time.time() - t0

    # the trained tensors into an inference-mode model
    icfg = InferenceShapesConfig()
    inf = MaskRCNN("inference", icfg, device=args.device)
    inf.module.load_state_dict(model.module.state_dict())
    inf.module.to(inf.device)
    inf.initialized = True
    t0 = time.time()
    m_ap = evaluate_map(inf, dataset_scenes(val_ds, icfg), verbose=1)
    eval_s = time.time() - t0

    summary = {
        "metric": "shapes_map50",
        "value": round(m_ap, 4),
        "unit": "mAP@0.5",
        "train_seconds": round(train_s, 1),
        "eval_seconds": round(eval_s, 1),
        "epochs": args.epochs + args.decay_epochs,
        "steps_per_epoch": args.steps,
        "layers": args.layers,
    }
    print(json.dumps(summary))
    if args.save:
        from slam_maskrcnn_tpu_torch.models.h5 import save_h5_weights

        save_h5_weights(args.save, model)
        with open(args.save + ".eval.json", "w") as f:
            json.dump(summary, f, indent=1)
        print(f"saved weights to {args.save}")
    if args.min_map is not None and m_ap < args.min_map:
        raise SystemExit(
            f"mAP@50 {m_ap:.3f} below the {args.min_map} gate")
    return summary


if __name__ == "__main__":
    main()
