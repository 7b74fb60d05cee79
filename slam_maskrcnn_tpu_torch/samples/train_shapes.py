"""Shapes configurations and the mAP@50 gate, inference half.

Port of slam_maskrcnn_tpu/samples/train_shapes.py without the training
loop (a later slice): ``TrainShapesConfig``, ``InferenceShapesConfig``
(confidence 0.7) and ``evaluate_map``, which scores detections against
ground truth with eval/metrics.py ``compute_ap``. The scenes come as
(image, gt_boxes, gt_class_ids, gt_masks) tuples, e.g. from
``detect_scenes()`` (the 20 committed parity scenes).

    from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    model = MaskRCNN("inference", InferenceShapesConfig())
    model.load_weights("weights/shapes_r2_f16.h5")
    print(evaluate_map(model, detect_scenes()))
"""

from __future__ import annotations

import os

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
