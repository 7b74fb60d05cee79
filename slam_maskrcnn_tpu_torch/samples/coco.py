"""MS-COCO training/evaluation sample.

Port of slam_maskrcnn_tpu/samples/coco.py (``Mask_RCNN/samples/coco/
coco.py``): CocoConfig (:71-87), CocoDataset (:94-308, polygon/RLE
annotations -> masks, crowds -> negative ids), ``evaluate_coco``
(:342-391) and the train|evaluate CLI with the 3-stage schedule
heads(40) -> 4+(120) -> all(160 @ lr/10) (:399-531), driven through the
port's MaskRCNN and Trainer on the card (``--device cpu`` runs the plain
versions). COCO JSON is read by eval/coco_api.py on the port's RLE codec;
polygons are filled as cv2.fillPoly fills them (data/draw.py).

    python -m slam_maskrcnn_tpu_torch.samples.coco evaluate \\
        --dataset /data/coco --model mask_rcnn_coco.h5 --limit 50
    python -m slam_maskrcnn_tpu_torch.samples.coco train --dataset /data/coco
"""

from __future__ import annotations

import os
import time

import numpy as np

from slam_maskrcnn_tpu_torch.data.dataset import Dataset
from slam_maskrcnn_tpu_torch.eval.metrics import compute_ap_range
from slam_maskrcnn_tpu_torch.eval.rle import (poly_to_mask, rle_decode,
                                              string_to_counts)
from slam_maskrcnn_tpu_torch.models.config import Config

# the 81 COCO class names (index = contiguous class id), as listed in the
# reference driver (src/TSDF_Python/main.py:11-25)
COCO_CLASS_NAMES = (
    "BG", "person", "bicycle", "car", "motorcycle", "airplane", "bus",
    "train", "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush")


class CocoConfig(Config):
    """= reference CocoConfig (coco.py:71-87)."""

    NAME = "coco"
    IMAGES_PER_GPU = 2
    NUM_CLASSES = 1 + 80


class CocoInferenceConfig(CocoConfig):
    """The inference one-liner every driver script uses
    (mask_process.py:57-61)."""

    GPU_COUNT = 1
    IMAGES_PER_GPU = 1


def ann_to_mask(ann, h, w):
    """COCO annotation -> bool [H, W]: polygons, uncompressed RLE dicts, or
    compressed RLE strings (the three formats the reference's annToMask
    handles, coco.py:282-308)."""
    seg = ann["segmentation"]
    if isinstance(seg, list):
        return poly_to_mask(seg, h, w).astype(bool)
    counts = seg["counts"]
    if isinstance(counts, str):
        counts = string_to_counts(counts)
    return rle_decode({"size": seg["size"],
                       "counts": np.asarray(counts, np.uint32)}).astype(bool)


class CocoDataset(Dataset):
    """= reference CocoDataset (coco.py:94-308) over plain COCO JSON."""

    def load_coco(self, dataset_dir, subset, year="2014", class_ids=None,
                  max_images=None, return_coco=False):
        """Register a COCO split through the annotation API (the reference
        builds a ``COCO`` object the same way, coco.py:101-141)."""
        from slam_maskrcnn_tpu_torch.eval.coco_api import COCO

        ann_file = os.path.join(dataset_dir, "annotations",
                                f"instances_{subset}{year}.json")
        coco = COCO(ann_file)
        img_subset = "val" if subset in ("minival", "valminusminival") \
            else subset
        image_dir = os.path.join(dataset_dir, f"{img_subset}{year}")

        cat_ids = sorted(class_ids or coco.getCatIds())
        for c in coco.loadCats(cat_ids):
            self.add_class("coco", c["id"], c["name"])

        if class_ids:
            image_ids = sorted({i for cid in cat_ids
                                for i in coco.getImgIds(catIds=[cid])})
        else:
            image_ids = sorted(coco.imgs)
        if max_images:
            image_ids = image_ids[:max_images]
        for info in coco.loadImgs(image_ids):
            self.add_image(
                "coco", image_id=info["id"],
                path=os.path.join(image_dir, info["file_name"]),
                width=info["width"], height=info["height"],
                annotations=coco.loadAnns(coco.getAnnIds(
                    imgIds=[info["id"]], catIds=cat_ids, iscrowd=None)))
        return coco if return_coco else self

    def load_mask(self, image_id):
        info = self.image_info[image_id]
        h, w = info["height"], info["width"]
        masks, ids = [], []
        for ann in info["annotations"]:
            m = ann_to_mask(ann, h, w)
            if not m.any():
                continue
            cid = self.map_source_class_id(f"coco.{ann['category_id']}")
            if ann.get("iscrowd", 0):
                cid *= -1  # crowds -> negative ids (coco.py:262-268)
                if m.shape != (h, w):
                    continue
            masks.append(m)
            ids.append(cid)
        if not masks:
            return np.empty((h, w, 0), bool), np.empty((0,), np.int32)
        return np.stack(masks, -1), np.asarray(ids, np.int32)

    def image_reference(self, image_id):
        return f"coco.{self.image_info[image_id]['id']}"


def evaluate_coco(model, dataset, limit=0, verbose=1):
    """mAP evaluation with per-image predict timing (the reference prints
    ``t_prediction / len(image_ids)``, coco.py:358-391), on
    eval/metrics.py ``compute_ap_range``."""
    from slam_maskrcnn_tpu_torch.data.dataset import extract_bboxes

    image_ids = dataset.image_ids[:limit] if limit else dataset.image_ids
    t_prediction = 0.0
    t_start = time.time()
    aps = []
    for i, image_id in enumerate(image_ids):
        image = dataset.load_image(image_id)
        gt_mask, gt_ids = dataset.load_mask(image_id)
        if gt_ids.size == 0:
            continue
        gt_boxes = extract_bboxes(gt_mask).astype(np.float32)
        t = time.time()
        r = model.detect([image], verbose=0)[0]
        t_prediction += time.time() - t
        ap = compute_ap_range(gt_boxes, np.abs(gt_ids), gt_mask,
                              r["rois"].astype(np.float32), r["class_ids"],
                              r["scores"], r["masks"])
        aps.append(ap)
        if verbose and (i + 1) % 10 == 0:
            print(f"{i + 1}/{len(image_ids)} mAP so far {np.mean(aps):.4f}")
    print("Prediction time: {:.4f}s. Average {:.4f}s/image".format(
        t_prediction, t_prediction / max(len(aps), 1)))
    print("Total time:", time.time() - t_start)
    print("mAP @ IoU 0.5:0.95:", float(np.mean(aps)) if aps else 0.0)
    return float(np.mean(aps)) if aps else 0.0


def detection_to_coco_results(dataset, image_id, r):
    """Detections -> COCO result dicts with compressed RLE (the reference's
    build_coco_results, coco.py:311-339)."""
    from slam_maskrcnn_tpu_torch.eval.rle import mask_to_rle_string

    results = []
    for i in range(r["rois"].shape[0]):
        class_id = int(r["class_ids"][i])
        y1, x1, y2, x2 = [float(v) for v in r["rois"][i]]
        results.append({
            "image_id": dataset.image_info[image_id]["id"],
            "category_id": dataset.get_source_class_id(class_id, "coco"),
            "bbox": [x1, y1, x2 - x1, y2 - y1],
            "score": float(r["scores"][i]),
            "segmentation": mask_to_rle_string(
                r["masks"][:, :, i].astype(np.uint8)),
        })
    return results


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        description="Train/eval Mask R-CNN on COCO")
    parser.add_argument("command", choices=["train", "evaluate"])
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--year", default="2014")
    parser.add_argument("--model", default="")
    parser.add_argument("--logs", default="./logs")
    parser.add_argument("--limit", default=500, type=int)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from slam_maskrcnn_tpu_torch.train.trainer import Trainer

    if args.command == "train":
        config = CocoConfig()
        model = MaskRCNN("training", config, args.logs, device=args.device)
        if args.model:
            model.load_weights(args.model, by_name=True)
        else:
            model.init_params()
        ds_train = CocoDataset()
        ds_train.load_coco(args.dataset, "train", args.year)
        ds_train.prepare()
        trainer = Trainer(model, config)
        # the reference 3-stage schedule (coco.py:496-520)
        trainer.train(ds_train, learning_rate=config.LEARNING_RATE,
                      epochs=40, layers="heads")
        trainer.train(ds_train, learning_rate=config.LEARNING_RATE,
                      epochs=120, layers="4+")
        trainer.train(ds_train, learning_rate=config.LEARNING_RATE / 10,
                      epochs=160, layers="all")
        return None
    config = CocoInferenceConfig()
    model = MaskRCNN("inference", config, args.logs, device=args.device)
    model.load_weights(args.model or model.find_last(), by_name=True)
    ds = CocoDataset()
    ds.load_coco(args.dataset, "minival", args.year)
    ds.prepare()
    return evaluate_coco(model, ds, limit=args.limit)


if __name__ == "__main__":
    main()
