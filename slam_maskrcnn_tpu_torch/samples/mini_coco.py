"""Mini-COCO protocol run.

Port of slam_maskrcnn_tpu/samples/mini_coco.py. Generates a synthetic
COCO-format dataset (shapes scenes rendered to PNG + instances JSON with
RLE segmentations), then drives the FULL protocol
the reference runs on real COCO (``samples/coco/coco.py:342-391``):
``CocoDataset`` -> ``detect`` -> RLE results -> ``COCOevalLite`` bbox +
segm summaries — and cross-checks AP@50 against the self-contained
``compute_ap`` on the same predictions.

Zero-egress stand-in for the real val2014 run: the protocol, formats and
eval machinery are exercised at a few hundred images; only the pixels are
synthetic.

The PNGs are written by data/png.py (pixels equal to the JAX package's
cv2 writes); detection runs on the card (``--device cpu`` for the plain
versions), in bf16 unless ``--dtype float32``.

Usage:
  python -m slam_maskrcnn_tpu_torch.samples.mini_coco generate \
      --dir /tmp/mini --images 200
  python -m slam_maskrcnn_tpu_torch.samples.mini_coco evaluate \
      --dir /tmp/mini [--weights shapes.h5] [--limit 50] [--dtype float32]
"""

from __future__ import annotations

import json
import os

import numpy as np

from slam_maskrcnn_tpu_torch.data.shapes import ShapesConfig
from slam_maskrcnn_tpu_torch.eval.rle import rle_encode
from slam_maskrcnn_tpu_torch.samples.coco import CocoDataset


def make_mini_coco(out_dir: str, n_images: int = 200, size: int = 128,
                   year: str = "2014", subset: str = "val", seed: int = 0):
    """Render shapes scenes into a COCO directory tree:
    <dir>/<subset><year>/*.png + <dir>/annotations/instances_....json."""
    from slam_maskrcnn_tpu_torch.data.png import write_png
    from slam_maskrcnn_tpu_torch.data.shapes import ShapesDataset

    ds = ShapesDataset()
    ds.load_shapes(n_images, size, size, seed=seed)
    ds.prepare()

    img_dir = os.path.join(out_dir, f"{subset}{year}")
    ann_dir = os.path.join(out_dir, "annotations")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)

    # category ids deliberately non-contiguous (like real COCO) to
    # exercise the source-id mapping
    cats = [{"id": 11, "name": "square"}, {"id": 22, "name": "circle"},
            {"id": 33, "name": "triangle"}]
    name_to_cat = {c["name"]: c["id"] for c in cats}

    images, annotations = [], []
    ann_id = 1
    for i in ds.image_ids:
        fname = f"shapes_{i:05d}.png"
        img = ds.load_image(i)
        write_png(os.path.join(img_dir, fname),
                  np.ascontiguousarray(img[:, :, ::-1]))
        images.append({"id": int(i) + 1, "file_name": fname,
                       "width": size, "height": size})
        masks, class_ids = ds.load_mask(i)
        for j in range(masks.shape[-1]):
            m = masks[:, :, j].astype(np.uint8)
            if not m.any():
                continue
            ys, xs = np.nonzero(m)
            rle = rle_encode(m)
            annotations.append({
                "id": ann_id, "image_id": int(i) + 1,
                "category_id": name_to_cat[ds.class_names[class_ids[j]]],
                "segmentation": {"size": rle["size"],
                                 "counts": [int(c) for c in rle["counts"]]},
                "area": float(m.sum()), "iscrowd": 0,
                "bbox": [float(xs.min()), float(ys.min()),
                         float(xs.max() - xs.min() + 1),
                         float(ys.max() - ys.min() + 1)],
            })
            ann_id += 1
    doc = {"info": {"description": "mini-coco shapes"},
           "images": images, "categories": cats,
           "annotations": annotations}
    path = os.path.join(ann_dir, f"instances_{subset}{year}.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


class MiniCocoConfig(ShapesConfig):
    """The evaluate command's config: the shapes model, one image a
    call."""

    NAME = "mini_coco"
    GPU_COUNT = 1
    IMAGES_PER_GPU = 1


def _results_to_eval_lists(dataset, image_ids, get_result):
    """Shared driver: per image call get_result(image_id) -> reference-style
    result dict; build COCOevalLite gt/dt lists (bbox + rle) and the
    per-image compute_ap inputs."""
    from slam_maskrcnn_tpu_torch.eval.metrics import compute_ap

    gts, dts = [], []
    ap50s = []
    for image_id in image_ids:
        gt_mask, gt_ids = dataset.load_mask(image_id)
        gt_boxes = _boxes_of(gt_mask)
        for j in range(gt_mask.shape[-1]):
            gts.append({"image_id": int(image_id),
                        "class_id": int(abs(gt_ids[j])),
                        "bbox": gt_boxes[j].tolist(),
                        "rle": rle_encode(gt_mask[:, :, j].astype(np.uint8)),
                        "area": float(gt_mask[:, :, j].sum()),
                        "iscrowd": 0})
        r = get_result(image_id)
        for j in range(len(r["scores"])):
            dts.append({"image_id": int(image_id),
                        "class_id": int(r["class_ids"][j]),
                        "bbox": np.asarray(r["rois"][j],
                                           np.float64).tolist(),
                        "rle": rle_encode(
                            r["masks"][:, :, j].astype(np.uint8)),
                        "score": float(r["scores"][j]),
                        "area": float(r["masks"][:, :, j].sum()),
                        "iscrowd": 0})
        if gt_ids.size:
            ap, _, _, _ = compute_ap(
                gt_boxes.astype(np.float32), np.abs(gt_ids), gt_mask,
                np.asarray(r["rois"], np.float32),
                np.asarray(r["class_ids"]), np.asarray(r["scores"]),
                r["masks"])
            ap50s.append(ap)
    return gts, dts, (float(np.mean(ap50s)) if ap50s else 0.0)


def _boxes_of(mask):
    from slam_maskrcnn_tpu_torch.data.dataset import extract_bboxes

    return extract_bboxes(mask).astype(np.float64)


def run_protocol(dataset, get_result, verbose: bool = True):
    """COCOevalLite bbox+segm over dataset with predictions from
    get_result(image_id); returns the stats dict incl. the compute_ap@50
    cross-check."""
    from slam_maskrcnn_tpu_torch.eval.cocoeval import COCOevalLite

    gts, dts, mean_ap50 = _results_to_eval_lists(
        dataset, dataset.image_ids, get_result)
    out = {}
    for iou_type in ("bbox", "segm"):
        ev = COCOevalLite(gts, dts, iou_type=iou_type)
        r = ev.evaluate()
        if verbose:
            print(f"--- {iou_type} ---")
            ev.summarize()
        md = max(ev.max_dets)
        all_md = r[("all", md)]
        out[iou_type] = {"ap": all_md["ap"],
                         "ap50": all_md["ap_per_thr"][0],
                         "ap75": all_md["ap_per_thr"][5],
                         "ar": all_md["ar"]}
    out["compute_ap50_mean"] = mean_ap50
    # AP@0.50 is the matterport-comparable number. The two protocols
    # differ (101-pt interpolated, class-then-average vs per-image VOC
    # AP) so this is a sanity cross-check, not an equality.
    out["cocoeval_ap50_bbox"] = out["bbox"]["ap50"]
    if verbose:
        print(f"compute_ap@50 per-image mean: {mean_ap50:.4f} vs "
              f"COCOeval AP50(bbox) {out['bbox']['ap50']:.4f}")
    return out


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("command", choices=["generate", "evaluate"])
    p.add_argument("--dir", required=True)
    p.add_argument("--images", type=int, default=200)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--weights", default=None)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--dtype", default="bfloat16",
                   help="the model's COMPUTE_DTYPE: bfloat16 or float32")
    a = p.parse_args(argv)

    if a.command == "generate":
        path = make_mini_coco(a.dir, a.images, a.size, seed=a.seed)
        print("wrote", path)
        return path

    from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN

    class MiniInferenceConfig(MiniCocoConfig):
        COMPUTE_DTYPE = a.dtype

    ds = CocoDataset()
    ds.load_coco(a.dir, "val", "2014",
                 max_images=a.limit or None)
    ds.prepare()
    model = MaskRCNN("inference", MiniInferenceConfig(), device=a.device)
    if a.weights:
        model.load_weights(a.weights, by_name=True)
    else:
        model.init_params()

    def get_result(image_id):
        img = ds.load_image(image_id)
        return model.detect([img], verbose=0)[0]

    stats = run_protocol(ds, get_result)
    print(json.dumps({k: v for k, v in stats.items()
                      if not isinstance(v, list)}))
    return stats


if __name__ == "__main__":
    main()
