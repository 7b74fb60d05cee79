"""Inference demo — the ``demo.ipynb`` walkthrough as a script.

Port of slam_maskrcnn_tpu/samples/demo.py: load a (COCO-class) Mask
R-CNN, run detection on images, save a display_instances composite per
image as ``<name>_det.png``. Images are read by data/image_io.py
``imread`` (PNG or JPEG, ``None`` for an unreadable file), the composite
is drawn by viz/visualize.py and written as PNG. Runs on the card unless
``--device cpu``.

    python -m slam_maskrcnn_tpu_torch.samples.demo img.jpg --out out/ \\
        [--weights mask_rcnn_coco.h5]

``main`` returns one record per image written: its path, the output path,
the detections, the composite and the milliseconds of each stage (read,
detect, composite, write).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("images", nargs="+", help="image files")
    p.add_argument("--weights", default=None)
    p.add_argument("--out", default="./detect_out")
    p.add_argument("--min-confidence", type=float, default=0.7)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)

    import torch

    from slam_maskrcnn_tpu_torch.data.image_io import imread, imwrite
    from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from slam_maskrcnn_tpu_torch.samples.coco import (COCO_CLASS_NAMES,
                                                      CocoInferenceConfig)
    from slam_maskrcnn_tpu_torch.viz.visualize import display_instances

    class Cfg(CocoInferenceConfig):
        DETECTION_MIN_CONFIDENCE = a.min_confidence

    model = MaskRCNN("inference", Cfg(), device=a.device)
    if a.weights:
        model.load_weights(a.weights, by_name=True)
    else:
        print("WARNING: no --weights given; using random init "
              "(detections will be meaningless)")
        model.init_params()

    def sync():
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)

    os.makedirs(a.out, exist_ok=True)
    records = []
    for path in a.images:
        t0 = time.perf_counter()
        bgr = imread(path, device=model.device)
        sync()
        if bgr is None:
            print(f"skip {path}: unreadable")
            continue
        rgb = np.ascontiguousarray(bgr[:, :, ::-1])
        t1 = time.perf_counter()
        r = model.detect([rgb], verbose=0)[0]
        sync()
        t2 = time.perf_counter()
        out_path = os.path.join(
            a.out, os.path.splitext(os.path.basename(path))[0] + "_det.png")
        composite = display_instances(
            rgb, r["rois"], r["masks"], r["class_ids"], COCO_CLASS_NAMES,
            r["scores"], show=False)
        t3 = time.perf_counter()
        imwrite(out_path, np.ascontiguousarray(composite[:, :, ::-1]))
        t4 = time.perf_counter()
        names = [COCO_CLASS_NAMES[c] for c in r["class_ids"]]
        print(f"{path}: {len(names)} detections {names} -> {out_path}")
        records.append(dict(
            path=path, out=out_path, detections=r, composite=composite,
            ms=dict(read=1e3 * (t1 - t0), detect=1e3 * (t2 - t1),
                    composite=1e3 * (t3 - t2), write=1e3 * (t4 - t3))))
    return records


if __name__ == "__main__":
    main()
