"""Balloon sample: single-class fine-tune + color-splash effect.

Port of slam_maskrcnn_tpu/samples/balloon.py
(``Mask_RCNN/samples/balloon/balloon.py``): BalloonConfig (:39-63),
BalloonDataset over the VIA polygon JSON (:66-139), ``color_splash``
(:141-157) and ``detect_and_color_splash`` (:160-207). Image sizes come
from the PNG header, VIA polygons are filled as cv2.fillPoly fills them
(data/draw.py), the splash is grayed with cv2's fixed-point RGB2GRAY
(ops/blur.py) and written by data/png.py. The port has no JPEG decoder and
no video codec: a JPEG image raises in ``Dataset.load_image`` and the
video branch raises ``NotImplementedError``.

    python -m slam_maskrcnn_tpu_torch.samples.balloon splash \
        --weights balloon.h5 --image photo.png
"""

from __future__ import annotations

import datetime
import json
import os

import numpy as np

from slam_maskrcnn_tpu_torch.data.dataset import Dataset
from slam_maskrcnn_tpu_torch.models.config import Config


def png_size(path: str) -> tuple[int, int]:
    """(height, width) from a PNG's IHDR chunk."""
    import struct

    from slam_maskrcnn_tpu_torch.data.png import SIGNATURE, PNGError

    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != SIGNATURE or head[12:16] != b"IHDR":
        raise PNGError(f"{path}: not a PNG file (the port reads only PNG)")
    w, h = struct.unpack(">II", head[16:24])
    return int(h), int(w)


class BalloonConfig(Config):
    NAME = "balloon"
    IMAGES_PER_GPU = 2
    NUM_CLASSES = 1 + 1
    STEPS_PER_EPOCH = 100
    DETECTION_MIN_CONFIDENCE = 0.9


class BalloonDataset(Dataset):
    def load_balloon(self, dataset_dir, subset):
        """VIA-format polygon annotations (balloon.py:78-139)."""
        assert subset in ("train", "val")
        self.add_class("balloon", 1, "balloon")
        dataset_dir = os.path.join(dataset_dir, subset)
        ann = json.load(open(os.path.join(dataset_dir,
                                          "via_region_data.json")))
        for a in ann.values():
            if not a.get("regions"):
                continue
            regions = (a["regions"].values()
                       if isinstance(a["regions"], dict) else a["regions"])
            polygons = [r["shape_attributes"] for r in regions]
            path = os.path.join(dataset_dir, a["filename"])
            h, w = png_size(path)
            self.add_image("balloon", image_id=a["filename"], path=path,
                           width=w, height=h, polygons=polygons)

    def load_mask(self, image_id):
        from slam_maskrcnn_tpu_torch.data.draw import fill_poly

        info = self.image_info[image_id]
        if info["source"] != "balloon":
            return super().load_mask(image_id)
        masks = np.zeros([info["height"], info["width"],
                          len(info["polygons"])], np.uint8)
        for i, p in enumerate(info["polygons"]):
            pts = np.stack([p["all_points_x"], p["all_points_y"]],
                           -1).astype(np.int32)
            fill_poly(masks[:, :, i], pts, 1)
        ids = np.ones(masks.shape[-1], np.int32)
        return masks.astype(bool), ids

    def image_reference(self, image_id):
        info = self.image_info[image_id]
        return info["path"] if info["source"] == "balloon" else ""


def color_splash(image, mask):
    """Color where any instance, grayscale elsewhere (balloon.py:141-157)."""
    from slam_maskrcnn_tpu_torch.ops.blur import rgb_to_gray

    gray = rgb_to_gray(image)[..., None]
    gray = np.repeat(gray, 3, axis=-1)
    if mask.shape[-1] > 0:
        keep = mask.any(-1, keepdims=True)
        return np.where(keep, image, gray).astype(np.uint8)
    return gray.astype(np.uint8)


def detect_and_color_splash(model, image_path=None, video_path=None,
                            out_dir="."):
    """= balloon.py:160-207 for an image (a PNG): detect, splash, write
    ``splash_<time>.png``; returns its path. The video branch needs a
    video codec the port does not have: it raises."""
    from slam_maskrcnn_tpu_torch.data.png import read_png, write_png

    assert image_path or video_path
    if not image_path:
        raise NotImplementedError(
            "detect_and_color_splash(video_path=...): the port has no video "
            "reader or writer (cv2.VideoCapture / VideoWriter)")
    image = np.ascontiguousarray(read_png(image_path)[:, :, ::-1])
    r = model.detect([image], verbose=0)[0]
    splash = color_splash(image, r["masks"])
    name = "splash_{:%Y%m%dT%H%M%S}.png".format(datetime.datetime.now())
    out = os.path.join(out_dir, name)
    write_png(out, np.ascontiguousarray(splash[:, :, ::-1]))
    return out


def main(argv=None):
    import argparse

    from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from slam_maskrcnn_tpu_torch.train.trainer import Trainer

    p = argparse.ArgumentParser(description="Balloon: train or splash")
    p.add_argument("command", choices=["train", "splash"])
    p.add_argument("--dataset", default=None,
                   help="root holding train/ and val/ with "
                        "via_region_data.json (train)")
    p.add_argument("--weights", default=None,
                   help="a Keras .h5 or a checkpoint; seeded random "
                        "weights without")
    p.add_argument("--logs", default="./logs")
    p.add_argument("--image", default=None, help="a PNG to splash")
    p.add_argument("--video", default=None)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)
    if a.command == "train":
        config = BalloonConfig()
        model = MaskRCNN("training", config, a.logs, device=a.device)
        if a.weights:
            model.load_weights(a.weights)
        else:
            model.init_params()
        ds = BalloonDataset()
        ds.load_balloon(a.dataset, "train")
        ds.prepare()
        # the reference trains the heads only (balloon.py:196-199)
        return Trainer(model, config).train(
            ds, learning_rate=config.LEARNING_RATE, epochs=a.epochs,
            layers="heads")

    class InferenceConfig(BalloonConfig):
        GPU_COUNT = 1
        IMAGES_PER_GPU = 1

    model = MaskRCNN("inference", InferenceConfig(), a.logs, device=a.device)
    if a.weights:
        model.load_weights(a.weights)
    else:
        model.init_params()
    out = detect_and_color_splash(model, image_path=a.image,
                                  video_path=a.video)
    print("wrote", out)
    return out


if __name__ == "__main__":
    main()
