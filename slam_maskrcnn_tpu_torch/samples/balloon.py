"""Balloon sample: single-class fine-tune + color-splash effect.

Port of slam_maskrcnn_tpu/samples/balloon.py
(``Mask_RCNN/samples/balloon/balloon.py``): BalloonConfig (:39-63),
BalloonDataset over the VIA polygon JSON (:66-139), ``color_splash``
(:141-157) and ``detect_and_color_splash`` for images and video
(:160-207). Images are sized from their PNG or JPEG headers and read by
data/image_io.py (``imread`` in place of ``cv2.imread``), VIA polygons
are filled as cv2.fillPoly fills them (data/draw.py), the splash is
grayed with cv2's fixed-point RGB2GRAY (ops/blur.py); a video is a
Motion-JPEG AVI read and written by data/avi.py (in place of
``cv2.VideoCapture`` / ``cv2.VideoWriter(..., "MJPG")``).

    python -m slam_maskrcnn_tpu_torch.samples.balloon splash \
        --weights balloon.h5 --image photo.jpg
    python -m slam_maskrcnn_tpu_torch.samples.balloon splash \
        --weights balloon.h5 --video clip.avi
"""

from __future__ import annotations

import datetime
import json
import os

import numpy as np

from slam_maskrcnn_tpu_torch.data.dataset import Dataset
from slam_maskrcnn_tpu_torch.data.image_io import image_size
from slam_maskrcnn_tpu_torch.models.config import Config


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
            h, w = image_size(path)
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
    """= balloon.py:160-207: detect, splash and write ``splash_<time>.png``
    for an image, or ``splash_<time>.avi`` (Motion-JPEG, the input's size
    and frame rate) for a Motion-JPEG AVI; returns the written path. The
    JPEG stages run on the model's device."""
    from slam_maskrcnn_tpu_torch.data.avi import AviReader, AviWriter
    from slam_maskrcnn_tpu_torch.data.image_io import imread, imwrite

    assert image_path or video_path
    dev = model.device
    if image_path:
        bgr = imread(image_path, device=dev)
        if bgr is None:
            raise FileNotFoundError(image_path)
        image = bgr[:, :, ::-1]
        r = model.detect([np.ascontiguousarray(image)], verbose=0)[0]
        splash = color_splash(image, r["masks"])
        name = "splash_{:%Y%m%dT%H%M%S}.png".format(datetime.datetime.now())
        out = os.path.join(out_dir, name)
        imwrite(out, np.ascontiguousarray(splash[:, :, ::-1]))
        return out
    vcapture = AviReader(video_path)
    width, height, fps = vcapture.width, vcapture.height, vcapture.fps
    name = "splash_{:%Y%m%dT%H%M%S}.avi".format(datetime.datetime.now())
    out = os.path.join(out_dir, name)
    vwriter = AviWriter(out, fps, (width, height), device=dev)
    try:                    # the frames written so far stay a whole file
        for i in range(len(vcapture)):
            image = vcapture.read(i, device=dev)[:, :, ::-1]
            r = model.detect([np.ascontiguousarray(image)], verbose=0)[0]
            splash = color_splash(image, r["masks"])
            vwriter.write(np.ascontiguousarray(splash[:, :, ::-1]))
    finally:
        vwriter.release()
        vcapture.close()
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
    p.add_argument("--image", default=None,
                   help="a PNG or JPEG to splash")
    p.add_argument("--video", default=None,
                   help="a Motion-JPEG AVI to splash")
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
