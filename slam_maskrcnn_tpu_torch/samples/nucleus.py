"""Nucleus sample (Kaggle 2018 Data Science Bowl).

Port of slam_maskrcnn_tpu/samples/nucleus.py, which is
``Mask_RCNN/samples/nucleus/nucleus.py``: small-object configs
(crop-512 training / pad64 inference, resnet50, up to 400 instances,
:70-140), per-image mask-folder dataset (:150-230), run-length submission
encoding (``rle_encode`` :302, ``mask_to_rle`` :335) and the detect driver
writing submit.csv (:359-410).

Note this RLE is the *Kaggle* convention (column-major, 1-indexed,
value-sorted), distinct from COCO RLE. The mask PNGs are read by
data/image_io.py at ``IMREAD_GRAYSCALE``, as cv2 reads them (libpng's
colour to gray); detection runs on the card (``--device cpu`` for the plain
versions).

    python -m slam_maskrcnn_tpu_torch.samples.nucleus detect \
        --dataset /data/dsb2018 --subset stage1_test --weights nucleus.h5
"""

from __future__ import annotations

import os

import numpy as np

from slam_maskrcnn_tpu_torch.data.dataset import Dataset
from slam_maskrcnn_tpu_torch.data.image_io import IMREAD_GRAYSCALE, imread
from slam_maskrcnn_tpu_torch.models.config import Config


class NucleusConfig(Config):
    NAME = "nucleus"
    IMAGES_PER_GPU = 6
    NUM_CLASSES = 1 + 1
    BACKBONE = "resnet50"
    IMAGE_RESIZE_MODE = "crop"
    IMAGE_MIN_DIM = 512
    IMAGE_MAX_DIM = 512
    IMAGE_MIN_SCALE = 2.0
    RPN_ANCHOR_SCALES = (8, 16, 32, 64, 128)
    POST_NMS_ROIS_TRAINING = 1000
    POST_NMS_ROIS_INFERENCE = 2000
    RPN_NMS_THRESHOLD = 0.9
    RPN_TRAIN_ANCHORS_PER_IMAGE = 64
    TRAIN_ROIS_PER_IMAGE = 128
    MAX_GT_INSTANCES = 200
    DETECTION_MAX_INSTANCES = 400
    DETECTION_MIN_CONFIDENCE = 0.0
    USE_MINI_MASK = True
    MINI_MASK_SHAPE = (56, 56)
    MEAN_PIXEL = np.array([43.53, 39.56, 48.22])


class NucleusInferenceConfig(NucleusConfig):
    GPU_COUNT = 1
    IMAGES_PER_GPU = 1
    IMAGE_RESIZE_MODE = "pad64"
    IMAGE_MIN_DIM = 512
    IMAGE_MAX_DIM = 1024
    RPN_NMS_THRESHOLD = 0.7


class NucleusDataset(Dataset):
    """DSB2018 layout: <root>/<image_id>/{images,masks}/*.png."""

    def load_nucleus(self, dataset_dir, subset):
        self.add_class("nucleus", 1, "nucleus")
        subset_dir = os.path.join(dataset_dir, subset)
        for image_id in sorted(os.listdir(subset_dir)):
            img = os.path.join(subset_dir, image_id, "images",
                               image_id + ".png")
            if os.path.exists(img):
                self.add_image("nucleus", image_id=image_id, path=img)

    def load_mask(self, image_id):
        info = self.image_info[image_id]
        mask_dir = os.path.join(
            os.path.dirname(os.path.dirname(info["path"])), "masks")
        masks = []
        for f in sorted(os.listdir(mask_dir)):
            if f.endswith(".png"):
                m = imread(os.path.join(mask_dir, f), IMREAD_GRAYSCALE)
                masks.append(m > 0)
        if not masks:
            return np.empty((0, 0, 0), bool), np.empty((0,), np.int32)
        masks = np.stack(masks, -1)
        return masks, np.ones(masks.shape[-1], np.int32)


def rle_encode_kaggle(mask):
    """Kaggle RLE: 1-indexed (start, length) pairs over the column-major
    flattening (nucleus.py:302-320)."""
    assert mask.ndim == 2
    m = mask.T.flatten()
    g = np.diff(np.concatenate([[0], m, [0]]), n=1)
    rle = np.where(g != 0)[0].reshape(-1, 2)
    rle[:, 1] = rle[:, 1] - rle[:, 0]
    rle[:, 0] += 1
    return " ".join(map(str, rle.flatten()))


def rle_decode_kaggle(rle, shape):
    """Inverse of rle_encode_kaggle (nucleus.py:322-333)."""
    rle = list(map(int, rle.split()))
    rle = np.array(rle, np.int32).reshape(-1, 2)
    rle[:, 1] += rle[:, 0]
    rle -= 1
    mask = np.zeros(shape[0] * shape[1], bool)
    for s, e in rle:
        mask[s:e] = True
    return mask.reshape((shape[1], shape[0])).T


def mask_to_rle(image_id, mask, scores):
    """Multi-instance RLE lines, overlaps removed by score order
    (nucleus.py:335-357)."""
    assert mask.ndim == 3
    if mask.shape[-1] == 0:
        return f"{image_id},"
    order = np.argsort(scores)[::-1] + 1
    m = np.max(mask * np.reshape(order, (1, 1, -1)), -1)
    lines = []
    for o in order:
        lines.append(f"{image_id}, " + rle_encode_kaggle(m == o))
    return "\n".join(lines)


def detect(model, dataset_dir, subset, out_dir="."):
    """Run detection and write submit.csv (nucleus.py:359-410)."""
    ds = NucleusDataset()
    ds.load_nucleus(dataset_dir, subset)
    ds.prepare()
    submission = []
    for image_id in ds.image_ids:
        image = ds.load_image(image_id)
        r = model.detect([image], verbose=0)[0]
        source_id = ds.image_info[image_id]["id"]
        submission.append(mask_to_rle(source_id, r["masks"], r["scores"]))
    submission = "ImageId,EncodedPixels\n" + "\n".join(submission)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "submit.csv")
    with open(path, "w") as f:
        f.write(submission)
    return path


def main(argv=None):
    import argparse

    from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN

    p = argparse.ArgumentParser(description="Nucleus detection -> submit.csv")
    p.add_argument("command", choices=["detect"])
    p.add_argument("--dataset", required=True)
    p.add_argument("--subset", default="stage1_test")
    p.add_argument("--weights", default=None,
                   help="a Keras .h5 or a checkpoint; seeded random "
                        "weights without")
    p.add_argument("--out", default=".")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)
    model = MaskRCNN("inference", NucleusInferenceConfig(), device=a.device)
    if a.weights:
        model.load_weights(a.weights)
    else:
        model.init_params()
    path = detect(model, a.dataset, a.subset, a.out)
    print("wrote", path)
    return path


if __name__ == "__main__":
    main()
