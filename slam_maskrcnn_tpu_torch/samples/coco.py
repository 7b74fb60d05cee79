"""MS-COCO configurations.

Port of the configuration half of slam_maskrcnn_tpu/samples/coco.py
(``CocoConfig``, ``CocoInferenceConfig``, ``Mask_RCNN/samples/coco/
coco.py:71-87``): ResNet-101, 81 classes, 1024^2 square molding. The COCO
dataset, evaluation and training CLI come with training.
"""

from __future__ import annotations

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
