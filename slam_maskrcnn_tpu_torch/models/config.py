"""Model configuration — class-attribute + subclass-override pattern.

Copy of slam_maskrcnn_tpu/models/config.py (the port keeps its own copy).

Keeps the exact ergonomics of the reference ``Config``
(``Mask_RCNN/mrcnn/config.py:18-204``): subclass, override class attributes,
derived values computed in __init__, ``display()`` dump. Knob names match
the reference so its configs port 1:1.
"""

from __future__ import annotations

import numpy as np


class Config:
    """Base configuration. Subclass and override (reference config.py:18)."""

    NAME = None  # Override in sub-classes

    # Replication factor over devices (reference GPU_COUNT, config.py:31).
    # On TPU this is the data-parallel mesh size used by train/parallel.
    GPU_COUNT = 1
    IMAGES_PER_GPU = 2

    STEPS_PER_EPOCH = 1000
    VALIDATION_STEPS = 50

    BACKBONE = "resnet101"  # resnet50 | resnet101
    # strides of C2..C6 relative to the image (config.py:58)
    BACKBONE_STRIDES = [4, 8, 16, 32, 64]

    NUM_CLASSES = 1  # incl. background

    RPN_ANCHOR_SCALES = (32, 64, 128, 256, 512)
    RPN_ANCHOR_RATIOS = [0.5, 1, 2]
    RPN_ANCHOR_STRIDE = 1
    RPN_NMS_THRESHOLD = 0.7
    RPN_TRAIN_ANCHORS_PER_IMAGE = 256

    POST_NMS_ROIS_TRAINING = 2000
    POST_NMS_ROIS_INFERENCE = 1000
    # top-k candidates kept before proposal NMS (model.py:293)
    PRE_NMS_LIMIT = 6000

    USE_MINI_MASK = True
    MINI_MASK_SHAPE = (56, 56)

    # square: resize preserving aspect, pad to IMAGE_MAX_DIM^2 (config.py:102)
    # rect (TPU-first extension, not in the reference): resize preserving
    # aspect to fit IMAGE_RECT_SHAPE (h, w — multiples of 64), center-pad.
    # For a fixed-size sensor this removes the square mode's dead padding
    # rows — a 640x480 stream molds to 1024x768 with ZERO padding, cutting
    # backbone+RPN conv FLOPs 25% vs the 1024^2 square mold. Detections
    # map back through the window exactly as in square mode.
    IMAGE_RESIZE_MODE = "square"
    IMAGE_MIN_DIM = 800
    IMAGE_MAX_DIM = 1024
    IMAGE_RECT_SHAPE = (768, 1024)  # used only when IMAGE_RESIZE_MODE="rect"
    IMAGE_MIN_SCALE = 0

    MEAN_PIXEL = np.array([123.7, 116.8, 103.9])

    TRAIN_ROIS_PER_IMAGE = 200
    ROI_POSITIVE_RATIO = 0.33

    POOL_SIZE = 7
    MASK_POOL_SIZE = 14
    MASK_SHAPE = [28, 28]

    MAX_GT_INSTANCES = 100

    RPN_BBOX_STD_DEV = np.array([0.1, 0.1, 0.2, 0.2])
    BBOX_STD_DEV = np.array([0.1, 0.1, 0.2, 0.2])

    DETECTION_MAX_INSTANCES = 100
    DETECTION_MIN_CONFIDENCE = 0.7
    DETECTION_NMS_THRESHOLD = 0.3

    LEARNING_RATE = 0.001
    LEARNING_MOMENTUM = 0.9
    WEIGHT_DECAY = 0.0001

    LOSS_WEIGHTS = {
        "rpn_class_loss": 1.0,
        "rpn_bbox_loss": 1.0,
        "mrcnn_class_loss": 1.0,
        "mrcnn_bbox_loss": 1.0,
        "mrcnn_mask_loss": 1.0,
    }

    USE_RPN_ROIS = True
    # False = freeze BatchNorm (use running stats), the reference default for
    # small batches (config.py:173); our inference path always freezes.
    TRAIN_BN = False
    GRADIENT_CLIP_NORM = 5.0

    # head feature widths (matterport hardcodes these; config'd in later forks)
    FPN_CLASSIF_FC_LAYERS_SIZE = 1024
    TOP_DOWN_PYRAMID_SIZE = 256

    # computation dtype for the conv trunk and heads (bf16 runs on the
    # tensor cores); params, BatchNorm and accumulations stay f32.
    COMPUTE_DTYPE = "bfloat16"

    def __init__(self):
        """Compute derived attributes (reference config.py:180-197)."""
        self.BATCH_SIZE = self.IMAGES_PER_GPU * self.GPU_COUNT
        if self.IMAGE_RESIZE_MODE == "crop":
            self.IMAGE_SHAPE = np.array(
                [self.IMAGE_MIN_DIM, self.IMAGE_MIN_DIM, 3])
        elif self.IMAGE_RESIZE_MODE == "rect":
            rh, rw = self.IMAGE_RECT_SHAPE
            assert rh % 64 == 0 and rw % 64 == 0, \
                "IMAGE_RECT_SHAPE must be multiples of 64 (FPN strides)"
            self.IMAGE_SHAPE = np.array([rh, rw, 3])
        else:
            self.IMAGE_SHAPE = np.array(
                [self.IMAGE_MAX_DIM, self.IMAGE_MAX_DIM, 3])
        self.IMAGE_META_SIZE = 1 + 3 + 3 + 4 + 1 + self.NUM_CLASSES

    def display(self):
        """Print configuration values (reference config.py:198-204)."""
        print("\nConfigurations:")
        for a in dir(self):
            if not a.startswith("__") and not callable(getattr(self, a)):
                print("{:30} {}".format(a, getattr(self, a)))
        print()

    def to_dict(self):
        return {a: getattr(self, a) for a in dir(self)
                if not a.startswith("__") and not callable(getattr(self, a))}
