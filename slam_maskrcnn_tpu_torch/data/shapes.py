"""The synthetic-shapes configuration.

Port of the configuration half of slam_maskrcnn_tpu/data/shapes.py
(``ShapesConfig``, ``Mask_RCNN/samples/shapes/shapes.py:28-60``): the
trained checkpoint ``weights/shapes_r2_f16.h5`` was made with it. The
procedural ``ShapesDataset`` draws with cv2 and belongs to training; the
committed scenes of data/detect_scenes.npz stand in for it at inference.
"""

from __future__ import annotations

from slam_maskrcnn_tpu_torch.models.config import Config


class ShapesConfig(Config):
    """= ShapesConfig (shapes.py:28-60), scaled for tests: ResNet-50, 4
    classes (background + square, circle, triangle), 128^2 square molding,
    anchors 8-128."""

    NAME = "shapes"
    GPU_COUNT = 1
    IMAGES_PER_GPU = 8
    NUM_CLASSES = 1 + 3  # background + square/circle/triangle
    IMAGE_MIN_DIM = 128
    IMAGE_MAX_DIM = 128
    RPN_ANCHOR_SCALES = (8, 16, 32, 64, 128)
    TRAIN_ROIS_PER_IMAGE = 32
    STEPS_PER_EPOCH = 100
    VALIDATION_STEPS = 5
    BACKBONE = "resnet50"
