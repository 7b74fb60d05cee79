"""Anchor generation for the FPN RPN.

Copy of slam_maskrcnn_tpu/models/anchors.py (numpy; the port keeps its own
copy).

Host-side numpy, computed once per image shape and cached (the reference
caches too, ``model.py:2552-2572``). Semantics of
``utils.generate_anchors``/``generate_pyramid_anchors``
(``Mask_RCNN/mrcnn/utils.py:588-654``): one scale per pyramid level, all
ratios per cell, centers at feature_stride spacing, boxes (y1, x1, y2, x2).
"""

from __future__ import annotations

import numpy as np


def generate_anchors(scales, ratios, shape, feature_stride, anchor_stride):
    """Anchors for one level. scales scalar/list, ratios list,
    shape = (feat_h, feat_w). Returns [N, 4] pixel coords."""
    scales, ratios = np.meshgrid(np.array(scales), np.array(ratios))
    scales = scales.flatten()
    ratios = ratios.flatten()

    heights = scales / np.sqrt(ratios)
    widths = scales * np.sqrt(ratios)

    shifts_y = np.arange(0, shape[0], anchor_stride) * feature_stride
    shifts_x = np.arange(0, shape[1], anchor_stride) * feature_stride
    shifts_x, shifts_y = np.meshgrid(shifts_x, shifts_y)

    box_widths, box_centers_x = np.meshgrid(widths, shifts_x)
    box_heights, box_centers_y = np.meshgrid(heights, shifts_y)

    box_centers = np.stack([box_centers_y, box_centers_x], axis=2).reshape(-1, 2)
    box_sizes = np.stack([box_heights, box_widths], axis=2).reshape(-1, 2)

    return np.concatenate([box_centers - 0.5 * box_sizes,
                           box_centers + 0.5 * box_sizes], axis=1)


def generate_pyramid_anchors(scales, ratios, feature_shapes, feature_strides,
                             anchor_stride):
    """All levels concatenated, same order as the reference (P2 first)."""
    anchors = [generate_anchors(scales[i], ratios, feature_shapes[i],
                                feature_strides[i], anchor_stride)
               for i in range(len(scales))]
    return np.concatenate(anchors, axis=0)


def compute_backbone_shapes(config, image_shape):
    """Feature map sizes per backbone level (``model.py:2533-2550`` /
    ``compute_backbone_shapes``)."""
    return np.array([
        [int(np.ceil(image_shape[0] / stride)),
         int(np.ceil(image_shape[1] / stride))]
        for stride in config.BACKBONE_STRIDES])


_ANCHOR_CACHE: dict = {}


def get_anchors(config, image_shape):
    """Normalized anchors for an image shape, cached (model.py:2552-2572)."""
    key = (config.NAME, tuple(image_shape[:2]))
    if key not in _ANCHOR_CACHE:
        shapes = compute_backbone_shapes(config, image_shape)
        a = generate_pyramid_anchors(config.RPN_ANCHOR_SCALES,
                                     config.RPN_ANCHOR_RATIOS, shapes,
                                     config.BACKBONE_STRIDES,
                                     config.RPN_ANCHOR_STRIDE)
        h, w = image_shape[:2]
        scale = np.array([h - 1, w - 1, h - 1, w - 1])
        shift = np.array([0, 0, 1, 1])
        _ANCHOR_CACHE[key] = ((a - shift) / scale).astype(np.float32)
    return _ANCHOR_CACHE[key]
