"""Image meta pack/parse.

A copy of slam_maskrcnn_tpu/models/meta.py:
= ``compose_image_meta`` / ``parse_image_meta`` / ``mold_image`` helpers
(``Mask_RCNN/mrcnn/model.py:2679-2749``): a flat f32 vector carrying
image id, original/molded shapes, window, scale, and active class ids —
the reference threads it through the graph; here it serves the data
pipeline and any code porting over from the reference API.
"""

from __future__ import annotations

import numpy as np


def compose_image_meta(image_id, original_image_shape, image_shape,
                       window, scale, active_class_ids):
    """[id(1), orig_shape(3), shape(3), window(4), scale(1), classes(N)]."""
    return np.array(
        [image_id]
        + list(original_image_shape)
        + list(image_shape)
        + list(window)
        + [scale]
        + list(active_class_ids), np.float32)


def parse_image_meta(meta):
    """Inverse of compose_image_meta; meta [B, M] or [M]."""
    meta = np.atleast_2d(meta)
    return {
        "image_id": meta[:, 0].astype(np.int32),
        "original_image_shape": meta[:, 1:4].astype(np.int32),
        "image_shape": meta[:, 4:7].astype(np.int32),
        "window": meta[:, 7:11].astype(np.int32),
        "scale": meta[:, 11],
        "active_class_ids": meta[:, 12:].astype(np.int32),
    }
