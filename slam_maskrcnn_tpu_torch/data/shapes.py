"""Synthetic shapes dataset, the on-the-fly training fixture.

Port of slam_maskrcnn_tpu/data/shapes.py (``ShapesConfig``,
``ShapesDataset``; ``Mask_RCNN/samples/shapes/shapes.py:28-191``):
random squares, circles and triangles on a flat background, generated
from a seed. The JAX package draws them with cv2; the port draws them
with data/draw.py, pixel for pixel the same. The trained checkpoint
``weights/shapes_r2_f16.h5`` was made with ``ShapesConfig``.
"""

from __future__ import annotations

import numpy as np

from slam_maskrcnn_tpu_torch.data import draw
from slam_maskrcnn_tpu_torch.data.dataset import Dataset
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


class ShapesDataset(Dataset):
    """Procedural shapes (shapes.py:63-191), the same draws from
    ``np.random.default_rng(seed)`` as the JAX package."""

    CLASS_NAMES = ["square", "circle", "triangle"]

    def load_shapes(self, count, height, width, seed=0):
        rng = np.random.default_rng(seed)
        for i, name in enumerate(self.CLASS_NAMES):
            self.add_class("shapes", i + 1, name)
        for i in range(count):
            bg_color, shapes = self._random_image(rng, height, width)
            self.add_image("shapes", image_id=i, path=None,
                           width=width, height=height,
                           bg_color=bg_color, shapes=shapes)

    def _random_shape(self, rng, height, width):
        shape = rng.choice(self.CLASS_NAMES)
        color = tuple(int(c) for c in rng.integers(0, 255, 3))
        buffer = 20
        y = int(rng.integers(buffer, height - buffer - 1))
        x = int(rng.integers(buffer, width - buffer - 1))
        s = int(rng.integers(buffer, height // 4))
        return shape, color, (x, y, s)

    def _random_image(self, rng, height, width):
        bg_color = np.array([int(c) for c in rng.integers(0, 255, 3)])
        shapes = []
        boxes = []
        N = int(rng.integers(1, 4))
        for _ in range(N):
            shape, color, dims = self._random_shape(rng, height, width)
            shapes.append((shape, color, dims))
            x, y, s = dims
            boxes.append([y - s, x - s, y + s, x + s])
        # suppress heavy overlaps (shapes.py:166-171: keep NMS 0.3 survivors)
        boxes = np.array(boxes)
        keep = self._nms_keep(boxes, np.arange(N), 0.3)
        shapes = [s for i, s in enumerate(shapes) if i in keep]
        return bg_color, shapes

    @staticmethod
    def _nms_keep(boxes, scores, threshold):
        if len(boxes) == 0:
            return set()
        ixs = list(np.argsort(scores)[::-1])
        keep = set()
        while ixs:
            i = ixs.pop(0)
            keep.add(i)
            rest = []
            for j in ixs:
                y1 = max(boxes[i][0], boxes[j][0])
                x1 = max(boxes[i][1], boxes[j][1])
                y2 = min(boxes[i][2], boxes[j][2])
                x2 = min(boxes[i][3], boxes[j][3])
                inter = max(y2 - y1, 0) * max(x2 - x1, 0)
                a = ((boxes[i][2] - boxes[i][0]) * (boxes[i][3] - boxes[i][1])
                     + (boxes[j][2] - boxes[j][0]) * (boxes[j][3] - boxes[j][1])
                     - inter)
                if inter / max(a, 1e-9) <= threshold:
                    rest.append(j)
            ixs = rest
        return keep

    def _draw(self, image, shape, color, dims):
        x, y, s = dims
        if shape == "square":
            draw.rectangle(image, (x - s, y - s), (x + s, y + s), color)
        elif shape == "circle":
            draw.circle(image, (x, y), s, color)
        elif shape == "triangle":
            pts = np.array([[(x, y - s),
                             (x - s / np.sin(np.radians(60)), y + s),
                             (x + s / np.sin(np.radians(60)), y + s)]],
                           np.int32)
            draw.fill_poly(image, pts, color)
        return image

    def load_image(self, image_id):
        info = self.image_info[image_id]
        image = np.ones([info["height"], info["width"], 3], np.uint8)
        image = image * info["bg_color"].astype(np.uint8)[None, None]
        image = np.ascontiguousarray(image)
        for shape, color, dims in info["shapes"]:
            image = self._draw(image, shape, color, dims)
        return image

    def load_mask(self, image_id):
        info = self.image_info[image_id]
        shapes = info["shapes"]
        n = len(shapes)
        mask = np.zeros([info["height"], info["width"], n], np.uint8)
        for i, (shape, _, dims) in enumerate(shapes):
            mask[:, :, i:i + 1] = self._draw(
                mask[:, :, i:i + 1].copy(), shape, 1, dims)
        # occlusion: later shapes hide earlier ones (shapes.py:134-139)
        occlusion = np.logical_not(mask[:, :, -1]).astype(np.uint8)
        for i in range(n - 2, -1, -1):
            mask[:, :, i] = mask[:, :, i] * occlusion
            occlusion = np.logical_and(
                occlusion, np.logical_not(mask[:, :, i]))
        class_ids = np.array([self.CLASS_NAMES.index(s[0]) + 1
                              for s in shapes], np.int32)
        keep = mask.any(axis=(0, 1))
        return mask[:, :, keep].astype(bool), class_ids[keep]

    def image_reference(self, image_id):
        info = self.image_info[image_id]
        return info["shapes"] if info["source"] == "shapes" else ""
