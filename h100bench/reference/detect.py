"""The detector's host path, plain PyTorch: a frozen copy of the port's
``models/mask_rcnn.py`` molding and unmolding (``resize_image`` with
cv2's INTER_LINEAR arithmetic, ``mold_inputs``, ``detect``,
``unmold_detections``; model.py:2332-2492) and of ``mask_ops.mask_detect``
(dmask.py:47-59), around the reference graph: stage 1's label image of an
RGB frame.
"""

from __future__ import annotations

import numpy as np
import torch

from h100bench.reference.anchors import get_anchors
from h100bench.reference.mask_ops import (filter_tiny_objects,
                                          preserve_small_objs)
from h100bench.reference.resize import resize_linear


def _pad(image: torch.Tensor, padding) -> torch.Tensor:
    (t, b), (l, r), _ = padding
    out = image.new_zeros((image.shape[0] + t + b, image.shape[1] + l + r)
                          + tuple(image.shape[2:]))
    out[t:t + image.shape[0], l:l + image.shape[1]] = image
    return out


def resize_image(image, min_dim=None, max_dim=None, min_scale=None,
                 mode="square", rect_shape=None):
    """= ``utils.resize_image`` (utils.py:392-497) in the square, rect and
    none modes, with cv2's INTER_LINEAR arithmetic (ops/resize.py). image
    u8 [H, W, 3], a tensor (any device) or numpy. Returns (image tensor,
    window (y1, x1, y2, x2), scale, padding)."""
    image = torch.as_tensor(image)
    h, w = image.shape[:2]
    window = (0, 0, h, w)
    scale = 1.0
    if mode == "none":
        return image, window, scale, [(0, 0), (0, 0), (0, 0)]
    if mode == "rect":
        mh, mw = rect_shape
        scale = min(mh / h, mw / w)
        if min_scale and scale < min_scale:
            scale = min_scale
        image = resize_linear(image, (round(h * scale), round(w * scale)))
        h2, w2 = image.shape[:2]
        top, left = (mh - h2) // 2, (mw - w2) // 2
        padding = [(top, mh - h2 - top), (left, mw - w2 - left), (0, 0)]
        return (_pad(image, padding), (top, left, h2 + top, w2 + left),
                scale, padding)
    if min_dim:
        scale = max(1.0, min_dim / min(h, w))
    if min_scale and scale < min_scale:
        scale = min_scale
    if max_dim and mode == "square":
        image_max = max(h, w)
        if round(image_max * scale) > max_dim:
            scale = max_dim / image_max
    if scale != 1:
        image = resize_linear(image, (round(h * scale), round(w * scale)))
    h2, w2 = image.shape[:2]
    if mode == "square":
        top, left = (max_dim - h2) // 2, (max_dim - w2) // 2
        padding = [(top, max_dim - h2 - top), (left, max_dim - w2 - left),
                   (0, 0)]
        window = (top, left, h2 + top, w2 + left)
    else:
        raise ValueError(f"mode {mode} not supported")
    return _pad(image, padding), window, scale, padding


def mold_image(image: torch.Tensor, config) -> torch.Tensor:
    """Subtract the mean pixel (``model.py:2706-2713``): f32 out."""
    mean = torch.as_tensor(np.asarray(config.MEAN_PIXEL, np.float32),
                           device=image.device)
    return image.to(torch.float32) - mean


def unmold_mask(mask28: torch.Tensor, bbox, image_shape) -> torch.Tensor:
    """Paste one 28x28 mask into the full image (``utils.unmold_mask``,
    utils.py:565-581): resized to its box in float32 with cv2's bilinear
    arithmetic, thresholded at 127.5 for the device's u8 masks (0.5 for
    float ones). Returns bool [H, W] on the mask's device."""
    y1, x1, y2, x2 = (int(v) for v in bbox)
    full = torch.zeros(tuple(image_shape[:2]), dtype=torch.bool,
                       device=mask28.device)
    if y2 <= y1 or x2 <= x1:
        return full
    m = resize_linear(mask28.to(torch.float32), (y2 - y1, x2 - x1))
    full[y1:y2, x1:x2] = m >= (127.5 if mask28.dtype == torch.uint8
                               else 0.5)
    return full

class HostDetector:
    """The port's ``MaskRCNN`` inference API over a reference graph
    (``module``) and a configuration object."""

    def __init__(self, module, config, device):
        self.module, self.config = module, config
        self.device = torch.device(device)
        self._anchors = {}

    def mold_inputs(self, images):
        """= model.py:2332-2369, on the model's device. Returns (resized u8
        [B, H, W, 3] tensor, windows [B, 4] numpy); the mean pixel is
        subtracted in ``detect``."""
        cfg = self.config
        molded, windows = [], []
        for img in images:
            m, window, _, _ = resize_image(
                torch.as_tensor(np.asarray(img)).to(self.device),
                cfg.IMAGE_MIN_DIM, cfg.IMAGE_MAX_DIM, cfg.IMAGE_MIN_SCALE,
                cfg.IMAGE_RESIZE_MODE,
                rect_shape=getattr(cfg, "IMAGE_RECT_SHAPE", None))
            molded.append(m.to(torch.uint8))
            windows.append(window)
        return torch.stack(molded), np.stack(windows)

    def anchors(self, molded_shape) -> torch.Tensor:
        """Normalized anchors of a molded shape, on the device (cached)."""
        key = tuple(int(s) for s in molded_shape[:2])
        if key not in self._anchors:
            self._anchors[key] = torch.from_numpy(
                get_anchors(self.config, key)).to(self.device)
        return self._anchors[key]

    @staticmethod
    def norm_windows(windows: np.ndarray, molded_shape) -> np.ndarray:
        H, W = molded_shape[:2]
        scale = np.array([H - 1, W - 1, H - 1, W - 1], np.float32)
        shift = np.array([0, 0, 1, 1], np.float32)
        return (windows.astype(np.float32) - shift) / scale

    def run_graph(self, images):
        """Mold ``images`` and run the graph once for all of them. Returns
        (graph outputs, molded [B, H, W, 3] u8, windows [B, 4])."""
        molded, windows = self.mold_inputs(images)
        shape = tuple(molded.shape[1:])
        out = self.module(mold_image(molded, self.config),
                          self.anchors(shape),
                          torch.from_numpy(self.norm_windows(windows, shape))
                          .to(self.device))
        return out, molded, windows

    def detect(self, images, verbose: int = 0):
        """Detection on a list of RGB images (``model.py:2436-2492``), one
        graph run for all. Returns one dict per image: rois [N, 4] pixel
        (y1, x1, y2, x2) i32, class_ids [N], scores [N], masks [H, W, N]
        bool, as numpy."""
        out, molded, windows = self.run_graph(images)
        detections = out["detections"].cpu().numpy()
        return [self.unmold_detections(detections[i], out["masks"][i],
                                       np.asarray(img).shape,
                                       tuple(molded.shape[1:]), windows[i])
                for i, img in enumerate(images)]

    def unmold_detections(self, detections, mrcnn_mask, original_shape,
                          molded_shape, window):
        """= model.py:2371-2434. detections [D, 6] numpy (molded,
        normalized); mrcnn_mask [D, 28, 28] u8 (a tensor on any device, or
        numpy), already class-selected."""
        zero_ix = np.where(detections[:, 4] == 0)[0]
        N = zero_ix[0] if zero_ix.shape[0] > 0 else detections.shape[0]

        boxes = detections[:N, :4]
        class_ids = detections[:N, 4].astype(np.int32)
        scores = detections[:N, 5]

        # window in normalized coords of the molded image
        H, W = molded_shape[:2]
        scale = np.array([H - 1, W - 1, H - 1, W - 1], np.float32)
        shift = np.array([0, 0, 1, 1], np.float32)
        wy1, wx1, wy2, wx2 = (np.array(window, np.float32) - shift) / scale
        wh, ww = wy2 - wy1, wx2 - wx1
        boxes = (boxes - np.array([wy1, wx1, wy1, wx1])) / np.array(
            [wh, ww, wh, ww])
        # to original-image pixel coords (np.around: half to even)
        oh, ow = original_shape[:2]
        oscale = np.array([oh - 1, ow - 1, oh - 1, ow - 1], np.float32)
        boxes = np.around(boxes * oscale + shift).astype(np.int32)

        # drop zero-area boxes (model.py:2409-2416)
        keep = np.where((boxes[:, 2] > boxes[:, 0])
                        & (boxes[:, 3] > boxes[:, 1]))[0]
        boxes, class_ids, scores = boxes[keep], class_ids[keep], scores[keep]
        masks = torch.as_tensor(mrcnn_mask)[:N]
        masks = masks[torch.from_numpy(keep).to(masks.device)]
        if len(keep):
            full = torch.stack([unmold_mask(masks[i], boxes[i],
                                            original_shape)
                                for i in range(len(keep))], -1)
            full = full.cpu().numpy()
        else:
            full = np.empty(tuple(original_shape[:2]) + (0,), bool)
        return dict(rois=boxes, class_ids=class_ids, scores=scores,
                    masks=full)


def mask_detect(model, rgb_image: np.ndarray) -> np.ndarray:
    """detect -> filter -> label-encode (``dmask.py:47-59``), no depth
    filter. Returns uint8 [H, W] with instance i's pixels = i+1."""
    result = model.detect([rgb_image], verbose=0)[0]
    masks = filter_tiny_objects(result["masks"].astype(bool))
    masks = preserve_small_objs(masks)
    cls = np.zeros(rgb_image.shape[:2], np.uint8)
    for i in range(masks.shape[2]):
        cls[masks[:, :, i]] = i + 1
    return cls
