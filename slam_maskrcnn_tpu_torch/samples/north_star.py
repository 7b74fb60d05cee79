"""The north-star frame: detect -> label-encode -> probe -> associate ->
relabel -> fuse, per frame, all on the device.

Port of slam_maskrcnn_tpu/samples/north_star.py with render mode "none"
(``north_star_step_impl(..., render_mode="none")``): the in-loop splat
render and the paired/chunked forms are not ported yet. Per-frame inputs
are depth u16 [H, W], color BGR u8 [H, W, 3] and the extrinsic2init
[4, 4]; ``NorthStar.step`` returns (state, global-id mask, misses), where
misses is always 0 (the CUDA fuse kernel gathers every voxel's pixel; it
has no rect to miss).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from slam_maskrcnn_tpu_torch.fusion.pipeline import fusion_step
from slam_maskrcnn_tpu_torch.fusion.state import FusionConfig
from slam_maskrcnn_tpu_torch.models.anchors import get_anchors
from slam_maskrcnn_tpu_torch.models.mask_ops import label_masks_device


def device_mold_geometry(model_config, H: int, W: int):
    """Static molding geometry for a fixed sensor size (``resize_image``'s
    square and rect modes, utils.py:392-497). Returns (rh, rw, top, left,
    mh, mw, nwin [1, 4] f32)."""
    mode = model_config.IMAGE_RESIZE_MODE
    if mode not in ("square", "rect"):
        raise NotImplementedError("device molding implements the square and "
                                  "rect resize modes")
    if mode == "rect":
        mh, mw = (int(s) for s in model_config.IMAGE_RECT_SHAPE)
        scale = min(mh / H, mw / W)
        if model_config.IMAGE_MIN_SCALE:
            scale = max(scale, model_config.IMAGE_MIN_SCALE)
    else:
        mh = mw = int(model_config.IMAGE_MAX_DIM)
        scale = max(1.0, model_config.IMAGE_MIN_DIM / min(H, W))
        if model_config.IMAGE_MIN_SCALE:
            scale = max(scale, model_config.IMAGE_MIN_SCALE)
        if round(max(H, W) * scale) > model_config.IMAGE_MAX_DIM:
            scale = model_config.IMAGE_MAX_DIM / max(H, W)
    rh, rw = round(H * scale), round(W * scale)
    top, left = (mh - rh) // 2, (mw - rw) // 2
    win_px = np.array([top, left, top + rh, left + rw], np.float32)
    den = np.array([mh - 1, mw - 1, mh - 1, mw - 1], np.float32)
    shift = np.array([0, 0, 1, 1], np.float32)
    nwin = ((win_px - shift) / den)[None]
    return rh, rw, top, left, mh, mw, nwin


def resize_bilinear(img: torch.Tensor, rh: int, rw: int) -> torch.Tensor:
    """= jax.image.resize(img [H, W, C], (rh, rw, C), "bilinear"): half-pixel
    centres, and a widened (antialiasing) triangle when shrinking."""
    H, W = img.shape[:2]
    if (rh, rw) == (H, W):
        return img
    x = img.permute(2, 0, 1)[None]
    x = F.interpolate(x, size=(rh, rw), mode="bilinear", align_corners=False,
                      antialias=rh < H or rw < W)
    return x[0].permute(1, 2, 0)


def detect_mask_impl(module, anchors, nwin, color_bgr: torch.Tensor,
                     H: int, W: int, geom, mean_pixel: torch.Tensor,
                     mark=None) -> torch.Tensor:
    """Device molding + Mask R-CNN + label-encode for one frame (stage 1
    of the reference, mask_process.py:97-105 + dmask.py:47-59). Returns the
    label image u8 [H, W]."""
    rh, rw, top, left, mh, mw = geom
    rgb = color_bgr.flip(-1).to(torch.float32)
    img = resize_bilinear(rgb, rh, rw)
    img = F.pad(img, (0, 0, left, mw - rw - left, top, mh - rh - top))
    out = module((img - mean_pixel)[None], anchors, nwin)
    if mark is not None:
        mark("detect")
    return label_masks_device(out["detections"][0], out["masks"][0],
                              nwin[0], (H, W), min_area=2000)


class NorthStar:
    """Per-frame runner of the north-star step (render mode "none") for a
    model (models.mask_rcnn.MaskRCNN) on its device."""

    def __init__(self, model, intrinsic, cfg: FusionConfig, H: int, W: int,
                 render_mode: str = "none"):
        if render_mode != "none":
            raise NotImplementedError("the in-loop render is not ported yet")
        self.model, self.cfg, self.H, self.W = model, cfg, H, W
        dev = model.device
        g = device_mold_geometry(model.config, H, W)
        self.geom = tuple(g[:6])
        self.nwin = torch.from_numpy(g[6]).to(dev)
        mh, mw = self.geom[4], self.geom[5]
        self.anchors = torch.from_numpy(
            get_anchors(model.config, (mh, mw, 3))).to(dev)
        self.intrinsic = np.asarray(intrinsic, np.float32)
        self.mean_pixel = torch.as_tensor(
            np.asarray(model.config.MEAN_PIXEL, np.float32), device=dev)

    def detect(self, color_bgr: torch.Tensor, mark=None) -> torch.Tensor:
        """Label image u8 [H, W] of one frame."""
        return detect_mask_impl(self.model.module, self.anchors, self.nwin,
                                color_bgr, self.H, self.W, self.geom,
                                self.mean_pixel, mark)

    @torch.no_grad()
    def step(self, state, depth: torch.Tensor, color_bgr: torch.Tensor,
             e2i, mark=None):
        """One frame. depth/color tensors on the model's device, e2i a
        [4, 4] float32 array. ``mark(stage)``, if given, is called after
        each stage ("detect", "label", "associate", "fuse"), e.g. to record
        CUDA events. Returns (state, mask_g [H, W] u8, misses=0)."""
        mask = self.detect(color_bgr, mark)
        if mark is not None:
            mark("label")
        state, mask_g = fusion_step(state, depth, color_bgr, mask, e2i,
                                    self.intrinsic, self.cfg, mark)
        return state, mask_g, 0
