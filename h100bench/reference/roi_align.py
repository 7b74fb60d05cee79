"""PyramidROIAlign, plain PyTorch: a frozen copy of the port's
``ops/roi_align.py`` plain path (the reference's ``PyramidROIAlign``,
model.py:350-455, with the sample grid as XLA compiles it), which the
port's ROIAlign kernel equals bit for bit. Features are NHWC.
"""

from __future__ import annotations

import numpy as np
import torch


def level_scale(image_shape) -> float:
    """The f32 multiplier of roi_level: 1 / (224 / sqrt(image area)), each
    step rounded to float32. XLA compiles the reference's division by the
    constant 224 / sqrt(area) into a multiplication by this reciprocal;
    the kernel and the plain version multiply by it too."""
    area = np.float32(float(image_shape[0] * image_shape[1]))
    return float(np.float32(1.0) / (np.float32(224.0) / np.sqrt(area)))


def grid_step_scale(extent: int, crop: int) -> float:
    """The f32 constant (extent - 1) * f32(1 / (crop - 1)) of the sample
    grid's step: XLA folds crop_and_resize's (y2 - y1) * (extent - 1) /
    (crop - 1) into (y2 - y1) times this constant (the reference's jitted
    graph, on every backend), and one ulp of the step decides whether a
    box edge clipped to 1.0 samples the level's last row or reads 0."""
    return float(np.float32(extent - 1)
                 * (np.float32(1.0) / np.float32(crop - 1)))


def roi_level(boxes: torch.Tensor, image_shape, min_level=2,
              max_level=5) -> torch.Tensor:
    """FPN level per roi (normalized boxes): 4 + round(log2(sqrt(h*w) /
    (224 / sqrt(image area)))), round half to even, clipped to [2, 5]
    (model.py:375-384); the division a multiplication by
    ``level_scale``. Returns i64 [N]."""
    h = boxes[:, 2] - boxes[:, 0]
    w = boxes[:, 3] - boxes[:, 1]
    scale = torch.sqrt((h * w).clamp_min(1e-12)) * level_scale(image_shape)
    lvl = 4 + torch.round(torch.log2(scale.clamp_min(1e-12)))
    return lvl.clamp(min_level, max_level).long()


def sample_grid(lo: torch.Tensor, hi: torch.Tensor, size: int,
                crop: int) -> torch.Tensor:
    """The crop_and_resize sample coordinates along one axis, f32 [N, crop]:
    origin + k * step with origin = lo * (size - 1) and step = (hi - lo) *
    ``grid_step_scale``, the sum fused as XLA compiles the reference (one
    rounding of the exact k * step + origin: computed in float64, where
    it is exact, then rounded once; the kernel calls fmaf). For crop 1,
    the box centre."""
    if crop == 1:
        return (0.5 * (lo + hi)[:, None] * (size - 1))
    origin = (lo * (size - 1)).double()
    step = ((hi - lo) * grid_step_scale(size, crop)).double()
    k = torch.arange(crop, dtype=torch.float64, device=lo.device)
    return (k[None, :] * step[:, None] + origin[:, None]).float()


def crop_and_resize(image: torch.Tensor, boxes: torch.Tensor,
                    crop_size: tuple[int, int],
                    box_index: torch.Tensor | None = None) -> torch.Tensor:
    """Bilinear crop-and-resize, tf.image.crop_and_resize semantics.

    image [H, W, C] (any float dtype, read as float32); boxes [N, 4]
    normalized. With ``box_index`` [N], image is a batch [B, H, W, C] and
    box i crops image box_index[i]. Returns f32 [N, ch, cw, C]; samples
    outside the image read 0 (extrapolation_value=0). Differentiable in
    ``image``."""
    H, W, C = image.shape[-3:]
    ch, cw = crop_size
    y1, x1, y2, x2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    ys = sample_grid(y1, y2, H, ch)
    xs = sample_grid(x1, x2, W, cw)

    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    # clamp before the integer cast: far-outside samples are masked below
    y0i = y0.clamp(-2, H + 1).long()
    x0i = x0.clamp(-2, W + 1).long()
    flat = image.reshape(-1, C)
    base = (0 if box_index is None
            else (box_index.long() * (H * W))[:, None, None])

    def corner(dy, dx):
        yy = (y0i + dy).clamp(0, H - 1)[:, :, None]
        xx = (x0i + dx).clamp(0, W - 1)[:, None, :]
        # index_select: its gradient is an index_add (the training graph
        # differentiates through this gather)
        return flat.index_select(0, (base + yy * W + xx).reshape(-1)) \
            .reshape(len(boxes), ch, cw, C).float()

    wy = (ys - y0)[:, :, None, None]
    wx = (xs - x0)[:, None, :, None]
    top = corner(0, 0) * (1 - wx) + corner(0, 1) * wx
    bot = corner(1, 0) * (1 - wx) + corner(1, 1) * wx
    out = top * (1 - wy) + bot * wy
    oob = (((ys < 0) | (ys > H - 1))[:, :, None]
           | ((xs < 0) | (xs > W - 1))[:, None, :])
    return torch.where(oob[..., None], torch.zeros_like(out), out)


def _plain_one(features, boxes, pool_size, image_shape, box_index=None):
    """Every box sampled on all four levels, each keeping its own level's
    crop. ``box_index``: the image of each box in batched features."""
    lvl = roi_level(boxes, image_shape)
    out = torch.zeros(boxes.shape[0], pool_size, pool_size,
                      features[0].shape[-1], dtype=torch.float32,
                      device=boxes.device)
    for i, feat in enumerate(features):
        crops = crop_and_resize(feat, boxes, (pool_size, pool_size),
                                box_index)
        out = torch.where((lvl == i + 2)[:, None, None, None], crops, out)
    return out


def pyramid_roi_align_plain(features, boxes: torch.Tensor, pool_size: int,
                            image_shape) -> torch.Tensor:
    """= ops/roi_align.pyramid_roi_align:107. One image: features (P2..P5)
    each [Hl, Wl, C], boxes [N, 4] normalized -> f32 [N, pool, pool, C]. A
    batch: features each [B, Hl, Wl, C], boxes [B, N, 4] -> f32 [B, N,
    pool, pool, C], each box cropping its own image."""
    if boxes.dim() == 2:
        return _plain_one(features, boxes, pool_size, image_shape)
    B, N = boxes.shape[:2]
    which = torch.arange(B, device=boxes.device).repeat_interleave(N)
    out = _plain_one(features, boxes.reshape(B * N, 4), pool_size,
                     image_shape, which)
    return out.reshape((B, N) + out.shape[1:])


def pyramid_roi_align(features, boxes: torch.Tensor, pool_size: int,
                      image_shape) -> torch.Tensor:
    """The inference graph's entry: the plain version on every device."""
    return pyramid_roi_align_plain(features, boxes, pool_size, image_shape)
