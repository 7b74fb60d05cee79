"""ROIAlign: bilinear crop-and-resize + FPN pyramid level routing.

Port of slam_maskrcnn_tpu/ops/roi_align.py (the reference's
``PyramidROIAlign``, model.py:350-455). ``pyramid_roi_align`` launches the
kernel of csrc/roi_align.cu on CUDA tensors and runs the plain version,
``pyramid_roi_align_plain``, on CPU tensors. Features are NHWC, as in the
JAX package.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from slam_maskrcnn_tpu_torch import kernels
from slam_maskrcnn_tpu_torch.device import on_cuda


def level_denominator(image_shape) -> float:
    """224 / sqrt(image area) in float32, the roi_level divisor (computed
    once on the host, shared by the kernel and the plain version)."""
    area = np.float32(float(image_shape[0] * image_shape[1]))
    return float(np.float32(224.0) / np.sqrt(area))


def roi_level(boxes: torch.Tensor, image_shape, min_level=2,
              max_level=5) -> torch.Tensor:
    """FPN level per roi (normalized boxes): 4 + round(log2(sqrt(h*w) /
    (224 / sqrt(image area)))), round half to even, clipped to [2, 5]
    (model.py:375-384). Returns i64 [N]."""
    h = boxes[:, 2] - boxes[:, 0]
    w = boxes[:, 3] - boxes[:, 1]
    scale = torch.sqrt((h * w).clamp_min(1e-12)) / level_denominator(
        image_shape)
    lvl = 4 + torch.round(torch.log2(scale.clamp_min(1e-12)))
    return lvl.clamp(min_level, max_level).long()


def crop_and_resize(image: torch.Tensor, boxes: torch.Tensor,
                    crop_size: tuple[int, int]) -> torch.Tensor:
    """Bilinear crop-and-resize, tf.image.crop_and_resize semantics.

    image [H, W, C] (any float dtype, read as float32); boxes [N, 4]
    normalized. Returns f32 [N, ch, cw, C]; samples outside the image
    read 0 (extrapolation_value=0)."""
    H, W, C = image.shape
    ch, cw = crop_size
    y1, x1, y2, x2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    dev = boxes.device
    iy = torch.arange(ch, dtype=torch.float32, device=dev)
    ix = torch.arange(cw, dtype=torch.float32, device=dev)
    if ch > 1:
        ys = (y1[:, None] * (H - 1)
              + iy[None, :] * ((y2 - y1) * (H - 1) / (ch - 1))[:, None])
    else:
        ys = (0.5 * (y1 + y2)[:, None] * (H - 1)).expand(-1, ch)
    if cw > 1:
        xs = (x1[:, None] * (W - 1)
              + ix[None, :] * ((x2 - x1) * (W - 1) / (cw - 1))[:, None])
    else:
        xs = (0.5 * (x1 + x2)[:, None] * (W - 1)).expand(-1, cw)

    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    # clamp before the integer cast: far-outside samples are masked below
    y0i = y0.clamp(-2, H + 1).long()
    x0i = x0.clamp(-2, W + 1).long()
    flat = image.reshape(H * W, C)

    def corner(dy, dx):
        yy = (y0i + dy).clamp(0, H - 1)[:, :, None]
        xx = (x0i + dx).clamp(0, W - 1)[:, None, :]
        return flat[(yy * W + xx).reshape(-1)].reshape(
            len(boxes), ch, cw, C).float()

    wy = (ys - y0)[:, :, None, None]
    wx = (xs - x0)[:, None, :, None]
    top = corner(0, 0) * (1 - wx) + corner(0, 1) * wx
    bot = corner(1, 0) * (1 - wx) + corner(1, 1) * wx
    out = top * (1 - wy) + bot * wy
    oob = (((ys < 0) | (ys > H - 1))[:, :, None]
           | ((xs < 0) | (xs > W - 1))[:, None, :])
    return torch.where(oob[..., None], torch.zeros_like(out), out)


def pyramid_roi_align_plain(features, boxes: torch.Tensor, pool_size: int,
                            image_shape) -> torch.Tensor:
    """= ops/roi_align.pyramid_roi_align:107. features (P2..P5) each
    [Hl, Wl, C]; boxes [N, 4] normalized. Returns f32 [N, pool, pool, C]."""
    lvl = roi_level(boxes, image_shape)
    out = torch.zeros(boxes.shape[0], pool_size, pool_size,
                      features[0].shape[-1], dtype=torch.float32,
                      device=boxes.device)
    for i, feat in enumerate(features):
        crops = crop_and_resize(feat, boxes, (pool_size, pool_size))
        out = torch.where((lvl == i + 2)[:, None, None, None], crops, out)
    return out


def _roi_align_cuda(features, boxes, pool_size, image_shape):
    dtype = features[0].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"roi_align kernel takes f32 or bf16 features, got "
                        f"{dtype}")
    C = features[0].shape[-1]
    feats = []
    for f in features:
        if (f.dtype != dtype or f.dim() != 3 or f.shape[-1] != C
                or f.device != boxes.device):
            raise ValueError("pyramid levels must be [H, W, C] on the boxes' "
                             "device with one dtype and C")
        feats.append(f.contiguous())
    if boxes.dim() != 2 or boxes.shape[1] != 4:
        raise ValueError(f"boxes [N, 4] expected, got {tuple(boxes.shape)}")
    boxes = boxes.contiguous().float()
    n = boxes.shape[0]
    out = torch.empty(n, pool_size, pool_size, C, dtype=torch.float32,
                      device=boxes.device)
    hw = (ctypes.c_int * 8)(*[d for f in feats for d in f.shape[:2]])
    fn = kernels.lib("roi_align").roi_align_cuda
    kernels.launches.add("roi_align")
    err = fn(int(dtype == torch.bfloat16), *[kernels.ptr(f) for f in feats],
             ctypes.cast(hw, ctypes.c_void_p), kernels.ptr(boxes), n, pool_size, C,
             level_denominator(image_shape), kernels.ptr(out),
             kernels.stream_ptr(boxes.device))
    kernels.check(err, "roi_align kernel")
    return out


def pyramid_roi_align(features, boxes: torch.Tensor, pool_size: int,
                      image_shape) -> torch.Tensor:
    """PyramidROIAlign of one image: features (P2, P3, P4, P5) each
    [Hl, Wl, C] (f32 or bf16), boxes [N, 4] normalized. Returns f32
    [N, pool, pool, C]. CUDA tensors launch the kernel; CPU tensors take
    the plain version."""
    if len(features) != 4:
        raise ValueError("pyramid_roi_align takes the four levels P2..P5")
    if on_cuda(boxes):
        return _roi_align_cuda(features, boxes, pool_size, image_shape)
    return pyramid_roi_align_plain(features, boxes, pool_size, image_shape)
