"""ROIAlign: bilinear crop-and-resize + FPN pyramid level routing.

Port of slam_maskrcnn_tpu/ops/roi_align.py (the reference's
``PyramidROIAlign``, model.py:350-455). ``pyramid_roi_align`` launches the
kernel of csrc/roi_align.cu on CUDA tensors (one launch for a batch of
images) and runs the plain version, ``pyramid_roi_align_plain``, on CPU
tensors. Features are NHWC, as in the JAX package.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from slam_maskrcnn_tpu_torch import kernels
from slam_maskrcnn_tpu_torch.device import on_cuda

# csrc/roi_align.cu keeps a roi's sample rows and columns in shared memory
MAX_POOL = 64


def level_denominator(image_shape) -> float:
    """224 / sqrt(image area) in float32, the roi_level divisor (computed
    once on the host, shared by the kernel and the plain version)."""
    area = np.float32(float(image_shape[0] * image_shape[1]))
    return float(np.float32(224.0) / np.sqrt(area))


def _div(a: torch.Tensor, d: float) -> torch.Tensor:
    """a / d rounded as IEEE division on every device: on a CUDA tensor,
    PyTorch turns a division by a Python number into a multiplication by
    its reciprocal (one rounding more), which the kernel does not do."""
    return a / torch.full((), d, dtype=a.dtype, device=a.device)


def roi_level(boxes: torch.Tensor, image_shape, min_level=2,
              max_level=5) -> torch.Tensor:
    """FPN level per roi (normalized boxes): 4 + round(log2(sqrt(h*w) /
    (224 / sqrt(image area)))), round half to even, clipped to [2, 5]
    (model.py:375-384). Returns i64 [N]."""
    h = boxes[:, 2] - boxes[:, 0]
    w = boxes[:, 3] - boxes[:, 1]
    scale = _div(torch.sqrt((h * w).clamp_min(1e-12)),
                 level_denominator(image_shape))
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
              + iy[None, :] * _div((y2 - y1) * (H - 1), ch - 1)[:, None])
    else:
        ys = (0.5 * (y1 + y2)[:, None] * (H - 1)).expand(-1, ch)
    if cw > 1:
        xs = (x1[:, None] * (W - 1)
              + ix[None, :] * _div((x2 - x1) * (W - 1), cw - 1)[:, None])
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


def _plain_one(features, boxes, pool_size, image_shape):
    lvl = roi_level(boxes, image_shape)
    out = torch.zeros(boxes.shape[0], pool_size, pool_size,
                      features[0].shape[-1], dtype=torch.float32,
                      device=boxes.device)
    for i, feat in enumerate(features):
        crops = crop_and_resize(feat, boxes, (pool_size, pool_size))
        out = torch.where((lvl == i + 2)[:, None, None, None], crops, out)
    return out


def pyramid_roi_align_plain(features, boxes: torch.Tensor, pool_size: int,
                            image_shape) -> torch.Tensor:
    """= ops/roi_align.pyramid_roi_align:107. One image: features (P2..P5)
    each [Hl, Wl, C], boxes [N, 4] normalized -> f32 [N, pool, pool, C]. A
    batch: features each [B, Hl, Wl, C], boxes [B, N, 4] -> f32 [B, N,
    pool, pool, C], image by image."""
    if boxes.dim() == 2:
        return _plain_one(features, boxes, pool_size, image_shape)
    return torch.stack([_plain_one(tuple(f[b] for f in features), boxes[b],
                                   pool_size, image_shape)
                        for b in range(boxes.shape[0])])


def _roi_align_cuda(features, boxes, pool_size, image_shape):
    """features (P2..P5) each [B, Hl, Wl, C], boxes [B, N, 4] -> f32
    [B, N, pool, pool, C]: one launch for the batch."""
    f0 = features[0]
    dtype = f0.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"roi_align kernel takes f32 or bf16 features, got "
                        f"{dtype}")
    if boxes.dim() != 3 or boxes.shape[2] != 4:
        raise ValueError(f"boxes [B, N, 4] expected, got {tuple(boxes.shape)}")
    B, n = boxes.shape[:2]
    C = f0.shape[-1]
    # 16-byte loads: 8 bf16 or 4 f32 channels a thread, one thread row of
    # at most 256 channel groups
    if C % 8 or C // (8 if dtype == torch.bfloat16 else 4) > 256:
        raise ValueError(f"roi_align kernel takes C % 8 == 0 and at most "
                         f"2048 bf16 / 1024 f32 channels, got C = {C}")
    if not 1 <= pool_size <= MAX_POOL:
        raise ValueError(f"pool size {pool_size} outside 1..{MAX_POOL}")
    feats, dims = [], []
    for f in features:
        if (f.dtype != dtype or f.dim() != 4 or f.shape[0] != B
                or f.shape[3] != C or f.device != boxes.device):
            raise ValueError("pyramid levels must be [B, H, W, C] on the "
                             "boxes' device with one dtype, B and C")
        if f.shape[1] * f.shape[2] * C >= 2 ** 31:
            raise ValueError(f"a level of {tuple(f.shape[1:])} per image is "
                             f"too large for the kernel's 32-bit offsets")
        f = f.contiguous()
        if f.data_ptr() % 16:            # the kernel reads 16 B at a time
            f = f.clone()
        feats.append(f)                  # alive until the launch
        dims += f.shape[1:3]
    boxes = boxes.contiguous().float()
    out = torch.empty(B, n, pool_size, pool_size, C, dtype=torch.float32,
                      device=boxes.device)
    fn = kernels.lib("roi_align").roi_align_cuda
    kernels.launches.add("roi_align")
    err = fn(int(dtype == torch.bfloat16), *[kernels.ptr(f) for f in feats],
             ctypes.cast((ctypes.c_int * 8)(*dims), ctypes.c_void_p),
             kernels.ptr(boxes), B, n, pool_size, C,
             level_denominator(image_shape), kernels.ptr(out),
             kernels.stream_ptr(boxes.device))
    kernels.check(err, "roi_align kernel")
    return out


def pyramid_roi_align(features, boxes: torch.Tensor, pool_size: int,
                      image_shape) -> torch.Tensor:
    """PyramidROIAlign of one image (features (P2, P3, P4, P5) each
    [Hl, Wl, C], boxes [N, 4] normalized -> f32 [N, pool, pool, C]) or of a
    batch (features each [B, Hl, Wl, C], boxes [B, N, 4] -> f32 [B, N,
    pool, pool, C]). Features f32 or bf16. CUDA tensors launch the kernel,
    once for the whole batch; CPU tensors take the plain version."""
    if len(features) != 4:
        raise ValueError("pyramid_roi_align takes the four levels P2..P5")
    if not on_cuda(boxes):
        return pyramid_roi_align_plain(features, boxes, pool_size,
                                       image_shape)
    if boxes.dim() == 2:
        return _roi_align_cuda(tuple(f[None] for f in features), boxes[None],
                               pool_size, image_shape)[0]
    return _roi_align_cuda(features, boxes, pool_size, image_shape)
