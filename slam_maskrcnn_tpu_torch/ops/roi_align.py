"""ROIAlign: bilinear crop-and-resize + FPN pyramid level routing.

Port of slam_maskrcnn_tpu/ops/roi_align.py (the reference's
``PyramidROIAlign``, model.py:350-455). Features are NHWC, as in the JAX
package. Two entry points, as the JAX package has two:

* ``pyramid_roi_align``, the inference graph's (the JAX
  ``pyramid_roi_align_auto``, Pallas on the TPU): on CUDA tensors it
  launches the kernel of csrc/roi_align.cu (one launch for a batch of
  images) or raises, on CPU tensors it runs the plain version,
  ``pyramid_roi_align_plain``;
* ``pyramid_roi_align_train``, the training graph's (the jnp
  ``pyramid_roi_align``, which the JAX training graph keeps because the
  kernel has no gradient): torch code on every device, differentiable in
  the features, boxes under stop-gradient. Only ``train_forward`` of
  models/mask_rcnn.py calls it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from slam_maskrcnn_tpu_torch import kernels
from slam_maskrcnn_tpu_torch.device import on_cuda

# csrc/roi_align.cu keeps a roi's sample rows and columns in shared memory
MAX_POOL = 64


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


def pyramid_roi_align_train(features, boxes: torch.Tensor, pool_size: int,
                            image_shape) -> torch.Tensor:
    """The training graph's PyramidROIAlign (= the jnp pyramid_roi_align,
    roi_align.py:106-122): features (P2..P5) each [B, Hl, Wl, C], boxes
    [B, N, 4] normalized -> f32 [B, N, pool, pool, C]. The boxes are
    detached (model.py:427 stops their gradient); the gradient flows to
    the features. The same torch arithmetic on every device."""
    return pyramid_roi_align_plain(features, boxes.detach(), pool_size,
                                   image_shape)


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
             level_scale(image_shape), kernels.ptr(out),
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
