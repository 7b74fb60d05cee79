"""Bilinear resize with OpenCV's ``cv2.resize(..., INTER_LINEAR)`` arithmetic.

The JAX package molds images and pastes masks with cv2 on the host
(models/mask_rcnn.py ``resize_image``, ``unmold_mask``); the port has no
cv2 where it runs, so this module repeats cv2's arithmetic in torch, on
whatever device the tensor lives.

The geometry is cv2's: half-pixel centres, ``fx = (dx + 0.5) * scale -
0.5`` with ``scale = 1 / (dst / src)`` in double (rounded to float32
before the fraction is taken, on the u8 path), ``sx = floor(fx)``;
along x an index off the border is clamped and its fraction zeroed, along
y the fraction is kept and only the rows read are clamped; no
antialiasing when shrinking. A resize by exactly 1/2 in both axes is
cv2's area average instead, as cv2 switches to it.

* uint8 (molding): each tap weight is rounded to 11 bits (x 2048, half to
  even), the horizontal pass is exact integer arithmetic, and the vertical
  pass rounds as cv2's vector loop does, ``(((S0 >> 4) * b0 >> 16) + ((S1
  >> 4) * b1 >> 16) + 2) >> 2`` (OpenCV 5 runs every element of a row
  through it). Bit-equal to cv2 on every size the tests try.
* float32 (the mask paste): weights ``1 - fx`` and ``fx`` from the double
  fraction, rounded to float32, each product and sum rounded in float32.
  cv2 differs from this by 1-2 float32 ulp on some pixels (its float
  path's order of operations is not reproduced); the paste thresholds the
  result at 127.5, which such an ulp moves only on a pixel sitting on it.

The coefficient tables are computed on the host with numpy (a few
hundred numbers); the pixel arithmetic runs in torch.
"""

from __future__ import annotations

import numpy as np
import torch

COEF_BITS = 11
COEF_SCALE = 1 << COEF_BITS


def _taps(src: int, dst: int, clamp: bool, single: bool):
    """cv2's per-output (index, fraction) along one axis: source index
    [dst] (int64) and fraction [dst]. ``single``: the position rounded to
    float32 and the fraction taken in float32, as cv2's fixed-point path
    does (else both in double, closer to its float path). With ``clamp``
    (the horizontal axis) an index off either border is clamped and its
    fraction zeroed; without (the vertical axis) cv2 keeps the fraction
    and clamps only the rows it reads."""
    scale = 1.0 / (dst / src)
    d = np.arange(dst, dtype=np.float64)
    f = (d + 0.5) * scale - 0.5
    if single:
        f = f.astype(np.float32)
    sx = np.floor(f).astype(np.int64)
    fx = f - sx.astype(f.dtype)
    if clamp:
        lo = sx < 0
        hi = sx >= src - 1
        fx[lo | hi] = 0.0
        sx[lo] = 0
        sx[hi] = src - 1
    return sx, fx


def _fixed(w: np.ndarray) -> np.ndarray:
    """saturate_cast<short>(w * 2048) of the float32 weight: round half to
    even."""
    return np.rint(w.astype(np.float32) * np.float32(COEF_SCALE)).astype(
        np.int32)


def _area_half_u8(img: torch.Tensor) -> torch.Tensor:
    """cv2's fast area resize by 1/2: (a + b + c + d + 2) >> 2."""
    x = img.to(torch.int32)
    s = x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]
    return ((s + 2) >> 2).to(torch.uint8)


def resize_linear(img: torch.Tensor, size) -> torch.Tensor:
    """= cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR) for img
    [H, W] or [H, W, C], uint8 or float32; size = (h, w)."""
    dh, dw = int(size[0]), int(size[1])
    sh, sw = int(img.shape[0]), int(img.shape[1])
    if (dh, dw) == (sh, sw):
        return img.clone()
    if img.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"resize_linear takes uint8 or float32, not "
                        f"{img.dtype}")
    if dh < 1 or dw < 1:
        raise ValueError(f"empty output size {size}")
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    if sh == 2 * dh and sw == 2 * dw:
        out = (_area_half_u8(img) if img.dtype == torch.uint8
               else 0.25 * (img[0::2, 0::2] + img[0::2, 1::2]
                            + img[1::2, 0::2] + img[1::2, 1::2]))
        return out[..., 0] if squeeze else out
    dev = img.device
    single = img.dtype == torch.uint8
    sx, fx = _taps(sw, dw, clamp=True, single=single)
    sy, fy = _taps(sh, dh, clamp=False, single=single)
    sx1 = np.minimum(sx + 1, sw - 1)
    sy0, sy1 = np.clip(sy, 0, sh - 1), np.clip(sy + 1, 0, sh - 1)
    ix = lambda a: torch.from_numpy(a).to(dev)
    C = img.shape[2]
    if img.dtype == torch.uint8:
        ax0, ax1 = _fixed(1.0 - fx), _fixed(fx)
        by0, by1 = _fixed(1.0 - fy), _fixed(fy)
        x = img.to(torch.int32)
        rows = x[:, ix(sx)] * ix(ax0)[None, :, None] \
            + x[:, ix(sx1)] * ix(ax1)[None, :, None]        # [sh, dw, C]
        s0, s1 = rows[ix(sy0)], rows[ix(sy1)]               # [dh, dw, C]
        b0, b1 = ix(by0)[:, None, None], ix(by1)[:, None, None]
        out = ((((s0 >> 4) * b0) >> 16) + (((s1 >> 4) * b1) >> 16) + 2) >> 2
        out = out.clamp(0, 255).to(torch.uint8)
    else:
        f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
        ax0, ax1 = f32(1.0 - fx), f32(fx)
        by0, by1 = f32(1.0 - fy), f32(fy)
        rows = img[:, ix(sx)] * ax0[None, :, None]
        rows = rows + img[:, ix(sx1)] * ax1[None, :, None]
        out = rows[ix(sy0)] * by0[:, None, None]
        out = out + rows[ix(sy1)] * by1[:, None, None]
    return out[..., 0] if squeeze else out
