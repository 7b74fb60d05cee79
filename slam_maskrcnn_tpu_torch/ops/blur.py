"""Gaussian blur and gray conversion of u8 images with OpenCV's
arithmetic, without cv2.

The JAX package's Augmenter blurs with ``cv2.GaussianBlur(image, (k, k),
sigma)`` (data/augment.py ``GaussianBlur``) and the balloon sample's
splash grays with ``cv2.cvtColor(image, cv2.COLOR_RGB2GRAY)``. Both are
repeated here in numpy, bit for bit against OpenCV 5
(tests/test_torch_augment.py):

* ``gaussian_blur``: OpenCV's bit-exact u8 path. The kernel is the
  Gaussian exp(-(x / 2)^2 / (2 sigma^2)) at x = 1 - n, 3 - n, ..., 0
  (half-pixel steps doubled), normalised in double, then converted to 8
  fractional bits by error diffusion (each tap rounded half to even after
  adding the previous tap's rounding error; the centre takes what makes
  the taps sum to 256). The filter is separable: the horizontal pass sums
  u8 * tap into 16 bits (saturating), the vertical pass sums those times
  the taps into 32 bits, and the result is (sum + 2^15) >> 16. Borders
  are BORDER_REFLECT_101.
* ``rgb_to_gray``: (9798 R + 19235 G + 3735 B + 2^14) >> 15.
"""

from __future__ import annotations

import math

import numpy as np

FRACTION_BITS = 8


def gaussian_taps(n: int, sigma: float) -> np.ndarray:
    """The n fixed-point taps (int64, summing to 256) of an odd kernel."""
    if n % 2 != 1 or n < 1:
        raise ValueError(f"kernel size {n} must be odd and positive")
    if n == 1:
        return np.array([1 << FRACTION_BITS], np.int64)
    if sigma <= 0:
        raise ValueError("sigma must be positive")
    scale = -0.125 / (sigma * sigma)
    half = (n - 1) // 2
    values = [math.exp(float(x * x) * scale) for x in range(1 - n, 0, 2)]
    total = 2.0 * sum(values) + 1.0
    mul = 1.0 / total
    one = float(1 << FRACTION_BITS)
    taps = [0] * n
    err, acc = 0.0, 0
    for i in range(half):
        adj = values[i] * mul * one + err
        v = int(np.rint(adj))
        err = adj - v
        taps[i] = taps[n - 1 - i] = v
        acc += v
    taps[half] = (1 << FRACTION_BITS) - 2 * acc
    return np.array(taps, np.int64)


def reflect101(index: np.ndarray, n: int) -> np.ndarray:
    """BORDER_REFLECT_101 of indices into an axis of length n."""
    if n == 1:
        return np.zeros_like(index)
    period = 2 * n - 2
    i = np.mod(index, period)
    return np.where(i >= n, period - i, i)


def gaussian_blur(image: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """= cv2.GaussianBlur(image, (ksize, ksize), sigma) for a u8 [H, W] or
    [H, W, C] image."""
    if image.dtype != np.uint8:
        raise TypeError(f"gaussian_blur takes uint8, not {image.dtype}")
    taps = gaussian_taps(int(ksize), float(sigma))
    r = len(taps) // 2
    H, W = image.shape[:2]
    x = image.astype(np.int64)
    xp = x[:, reflect101(np.arange(-r, W + r), W)]
    rows = np.zeros_like(x)
    for j, t in enumerate(taps):
        rows += t * xp[:, j:j + W]
    rows = np.minimum(rows, 0xFFFF)
    yp = rows[reflect101(np.arange(-r, H + r), H)]
    out = np.zeros_like(x)
    for j, t in enumerate(taps):
        out += t * yp[j:j + H]
    return np.clip((out + (1 << 15)) >> 16, 0, 255).astype(np.uint8)


def rgb_to_gray(image: np.ndarray) -> np.ndarray:
    """= cv2.cvtColor(image, cv2.COLOR_RGB2GRAY) for u8 [H, W, 3]."""
    x = image.astype(np.int64)
    g = (x[..., 0] * 9798 + x[..., 1] * 19235 + x[..., 2] * 3735
         + (1 << 14)) >> 15
    return g.astype(np.uint8)
