"""Affine warps with OpenCV's ``cv2.getRotationMatrix2D`` and
``cv2.warpAffine`` arithmetic, without cv2.

The JAX package's Augmenter (data/augment.py ``Affine``) builds its matrix
with ``cv2.getRotationMatrix2D`` and warps the image with ``INTER_LINEAR``
and the masks with ``INTER_NEAREST``, border constant 0. These are those
calls in numpy, pixel for pixel against OpenCV 5 (tests/test_torch_augment.py):

* ``rotation_matrix``: the angle times the double constant pi / 180, the
  centre rounded to float32 (cv::Point2f), then cos and sin times the
  scale in double.
* ``warp_affine``: the 2x3 matrix is inverted in double (the determinant's
  reciprocal, then b = -A t). What follows depends on the channel count,
  because OpenCV 5 has two implementations:

  - 1, 3 or 4 channels (the images, and masks of 1, 3 or 4 instances):
    float32 arithmetic, vectorised by 16 pixels along a row. The inverse
    matrix is rounded to float32; a vector lane's source position is
    ``fma(x, m0, m1 * y + m2)`` (x and y the destination pixel), the
    row's tail, past the last full vector, ``fma(x, m0, m1 * y) + m2``.
    Nearest reads the pixel at the position rounded half to even;
    linear reads the four neighbours (0 outside the image), blends them
    as ``v0 = fma(a, p01 - p00, p00)``, ``v1 = fma(a, p11 - p10, p10)``,
    ``fma(b, v1 - v0, v0)`` with a and b the fractions in float32, and a
    u8 result is rounded half to even and saturated.
  - any other channel count (masks of 2 or 5+ instances; nearest only
    here): the fixed-point remap of OpenCV 4, positions in 10 fractional
    bits, ``round(m1 * y + m2) * 1024`` per row plus ``round(m0 * x *
    1024)`` per column, each rounded half to even, plus 512, shifted
    down by 10.

* ``warp_perspective`` (sfm/two_view.py's rectification warp): u8 gray,
  linear, border 0, in torch on the image's device. The 3x3 matrix is
  inverted in double on the host; in float32, each of the three rows
  gives ``fma(x, m0, m1 * y + m2)`` in a 16-pixel vector and ``fma(x, m0,
  m1 * y) + m2`` in the row's tail, the source position is the first two
  divided by the third (a true division, not a reciprocal), and the
  blend and rounding are warpAffine's.

Every product-and-sum that OpenCV fuses into one rounding is computed
exactly here (``fma32``, ``fma32_t``), so the result does not depend on
the host or the device.
"""

from __future__ import annotations

import numpy as np
import torch

INTER_NEAREST, INTER_LINEAR = 0, 1
# pixels a vector of OpenCV 5's float warp covers (AVX-512 float32 lanes)
VECTOR = 16
AB_BITS = 10                       # the fixed-point remap's position bits


def rotation_matrix(center, angle: float, scale: float) -> np.ndarray:
    """= cv2.getRotationMatrix2D(center, angle, scale): [2, 3] float64."""
    cx, cy = (float(np.float32(c)) for c in center)
    a = float(angle) * (np.pi / 180)
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def invert_affine(M) -> np.ndarray:
    """cv::warpAffine's inverse of a 2x3 matrix (a singular one gives 0):
    6 float64 coefficients."""
    m = np.asarray(M, np.float64).reshape(6).copy()
    D = m[0] * m[4] - m[1] * m[3]
    D = 1.0 / D if D != 0 else 0.0
    a11, a22 = m[4] * D, m[0] * D
    m[0], m[1], m[3], m[4] = a11, m[1] * -D, m[3] * -D, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


def fma32(a, b, c) -> np.ndarray:
    """a * b + c rounded once to float32 (a, b, c float32). The product is
    exact in float64; the sum is rounded to odd in float64 (an inexact sum
    moved to its odd neighbour toward the exact value), which then rounds
    to float32 correctly."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)              # s + err == p + c exactly
    bits = s.view(np.int64)
    even = (bits & 1) == 0
    fix = (err != 0) & even
    if fix.any():
        s = np.where(fix, np.nextafter(s, np.where(err > 0, np.inf,
                                                   -np.inf)), s)
    return s.astype(np.float32)


def _float_positions(m, h: int, w: int):
    """OpenCV 5's float32 source positions (sx, sy), [h, w] each."""
    m = m.astype(np.float32)
    x = np.broadcast_to(np.arange(w, dtype=np.float32)[None, :], (h, w))
    y = np.broadcast_to(np.arange(h, dtype=np.float32)[:, None], (h, w))
    vec = (w // VECTOR) * VECTOR
    out = []
    for k in (0, 3):
        row = m[k + 1] * y
        pos = fma32(x, m[k], row + m[k + 2])
        tail = fma32(x[:, vec:], m[k], row[:, vec:]) + m[k + 2]
        pos[:, vec:] = tail
        out.append(pos)
    return out


def _fixed_positions(m, h: int, w: int):
    """OpenCV 4's fixed-point nearest positions (X, Y) int64, [h, w]."""
    scale = 1 << AB_BITS
    x, y = np.arange(w), np.arange(h)
    adelta = np.rint(m[0] * x * scale).astype(np.int64)
    bdelta = np.rint(m[3] * x * scale).astype(np.int64)
    X0 = np.rint((m[1] * y + m[2]) * scale).astype(np.int64) + scale // 2
    Y0 = np.rint((m[4] * y + m[5]) * scale).astype(np.int64) + scale // 2
    return ((X0[:, None] + adelta[None, :]) >> AB_BITS,
            (Y0[:, None] + bdelta[None, :]) >> AB_BITS)


def _gather(src, X, Y, dtype):
    """src[Y, X] where inside the image, else 0."""
    H, W = src.shape[:2]
    ok = (X >= 0) & (X < W) & (Y >= 0) & (Y < H)
    out = np.zeros(X.shape + src.shape[2:], dtype)
    out[ok] = src[Y[ok], X[ok]]
    return out


def warp_affine(src: np.ndarray, M, dsize, flags: int = INTER_LINEAR
                ) -> np.ndarray:
    """= cv2.warpAffine(src, M, dsize, flags=flags) with a constant-0
    border: src [H, W] or [H, W, C], uint8 or float32; dsize = (w, h);
    flags INTER_LINEAR or INTER_NEAREST. The output has src's shape
    layout (a 2-D src gives a 2-D output)."""
    if src.dtype not in (np.uint8, np.float32):
        raise TypeError(f"warp_affine takes uint8 or float32, not "
                        f"{src.dtype}")
    if flags not in (INTER_LINEAR, INTER_NEAREST):
        raise ValueError(f"flags {flags}: INTER_LINEAR or INTER_NEAREST")
    w, h = int(dsize[0]), int(dsize[1])
    m = invert_affine(M)
    channels = 1 if src.ndim == 2 else src.shape[2]
    if channels not in (1, 3, 4):
        if flags != INTER_NEAREST:
            raise ValueError(f"INTER_LINEAR on {channels} channels: the "
                             f"fixed-point linear remap is not repeated")
        X, Y = _fixed_positions(m, h, w)
        return _gather(src, X, Y, src.dtype)
    sx, sy = _float_positions(m, h, w)
    if flags == INTER_NEAREST:
        X, Y = (np.rint(p).astype(np.int64) for p in (sx, sy))
        return _gather(src, X, Y, src.dtype)
    fx, fy = np.floor(sx), np.floor(sy)
    a, b = sx - fx, sy - fy
    X, Y = fx.astype(np.int64), fy.astype(np.int64)
    if src.ndim == 3:
        a, b = a[..., None], b[..., None]
    p00 = _gather(src, X, Y, np.float32)
    p01 = _gather(src, X + 1, Y, np.float32)
    p10 = _gather(src, X, Y + 1, np.float32)
    p11 = _gather(src, X + 1, Y + 1, np.float32)
    v0 = fma32(a, p01 - p00, p00)
    v1 = fma32(a, p11 - p10, p10)
    v = fma32(b, v1 - v0, v0)
    if src.dtype == np.uint8:
        return np.clip(np.rint(v), 0, 255).astype(np.uint8)
    return v


# ------------------------------------------------------ the torch warps

def fma32_t(a: torch.Tensor, b, c) -> torch.Tensor:
    """``fma32`` in torch on the operands' device: a * b + c of float32
    tensors rounded once to float32 (the product exact in float64, the sum
    rounded to odd there, then to float32)."""
    p = a.double() * torch.as_tensor(b, device=a.device).double()
    c = torch.as_tensor(c, device=a.device).double()
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    fix = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    away = torch.where(err > 0, torch.full_like(s, float("inf")),
                       torch.full_like(s, float("-inf")))
    return torch.where(fix, torch.nextafter(s, away), s).float()


def _perspective_positions(m: np.ndarray, h: int, w: int, dev):
    """OpenCV 5's float32 source positions (sx, sy) [h, w] of the inverse
    matrix ``m`` (9 float64 coefficients)."""
    m = torch.from_numpy(m.astype(np.float32)).to(dev)
    x = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(
        h, w)
    y = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(
        h, w)
    vec = (w // VECTOR) * VECTOR
    rows = []
    for k in (0, 3, 6):
        row = m[k + 1] * y
        pos = fma32_t(x, m[k], row + m[k + 2])
        pos[:, vec:] = fma32_t(x[:, vec:], m[k], row[:, vec:]) + m[k + 2]
        rows.append(pos)
    X, Y, Wt = rows
    return X / Wt, Y / Wt


def warp_perspective(src: torch.Tensor, M, dsize) -> torch.Tensor:
    """= cv2.warpPerspective(src, M, dsize) (INTER_LINEAR, border
    constant 0) on a u8 gray image [H, W] on its device; dsize = (w, h).
    Returns u8 [h, w] there. The 3x3 inverse is computed on the host in
    float64."""
    if src.dtype != torch.uint8 or src.dim() != 2:
        raise TypeError("warp_perspective takes a u8 gray image [H, W]")
    w, h = int(dsize[0]), int(dsize[1])
    H, W = src.shape
    dev = src.device
    m = np.linalg.inv(np.asarray(M, np.float64).reshape(3, 3)).reshape(9)
    sx, sy = _perspective_positions(m, h, w, dev)
    fx, fy = torch.floor(sx), torch.floor(sy)
    a, b = sx - fx, sy - fy
    # far-off positions read 0 anyway: bound them before the integer cast
    X = fx.clamp(-2, W + 1).to(torch.int64)
    Y = fy.clamp(-2, H + 1).to(torch.int64)
    flat = src.reshape(-1).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def at(xx, yy):
        ok = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
        return torch.where(ok, flat[(yy.clamp(0, H - 1) * W
                                     + xx.clamp(0, W - 1))], zero)

    p00, p01 = at(X, Y), at(X + 1, Y)
    p10, p11 = at(X, Y + 1), at(X + 1, Y + 1)
    v0 = fma32_t(a, p01 - p00, p00)
    v1 = fma32_t(a, p11 - p10, p10)
    v = fma32_t(b, v1 - v0, v0)
    return torch.round(v).clamp(0, 255).to(torch.uint8)
