"""PNG reader and writer over zlib, numpy only.

Takes the place of ``cv2.imread`` / ``cv2.imwrite`` in the JAX package
(data/tum.py, models/mask_ops.py, viz/viewer.py): the port runs where
neither cv2 nor PIL is installed. What it reads is what a TUM RGB-D
sequence and the pipeline's own outputs hold:

* color type 0 (gray) at 8 bits -> u8 [H, W], at 16 bits -> u16 [H, W]
  (PNG stores big-endian; the result is native, as
  ``cv2.imread(path, cv2.IMREAD_ANYDEPTH)``);
* color type 2 (RGB) -> [H, W, 3] in BGR order, as ``cv2.imread``;
* color type 6 (RGBA) -> [H, W, 3] BGR, the alpha dropped as
  ``cv2.IMREAD_COLOR`` does;

non-interlaced, with any of the five row filters (none, sub, up, average,
paeth). Interlaced files, palettes, gray + alpha and bit depths under 8
raise ``PNGError`` naming the construct. ``write_png`` writes u8 gray, u8
BGR (as RGB) and u16 gray.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


class PNGError(ValueError):
    """A PNG this codec does not read, or a damaged one."""


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise PNGError("not a PNG file (bad signature)")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise PNGError(f"CRC mismatch in chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise PNGError("truncated PNG (no IEND chunk)")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Undo the row filters. raw [H, W, bpp] filtered bytes (int32), ftype
    [H] filter type of each row. Rows with only none / sub / up filters
    go row by row (sub as a running sum); any average or paeth row sends
    the image through an anti-diagonal wavefront, where every pixel of a
    diagonal depends only on the two before it."""
    H, W, bpp = raw.shape
    if ftype.max(initial=0) > 4:
        raise PNGError(f"unknown PNG filter type {int(ftype.max())}")
    out = np.zeros((H + 1, W + 1, bpp), np.int32)     # row 0, column 0: 0
    if not np.isin(ftype, (3, 4)).any():
        for r in range(H):
            f, row = ftype[r], raw[r]
            if f == 1:
                row = np.cumsum(row, axis=0)
            elif f == 2:
                row = row + out[r, 1:]
            out[r + 1, 1:] = row & 0xFF
        return out[1:, 1:].astype(np.uint8)
    for d in range(H + W - 1):
        r = np.arange(max(0, d - W + 1), min(H - 1, d) + 1)
        x = d - r
        f = raw[r, x]
        a, b, c = out[r + 1, x], out[r, x + 1], out[r, x]
        t = ftype[r][:, None]
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        out[r + 1, x + 1] = (f + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> array (see the module docstring for the layouts)."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise PNGError("no IHDR chunk")
    W, H, depth, ctype, comp, filt, interlace = header
    if interlace:
        raise PNGError("interlaced (Adam7) PNGs are not supported")
    if ctype == 3:
        raise PNGError("palette (indexed-color) PNGs are not supported")
    if ctype not in (0, 2, 6):
        raise PNGError(f"color type {ctype} (gray + alpha) is not supported")
    if depth not in (8, 16):
        raise PNGError(f"bit depth {depth} is not supported (8 or 16)")
    if comp or filt:
        raise PNGError("unknown compression or filter method")
    ch = {0: 1, 2: 3, 6: 4}[ctype]
    bpp = ch * depth // 8
    buf = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if buf.size != H * (1 + W * bpp):
        raise PNGError(f"image data holds {buf.size} bytes, expected "
                       f"{H * (1 + W * bpp)}")
    rows = buf.reshape(H, 1 + W * bpp)
    px = _unfilter(rows[:, 1:].reshape(H, W, bpp).astype(np.int32),
                   rows[:, 0].astype(np.int64))
    if depth == 16:
        img = px.reshape(H, W * bpp).view(">u2").astype(np.uint16)
    else:
        img = px.reshape(H, W * bpp)
    img = img.reshape(H, W, ch)
    if ch == 1:
        return np.ascontiguousarray(img[..., 0])
    return np.ascontiguousarray(img[..., 2::-1])            # RGB(A) -> BGR


def read_png(path) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def _sub_filter(px: np.ndarray) -> np.ndarray:
    """Every row of px [H, W, bpp] (u8) with the sub filter: each byte less
    the byte one pixel to its left."""
    out = px.copy()
    out[:, 1:] -= px[:, :-1]                      # u8 arithmetic wraps
    return out


def encode_png(img: np.ndarray) -> bytes:
    """u8 [H, W] gray, u8 [H, W, 3] BGR or u16 [H, W] gray -> PNG bytes,
    every row with the sub filter (as cv2 writes them)."""
    img = np.asarray(img)
    if img.dtype == np.uint8 and img.ndim == 2:
        ctype, depth, px = 0, 8, img[..., None]
    elif img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        ctype, depth, px = 2, 8, img[..., ::-1]             # BGR -> RGB
    elif img.dtype == np.uint16 and img.ndim == 2:
        ctype, depth = 0, 16
        px = img.astype(">u2").view(np.uint8).reshape(img.shape + (2,))
    else:
        raise PNGError(f"cannot write a {img.dtype} image of shape "
                       f"{img.shape} (u8 gray, u8 BGR or u16 gray)")
    H, W = img.shape[:2]
    px = np.ascontiguousarray(px).reshape(H, W, -1)
    rows = np.empty((H, 1 + px.shape[1] * px.shape[2]), np.uint8)
    rows[:, 0] = 1                                          # sub
    rows[:, 1:] = _sub_filter(px).reshape(H, -1)
    ihdr = struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, 0)
    return (SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
            + chunk(b"IEND", b""))


def chunk(kind: bytes, body: bytes) -> bytes:
    """One PNG chunk: length, type, body, CRC."""
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write_png(path, img: np.ndarray) -> str:
    with open(path, "wb") as f:
        f.write(encode_png(img))
    return str(path)
