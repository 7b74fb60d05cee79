"""PNG reader and writer over zlib, numpy only.

Takes the place of ``cv2.imread`` / ``cv2.imwrite`` in the JAX package
(data/tum.py, models/mask_ops.py, samples/nucleus.py, viz/viewer.py):
the port runs where neither cv2 nor PIL is installed. It reads every
PNG that libpng reads:

* colour types 0 (gray), 2 (RGB), 3 (palette), 4 (gray + alpha) and 6
  (RGBA), at bit depths 1, 2, 4, 8 and 16 as the type allows, with a
  ``PLTE`` and a ``tRNS`` chunk;
* non-interlaced or Adam7-interlaced, with any of the five row filters
  (none, sub, up, average, paeth);
* the file's gamma (``sRGB``, else ``gAMA``), which libpng's colour to
  gray conversion uses.

``decode`` returns a ``PNGImage``: the samples as libpng expands them
(palette to RGB or RGBA, gray under 8 bits scaled to 0..255, 16-bit
samples native) with the file's alpha and an RGB file's ``tRNS`` colour.
``convert`` applies what OpenCV 5's PNG decoder asks of libpng for a
given channel count and depth: alpha stripped or added from ``tRNS``,
RGB to BGR, gray replicated, colour to gray by ``png_do_rgb_to_gray``
(``(9797 R + 19234 G + 3737 B) >> 15`` at 8 bits, rounded at 16, through
the gamma tables when the file has a gamma), 16-bit samples cut to their
high byte. data/image_io.py maps cv2's ``IMREAD_*`` flags onto it.
``decode_png`` / ``read_png`` give the file's own depth with the alpha
dropped: gray (with or without alpha) as [H, W], colour as [H, W, 3]
BGR. A damaged file (bad signature, CRC, IHDR, missing ``PLTE``, short
image data, unknown filter) raises ``PNGError``.

``write_png`` writes u8 gray, u8 BGR (as RGB) and u16 gray.
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import NamedTuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# legal bit depths per colour type (PNG specification, table 11.1)
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7 passes: (x0, y0, dx, dy)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# png_set_rgb_to_gray(png_ptr, 1, 0.299, 0.587): coefficients / 32768
RGB_TO_GRAY = (9797, 19234, 3737)
GAMMA_SRGB = 45455          # PNG_GAMMA_sRGB_INVERSE, in units of 1e-5


class PNGError(ValueError):
    """A damaged PNG, or an image the writer does not write."""


class PNGImage(NamedTuple):
    """pixels: [H, W, C] u8 or u16 in the file's order (C 1 gray, 2 gray +
    alpha, 3 RGB, 4 RGBA; a palette expanded to RGB, or RGBA when it has a
    tRNS chunk); trns: an RGB file's transparent colour or None (a gray
    file's never shows: OpenCV reads gray without alpha); gamma: the
    file's gamma in 1e-5 or None; ctype: the IHDR colour type; sbit: the
    largest significant bits of an sBIT chunk's colour (0 without one);
    exif: an eXIf chunk's TIFF bytes."""
    pixels: np.ndarray
    trns: tuple | None
    gamma: int | None
    ctype: int
    sbit: int = 0
    exif: bytes = b""

    @property
    def cv_channels(self) -> int:
        """The channels OpenCV's decoder gives at IMREAD_UNCHANGED: 4 with
        any alpha (gray + alpha made BGRA) or an RGB file's tRNS, else 1
        or 3."""
        if self.pixels.shape[2] in (2, 4) or self.trns is not None:
            return 4
        return 3 if self.ctype in (2, 3) else 1


def chunks(data: bytes):
    """(type, body) of each chunk after the signature, CRCs checked."""
    if data[:8] != SIGNATURE:
        raise PNGError("not a PNG file (bad signature)")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if pos + 12 + n > len(data):
            raise PNGError(f"truncated PNG (chunk {kind!r})")
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


def _samples(buf: np.ndarray, h: int, w: int, depth: int, ch: int):
    """One (sub-)image's filtered rows -> int samples [h, w, ch] and the
    bytes it used."""
    row_bytes = -(-w * ch * depth // 8)
    n = h * (1 + row_bytes)
    if buf.size < n:
        raise PNGError(f"image data holds {buf.size} bytes, expected {n}")
    rows = buf[:n].reshape(h, 1 + row_bytes)
    bpp = max(1, ch * depth // 8)
    px = _unfilter(rows[:, 1:].reshape(h, row_bytes // bpp, bpp).astype(
        np.int32), rows[:, 0].astype(np.int64)).reshape(h, row_bytes)
    if depth == 16:
        s = px.view(">u2").astype(np.uint16)
    elif depth == 8:
        s = px
    else:                                       # MSB first, rows padded
        s = np.unpackbits(px, axis=1).reshape(h, row_bytes * 8 // depth,
                                              depth)
        s = (s * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(
            -1, dtype=np.uint8)
    return s[:, :w * ch].reshape(h, w, ch), n


def decode(data: bytes) -> PNGImage:
    """PNG bytes -> PNGImage (see the module docstring)."""
    header, idat, plte, trns, gama, srgb = None, [], None, None, None, False
    sbit, exif = b"", b""
    for kind, body in chunks(data):
        if kind == b"IHDR":
            if len(body) != 13:
                raise PNGError("bad IHDR chunk length")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"tRNS":
            trns = body
        elif kind == b"gAMA" and len(body) == 4:
            gama = struct.unpack(">I", body)[0] or None
        elif kind == b"sRGB":
            srgb = True
        elif kind == b"sBIT":
            sbit = body
        elif kind == b"eXIf":
            exif = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise PNGError("no IHDR chunk")
    W, H, depth, ctype, comp, filt, interlace = header
    if ctype not in DEPTHS or depth not in DEPTHS[ctype]:
        raise PNGError(f"bad IHDR: colour type {ctype} at bit depth {depth}")
    if not (0 < W < 2 ** 31 and 0 < H < 2 ** 31) or comp or filt or \
            interlace > 1:
        raise PNGError("bad IHDR: size, compression, filter or interlace "
                       "method")
    if ctype == 3 and (plte is None or len(plte) % 3 or not plte):
        raise PNGError("palette image without a valid PLTE chunk")
    ch = CHANNELS[ctype]
    try:
        buf = np.frombuffer(zlib.decompressobj().decompress(b"".join(idat)),
                            np.uint8)
    except zlib.error as e:
        raise PNGError(f"bad compressed image data: {e}") from None
    if interlace:
        s = np.zeros((H, W, ch), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in ADAM7:
            w, h = -(-(W - x0) // dx), -(-(H - y0) // dy)
            if w <= 0 or h <= 0:
                continue
            try:
                sub, n = _samples(buf[pos:], h, w, depth, ch)
            except PNGError as e:
                raise PNGError(f"interlaced (Adam7) {e}") from None
            s[y0::dy, x0::dx] = sub
            pos += n
    else:
        s = _samples(buf, H, W, depth, ch)[0]
    t = None
    if ctype == 3:
        pal = np.frombuffer(plte, np.uint8).reshape(-1, 3)
        idx = s[..., 0]
        if int(idx.max()) >= len(pal):      # png_do_expand_palette: black
            pal = np.concatenate([pal, np.zeros((256 - len(pal), 3),
                                                np.uint8)])
        if trns:
            alpha = np.full(256, 255, np.uint8)
            a = np.frombuffer(trns[:len(pal)], np.uint8)
            alpha[:len(a)] = a
            pal = np.concatenate([pal, alpha[:len(pal), None]], 1)
        s = pal[idx]
    elif ctype == 0 and depth < 8:          # png_do_expand: to 0..255
        s = s * np.uint8(255 // ((1 << depth) - 1))
    elif ctype == 2 and trns is not None and len(trns) >= 6:
        t = struct.unpack(">HHH", trns[:6])
    gamma = GAMMA_SRGB if srgb else gama
    sig = max(sbit[:1 if ctype in (0, 4) else 3], default=0)
    return PNGImage(np.ascontiguousarray(s), t, gamma, ctype, sig, exif)


def _reciprocal(g: int) -> int:
    """png_reciprocal: 1e10 / g rounded (fixed point 1e-5)."""
    return int(math.floor(1e10 / g + .5))


def _significant(g: int) -> bool:
    """png_gamma_significant: further than 5% from 1."""
    return not 95000 <= g <= 105000


def _gamma_table(g: int) -> np.ndarray:
    """png_build_8bit_table: v -> round(255 (v / 255) ** (g * 1e-5)),
    the identity when g is not significant."""
    if not _significant(g):
        return np.arange(256)
    t = [math.floor(255 * math.pow(i / 255., g * .00001) + .5)
         for i in range(1, 255)]
    return np.asarray([0] + t + [255], np.int64)


def _gamma16(v: int, g: int) -> int:
    """png_gamma_16bit_correct."""
    if 0 < v < 65535:
        return math.floor(65535 * math.pow(v / 65535., g * .00001) + .5)
    return v


def _table16(shift: int, g: int) -> np.ndarray:
    """png_build_16bit_table as a function of v >> shift."""
    mx = (1 << (16 - shift)) - 1
    ig = np.arange(mx + 1)
    if _significant(g):
        fmax = 1.0 / mx
        return np.asarray([math.floor(65535. * math.pow(i * fmax, g * .00001)
                                      + .5) for i in range(mx + 1)])
    return (ig * 65535 + (1 << (15 - shift))) // mx if shift else ig


def _table16to8(shift: int, g: int) -> np.ndarray:
    """png_build_16to8_table as a function of v >> shift: each input to the
    nearest of the 256 outputs i * 257."""
    mx = (1 << (16 - shift)) - 1
    out = np.full(mx + 1, 65535)
    last = 0
    for i in range(255):
        bound = (_gamma16(i * 257 + 128, g) * mx + 32768) // 65535 + 1
        if bound > last:
            out[last:bound] = i * 257
            last = bound
    return out


def rgb_to_gray(rgb: np.ndarray, gamma: int | None = None,
                keep16: bool = True, sbit: int = 0) -> np.ndarray:
    """png_do_rgb_to_gray at OpenCV's coefficients on [..., 3] RGB samples
    (u8 or u16). At 8 bits: (9797 R + 19234 G + 3737 B) >> 15, a gray
    pixel kept as it is; at 16 bits the sum is rounded and taken for
    every pixel. For a file with a significant gamma g, the samples are
    made linear by the tables of 1 / g, summed with rounding and encoded
    again by the tables of g (png_build_gamma_table: 16-bit tables are
    indexed by v >> shift, shift = 16 - sBIT, at least 5 when the output
    is cut to 8 bits)."""
    x = rgb.astype(np.int64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    rc, gc, bc = RGB_TO_GRAY
    same = (r == g) & (r == b)
    linear = gamma is not None and _significant(gamma)
    if rgb.dtype == np.uint16:
        if not linear:
            return ((rc * r + gc * g + bc * b + 16384) >> 15).astype(
                np.uint16)
        shift = 16 - sbit if 0 < sbit < 16 else 0
        shift = min(shift if keep16 else max(shift, 5), 8)
        screen = _reciprocal(gamma)
        to1 = _table16(shift, _reciprocal(gamma))
        from1 = _table16(shift, _reciprocal(screen))
        y = (rc * to1[r >> shift] + gc * to1[g >> shift]
             + bc * to1[b >> shift] + 16384) >> 15
        if keep16:
            ident = _table16(shift, int(math.floor(1e15 / gamma / screen
                                                   + .5)))
        else:
            ident = _table16to8(shift, int(math.floor(gamma * screen * 1e-5
                                                      + .5)))
        return np.where(same, ident[r >> shift], from1[y >> shift]).astype(
            np.uint16)
    if linear:
        to1 = _gamma_table(_reciprocal(gamma))
        from1 = _gamma_table(_reciprocal(_reciprocal(gamma)))
        y = from1[(rc * to1[r] + gc * to1[g] + bc * to1[b] + 16384) >> 15]
    else:
        y = (rc * r + gc * g + bc * b) >> 15
    return np.where(same, r, y).astype(np.uint8)


def convert(img: PNGImage, channels: int, keep16: bool) -> np.ndarray:
    """What OpenCV 5's PNG decoder makes libpng return for an output of
    ``channels`` (1, 3 or 4) at 16 bits (``keep16``, when the file has
    them) or 8: [H, W] gray, [H, W, 3] BGR or [H, W, 4] BGRA."""
    px = img.pixels
    C = px.shape[2]
    has_alpha = C in (2, 4)
    col = px[..., :C - 1] if has_alpha else px
    if channels == 1:
        out = rgb_to_gray(col, img.gamma, keep16, img.sbit) \
            if col.shape[2] == 3 else col[..., 0]
    else:
        if col.shape[2] == 1:
            col = np.repeat(col, 3, axis=2)
        out = col[..., ::-1]
        if channels == 4:
            if has_alpha:
                alpha = px[..., -1:]
            else:                           # png_set_tRNS_to_alpha
                top = 65535 if px.dtype == np.uint16 else 255
                alpha = np.full(px.shape[:2] + (1,), top, px.dtype)
                if img.trns is not None:
                    alpha[(px == np.asarray(img.trns, px.dtype)).all(-1)] = 0
            out = np.concatenate([out, alpha], 2)
    if px.dtype == np.uint16 and not keep16:
        out = (out >> 8).astype(np.uint8)
    return np.ascontiguousarray(out)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> the file's samples without alpha: gray (and gray +
    alpha) [H, W], colour [H, W, 3] BGR, at the file's depth."""
    img = decode(data)
    return convert(img, 1 if img.ctype in (0, 4) else 3, keep16=True)


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
