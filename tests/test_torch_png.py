"""The port's PNG codec (slam_maskrcnn_tpu_torch/data/png.py) against cv2:
u8 gray, u8 BGR and u16 gray at odd sizes, written by one and read by the
other; every row filter; and damaged files, refused where cv2 refuses
them."""

import struct
import zlib

import cv2
import numpy as np
import pytest

from slam_maskrcnn_tpu_torch.data import image_io
from slam_maskrcnn_tpu_torch.data.png import (PNGError, chunk, decode_png,
                                              encode_png, read_png,
                                              write_png)

FILTERS = ("none", "sub", "up", "average", "paeth")

SIZES = [(1, 1), (7, 13), (37, 53), (120, 161)]
KINDS = {"gray8": (np.uint8, ()), "bgr8": (np.uint8, (3,)),
         "gray16": (np.uint16, ())}


def _image(kind, size, seed):
    """Noise over smooth ramps, so that every filter has work to do."""
    dtype, extra = KINDS[kind]
    rng = np.random.default_rng(seed)
    top = 255 if dtype == np.uint8 else 65535
    y, x = np.mgrid[:size[0], :size[1]]
    ramp = (y * 7 + x * 3)[..., None] if extra else (y * 7 + x * 3)
    img = (ramp + rng.integers(0, top // 8 + 1, size + extra)) % (top + 1)
    return img.astype(dtype)


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("size", SIZES)
def test_cv2_written_read_by_port(tmp_path, kind, size):
    img = _image(kind, size, 0)
    path = str(tmp_path / "a.png")
    assert cv2.imwrite(path, img)
    got = read_png(path)
    assert got.dtype == img.dtype and got.shape == img.shape
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("size", SIZES)
def test_port_written_read_by_cv2(tmp_path, kind, size):
    img = _image(kind, size, 1)
    path = write_png(str(tmp_path / "b.png"), img)
    flag = cv2.IMREAD_UNCHANGED
    got = cv2.imread(path, flag)
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(read_png(path), img)


def _encode(img, ftypes):
    """A PNG of img with row k filtered by ftypes[k % len(ftypes)] (the
    filters as the PNG specification defines them, on the raw bytes)."""
    png = encode_png(img)                      # its IHDR, sub-filtered IDAT
    H = img.shape[0]
    raw = np.frombuffer(zlib.decompress(_idat(png)), np.uint8).reshape(H, -1)
    px = _unsub(raw[:, 1:], png).astype(np.int32)
    bpp = {(8, 0): 1, (8, 2): 3, (16, 0): 2}[(png[24], png[25])]
    a = np.zeros_like(px)
    a[:, bpp:] = px[:, :-bpp]
    b = np.zeros_like(px)
    b[1:] = px[:-1]
    c = np.zeros_like(px)
    c[1:, bpp:] = px[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = (0, a, b, (a + b) >> 1, paeth)
    rows = []
    for k in range(H):
        t = ftypes[k % len(ftypes)]
        pred = preds[t][k] if t else 0
        rows.append(bytes([t]) + ((px[k] - pred) & 0xFF).astype(
            np.uint8).tobytes())
    return png[:33] + chunk(b"IDAT", zlib.compress(b"".join(rows))) \
        + chunk(b"IEND", b"")


def _unsub(rows, png):
    """Undo the writer's sub filter (the raw bytes of every row)."""
    bpp = {(8, 0): 1, (8, 2): 3, (16, 0): 2}[(png[24], png[25])]
    out = rows.astype(np.int32)
    for x in range(bpp, out.shape[1]):
        out[:, x] = (out[:, x] + out[:, x - bpp]) & 0xFF
    return out.astype(np.uint8)


@pytest.mark.parametrize("ftype", range(len(FILTERS)))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_each_filter_type(tmp_path, ftype, kind):
    """Every row filtered with one filter type (none, sub, up, average,
    paeth): cv2 and the port both read back the image."""
    img = _image(kind, (29, 31), 2 + ftype)
    data = _encode(img, [ftype])
    np.testing.assert_array_equal(decode_png(data), img)
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(data)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED),
                                  img)


def test_mixed_filters_and_rgba(tmp_path):
    """Files may mix filters row by row; an RGBA file reads as BGR with
    the alpha dropped, as cv2.imread does."""
    rng = np.random.default_rng(5)
    rgba = rng.integers(0, 256, (23, 17, 4)).astype(np.uint8)
    path = str(tmp_path / "rgba.png")
    assert cv2.imwrite(path, rgba)
    np.testing.assert_array_equal(read_png(path), cv2.imread(path))
    for kind in sorted(KINDS):
        img = _image(kind, (25, 19), 6)
        data = _encode(img, [0, 1, 2, 3, 4, 2, 1])
        np.testing.assert_array_equal(decode_png(data), img)
        with open(path, "wb") as f:
            f.write(data)
        np.testing.assert_array_equal(
            cv2.imread(path, cv2.IMREAD_UNCHANGED), img)


def _idat(png: bytes) -> bytes:
    pos, out = 8, b""
    while pos < len(png):
        n, kind = struct.unpack(">I4s", png[pos:pos + 8])
        if kind == b"IDAT":
            out += png[pos + 8:pos + 8 + n]
        pos += 12 + n
    return out


def _header(png: bytes, **kw) -> bytes:
    w, h, depth, ctype, comp, filt, inter = struct.unpack(">IIBBBBB",
                                                          png[16:29])
    vals = dict(depth=depth, ctype=ctype, interlace=inter)
    vals.update(kw)
    body = struct.pack(">IIBBBBB", w, h, vals["depth"], vals["ctype"], comp,
                       filt, vals["interlace"])
    return png[:8] + chunk(b"IHDR", body) + png[33:]


@pytest.mark.parametrize("what,kw,match", [
    ("interlaced", dict(interlace=1), "interlaced"),
    ("palette", dict(ctype=3), "PLTE"),
    ("bit depth 4", dict(depth=4), "filter type"),
    ("gray + alpha", dict(ctype=4), "image data"),
])
def test_unsupported_layouts_raise(what, kw, match):
    """A gray image's IHDR rewritten to another layout no longer matches
    its data (or lacks its PLTE): a damaged file, which the port refuses
    where cv2.imdecode gives None."""
    png = _header(encode_png(_image("gray8", (8, 8), 7)), **kw)
    with pytest.raises(PNGError, match=match):
        decode_png(png)
    assert cv2.imdecode(np.frombuffer(png, np.uint8),
                        cv2.IMREAD_UNCHANGED) is None
    assert image_io.imdecode(png, image_io.IMREAD_UNCHANGED) is None


def test_damaged_or_unwritable_raise(tmp_path):
    img = _image("gray8", (16, 16), 8)
    path = str(tmp_path / "i.png")
    assert cv2.imwrite(path, img)
    data = open(path, "rb").read()
    with pytest.raises(PNGError, match="interlaced"):
        decode_png(_header(data, interlace=1))
    with pytest.raises(PNGError, match="CRC"):
        decode_png(data[:40] + bytes([data[40] ^ 1]) + data[41:])
    with pytest.raises(PNGError, match="cannot write"):
        encode_png(np.zeros((4, 4, 4), np.uint8))
