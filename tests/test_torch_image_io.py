"""The port's ``imread`` (data/image_io.py over data/png.py and data/jpeg.py)
against ``cv2.imread`` of OpenCV 5 on the CPU, for every kind of PNG that
libpng reads and the four-component JPEGs: each file kind crossed with the
flags 1, 0, 2, -1, 1 | 2, 4 and ``IMREAD_IGNORE_ORIENTATION``. The bar is
equality of dtype, shape and every value.

The files are written by PIL and cv2 where they can write the kind; the
rest (2- and 4-bit gray, Adam7, gamma chunks) by a PNG writer over zlib
below, which also mixes the five row filters."""

import io
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from slam_maskrcnn_tpu_torch.data import image_io, jpeg
from slam_maskrcnn_tpu_torch.data.png import SIGNATURE, chunk

H, W = 24, 32
FLAGS = [1, 0, 2, -1, 1 | 2, 4, 128]


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _pil(im, fmt="PNG", **kw) -> bytes:
    b = io.BytesIO()
    im.save(b, fmt, **kw)
    return b.getvalue()


def _cv2(img) -> bytes:
    ok, b = cv2.imencode(".png", img)
    assert ok
    return b.tobytes()


def _filter_rows(rows: np.ndarray, bpp: int, seed: int) -> bytes:
    """Each row of raw bytes [h, n] filtered with a filter type drawn from
    seed (none, sub, up, average, paeth), as the PNG specification
    defines them."""
    px = rows.astype(np.int32)
    h, n = px.shape
    a = np.zeros_like(px)
    a[:, bpp:] = px[:, :-bpp]
    b = np.zeros_like(px)
    b[1:] = px[:-1]
    c = np.zeros_like(px)
    c[1:, bpp:] = px[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = (np.zeros_like(px), a, b, (a + b) >> 1, paeth)
    types = np.random.default_rng(seed).integers(0, 5, h)
    out = b""
    for k in range(h):
        out += bytes([types[k]]) + ((px[k] - preds[types[k]][k]) & 0xFF
                                    ).astype(np.uint8).tobytes()
    return out


def _raw_rows(s: np.ndarray, depth: int) -> np.ndarray:
    """Samples [h, w, ch] -> the raw bytes of each row [h, n]."""
    h, w, ch = s.shape
    if depth == 16:
        return s.astype(">u2").view(np.uint8).reshape(h, w * ch * 2)
    if depth == 8:
        return s.astype(np.uint8).reshape(h, w * ch)
    bits = np.unpackbits(s.astype(np.uint8).reshape(h, w * ch, 1), axis=2)
    bits = bits[:, :, 8 - depth:].reshape(h, -1)
    return np.packbits(bits, axis=1)


def hand_png(s, depth, ctype, interlace=False, plte=None, trns=None,
             extra=b"") -> bytes:
    """A PNG of samples s [H, W, ch] written over zlib, optionally Adam7
    interlaced (PIL writes no interlaced file), every row with a drawn
    filter type."""
    h, w, ch = s.shape
    bpp = max(1, ch * depth // 8)
    if interlace:
        data = b""
        passes = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
                  (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
        for k, (x0, y0, dx, dy) in enumerate(passes):
            sub = s[y0::dy, x0::dx]
            if sub.size:
                data += _filter_rows(_raw_rows(sub, depth), bpp, k)
    else:
        data = _filter_rows(_raw_rows(s, depth), bpp, 9)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace))
    out = SIGNATURE + chunk(b"IHDR", ihdr) + extra
    if plte is not None:
        out += chunk(b"PLTE", plte.astype(np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    return out + chunk(b"IDAT", zlib.compress(data)) + chunk(b"IEND", b"")


def _samples(name, ch, depth, h=H, w=W):
    top = (1 << depth) - 1
    return _rng(name).integers(0, top + 1, (h, w, ch)).astype(
        np.uint16 if depth == 16 else np.uint8)


def _with_gray_pixels(rgb):
    """Some pixels with R == G == B (libpng keeps them as they are)."""
    rgb = rgb.copy()
    rgb[::5, ::3] = rgb[::5, ::3, :1]
    return rgb


def _palette(name, n):
    return _rng(name + "pal").integers(0, 256, (n, 3))


def _kinds():
    k = {}
    rgb = _with_gray_pixels(_samples("rgb8", 3, 8))
    k["rgb8"] = _pil(Image.fromarray(rgb))
    k["rgb16_cv2"] = _cv2(_with_gray_pixels(_samples("rgb16", 3, 16)))
    k["rgba8"] = _pil(Image.fromarray(_samples("rgba8", 4, 8)))
    k["rgba16_cv2"] = _cv2(_samples("rgba16", 4, 16))
    k["gray8"] = _pil(Image.fromarray(rgb[..., 0]))
    k["gray16"] = _pil(Image.fromarray(_samples("gray16", 1, 16)[..., 0]))
    k["gray_alpha8"] = _pil(Image.fromarray(_samples("la", 2, 8), "LA"))
    k["bit1"] = _pil(Image.fromarray(rgb[..., 0] > 127).convert("1"))
    pal = Image.fromarray(rgb).quantize(37)
    k["palette8"] = _pil(pal)
    k["palette2"] = _pil(Image.fromarray(rgb).quantize(4), bits=2)
    k["palette_trns"] = _pil(pal, transparency=bytes(range(0, 255, 9)))
    k["rgb_trns"] = _pil(Image.fromarray(rgb),
                         transparency=tuple(int(v) for v in rgb[3, 4]))
    k["gray_trns"] = _pil(Image.fromarray(rgb[..., 0]),
                          transparency=int(rgb[0, 0, 0]))
    for d in (2, 4):
        k[f"gray{d}"] = hand_png(_samples(f"g{d}", 1, d), d, 0)
    k["gray_alpha16"] = hand_png(_samples("la16", 2, 16), 16, 4)
    k["rgb16_trns"] = hand_png(
        _samples("rgb16t", 3, 16), 16, 2,
        trns=_samples("rgb16t", 3, 16)[2, 2].astype(">u2").tobytes())
    # Adam7 over every colour type, at an odd size so that every pass
    # has a ragged edge
    for name, ch, d, ct in (("gray1", 1, 1, 0), ("gray8", 1, 8, 0),
                            ("rgb8", 3, 8, 2), ("rgba16", 4, 16, 6),
                            ("gray_alpha8", 2, 8, 4), ("palette4", 1, 4, 3)):
        s = _samples("adam7" + name, ch, d, h=H - 3, w=W - 5)
        plte = _palette(name, 16) if ct == 3 else None
        k[f"adam7_{name}"] = hand_png(s, d, ct, interlace=True, plte=plte)
    k["adam7_1x1"] = hand_png(_samples("one", 3, 8, 1, 1), 8, 2,
                              interlace=True)
    # the file's gamma feeds libpng's colour to gray conversion
    gama = chunk(b"gAMA", struct.pack(">I", 45455))
    srgb = chunk(b"sRGB", b"\0")
    k["rgb8_gama"] = hand_png(rgb, 8, 2, extra=gama)
    k["rgb8_srgb_over_gama"] = hand_png(
        rgb, 8, 2, extra=srgb + chunk(b"gAMA", struct.pack(">I", 70000)))
    k["palette_gama"] = hand_png(
        _samples("pg", 1, 8), 8, 3, plte=_palette("pg", 256), extra=gama)
    rgb16 = _with_gray_pixels(_samples("rgb16g", 3, 16))
    k["rgb16_gama"] = hand_png(rgb16, 16, 2, extra=gama)
    k["rgb16_gama_sbit12"] = hand_png(
        rgb16, 16, 2, extra=gama + chunk(b"sBIT", bytes([12] * 3)))
    # an eXIf orientation, applied unless the flags are -1 or hold
    # IMREAD_IGNORE_ORIENTATION
    for o in (3, 6):
        tiff = b"MM\0\x2a\0\0\0\x08\0\x01" + struct.pack(
            ">HHIHH", 0x112, 3, 1, o, 0) + b"\0\0\0\0"
        k[f"rgb8_exif{o}"] = hand_png(rgb, 8, 2, extra=chunk(b"eXIf", tiff))
    # JPEGs: CMYK (Adobe, inverted) as PIL writes it, the same file with
    # Adobe transform 2 (YCCK), and an RGB one (read as gray through
    # libjpeg's rgb_gray_convert)
    cmyk = _samples("cmyk", 4, 8)
    k["cmyk_jpeg"] = _pil(Image.fromarray(cmyk, "CMYK"), "JPEG", quality=90)
    k["ycck_jpeg"] = _adobe_transform(k["cmyk_jpeg"], 2)
    k["rgb_jpeg"] = _pil(Image.fromarray(rgb), "JPEG", keep_rgb=True)
    # the port's own CMYK writer (Adobe transform 0), at an odd size
    k["cmyk_port_jpeg"] = jpeg.encode_cmyk(
        _samples("cmykp", 4, 8, h=H + 5, w=W + 3), quality=80, device="cpu")
    return k


def _adobe_transform(data: bytes, t: int) -> bytes:
    at = data.index(b"Adobe")
    assert data[at - 4:at - 2] == b"\xff\xee"
    return data[:at + 11] + bytes([t]) + data[at + 12:]


KINDS = _kinds()


@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_imread_equals_cv2(tmp_path, kind, flags):
    path = tmp_path / ("f.jpg" if kind.endswith("jpeg") else "f.png")
    path.write_bytes(KINDS[kind])
    want = cv2.imread(str(path), flags)
    assert want is not None, "the fixture is a file cv2 reads"
    got = image_io.imread(path, flags, device="cpu")
    assert got is not None
    assert (got.dtype, got.shape) == (want.dtype, want.shape)
    np.testing.assert_array_equal(got, want)
    if flags == image_io.IMREAD_COLOR:
        assert image_io.image_size(path) == want.shape[:2]


def test_fixture_kinds():
    """The kinds are what their names say (the IHDR or SOF / Adobe)."""
    for name, data in KINDS.items():
        if name.endswith("jpeg"):
            assert data[:3] == b"\xff\xd8\xff"
            continue
        depth, ctype, _, _, inter = data[24:29]
        assert inter == name.startswith("adam7"), name
        if name.startswith("palette") or name == "adam7_palette4":
            assert ctype == 3, name
        if "gray_alpha" in name:
            assert ctype == 4, name
    assert KINDS["bit1"][24] == 1 and KINDS["palette2"][24] == 2
    assert KINDS["gray2"][24] == 2 and KINDS["gray4"][24] == 4


def test_dataset_load_image_equals_jax(tmp_path):
    """Dataset.load_image (RGB, through imread) on every PNG kind equals
    the JAX Dataset's (cv2.imread then BGR -> RGB). (It decodes a JPEG's
    pixels on the card, the port's default device.)"""
    from slam_maskrcnn_tpu.data.dataset import Dataset as JDataset
    from slam_maskrcnn_tpu_torch.data.dataset import Dataset as TDataset

    jd, td = JDataset(), TDataset()
    pngs = [n for n in sorted(KINDS) if not n.endswith("jpeg")]
    for k, name in enumerate(pngs):
        path = tmp_path / (name + ".png")
        path.write_bytes(KINDS[name])
        for d in (jd, td):
            d.add_image("kinds", image_id=k, path=str(path))
    jd.prepare()
    td.prepare()
    for i in td.image_ids:
        t, j = td.load_image(i), jd.load_image(i)
        assert t.dtype == j.dtype == np.uint8 and t.shape == j.shape
        np.testing.assert_array_equal(t, j)
