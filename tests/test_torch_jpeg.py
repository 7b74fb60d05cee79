"""The port's JPEG codec (data/jpeg.py, csrc/jpeg.cpp) and image I/O
(data/image_io.py) against OpenCV 5 on the CPU.

Decoder: bit-equal to ``cv2.imdecode`` on a corpus made by
``cv2.imencode``: sizes 1x1 to 480x640, qualities 50 / 75 / 95 / 100,
sampling 4:4:4 / 4:2:2 / 4:2:0 / 4:4:0 / 4:1:1 and gray, each plain,
with a restart interval, progressive and with optimised tables; EXIF
orientations 1-8 spliced by hand. Encoder: byte-equal to
``cv2.imencode(".jpg")`` for the same grid (baseline, with and without
restarts), its progressive files decoded by cv2 to the pixels of cv2's
own. ``imread`` / ``imwrite`` / ``image_size`` dispatch by magic bytes
and extension, ``None`` for unreadable files."""

import struct

import cv2
import numpy as np
import pytest
import torch

from slam_maskrcnn_tpu_torch.data import image_io, jpeg, png

torch.set_num_threads(2)

SIZES = [(1, 1), (7, 13), (37, 53), (33, 65), (480, 640)]
QUALITIES = (50, 75, 95, 100)
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
OPTIONS = {"plain": [], "restart": [cv2.IMWRITE_JPEG_RST_INTERVAL, 3],
           "progressive": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
           "optimize": [cv2.IMWRITE_JPEG_OPTIMIZE, 1]}


def photo(h, w, seed=0):
    """A smooth colour field with noise, seeded."""
    rng = np.random.default_rng(seed + 31 * h + w)
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([128 + 100 * np.sin(xx / 7.0 + c) * np.cos(yy / 9.0 - c)
                     for c in range(3)], -1)
    return np.clip(base + rng.normal(0, 20, base.shape), 0,
                   255).astype(np.uint8)


def cv_jpeg(img, quality, sampling=None, extra=()):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if sampling is not None:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    ok, buf = cv2.imencode(".jpg", img, params + list(extra))
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", list(SAMPLING) + ["gray"])
def test_decoder_bit_equal_to_cv2(size, sampling):
    img = photo(*size)
    if sampling == "gray":
        img = img[..., 1].copy()
    for q in QUALITIES:
        for name, extra in OPTIONS.items():
            data = cv_jpeg(img, q, None if sampling == "gray" else sampling,
                           extra)
            want = cv2.imdecode(np.frombuffer(data, np.uint8),
                                cv2.IMREAD_UNCHANGED)
            got = jpeg.decode(data, "cpu").numpy()
            assert got.dtype == np.uint8 and got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=f"q{q} {name}")
            if sampling != "gray" and q == 75:
                luma = jpeg.decode(data, "cpu", gray=True).numpy()
                np.testing.assert_array_equal(
                    luma, cv2.imdecode(np.frombuffer(data, np.uint8),
                                       cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", list(SAMPLING) + ["gray"])
def test_encoder_byte_equal_to_cv2(size, sampling):
    img = photo(*size, seed=1)
    if sampling == "gray":
        img = img[..., 2].copy()
    for q in QUALITIES:
        for rst in (0, 3):
            want = cv_jpeg(img, q, None if sampling == "gray" else sampling,
                           [cv2.IMWRITE_JPEG_RST_INTERVAL, rst])
            got = jpeg.encode(img, q, "420" if sampling == "gray"
                              else sampling, rst, device="cpu")
            assert got == want, f"q{q} rst{rst}"


@pytest.mark.parametrize("gray", [False, True])
def test_progressive_encoder_decodes_as_cv2s(gray):
    """The port's progressive files (jpeg_simple_progression, optimal
    tables) decode, in cv2 and in the port, to the pixels of cv2's own
    progressive file of the same image."""
    for size in SIZES[1:]:
        img = photo(*size, seed=2)
        if gray:
            img = img[..., 0].copy()
        for q in (75, 95):
            mine = jpeg.encode(img, q, progressive=True, device="cpu")
            ref = cv_jpeg(img, q, extra=[cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
            assert jpeg.info(mine)["progressive"]
            want = cv2.imdecode(np.frombuffer(ref, np.uint8),
                                cv2.IMREAD_UNCHANGED)
            np.testing.assert_array_equal(
                cv2.imdecode(np.frombuffer(mine, np.uint8),
                             cv2.IMREAD_UNCHANGED), want)
            np.testing.assert_array_equal(jpeg.decode(mine, "cpu").numpy(),
                                          want)


def exif_jpeg(data: bytes, orientation: int, endian: str = "II") -> bytes:
    """An APP1 Exif segment holding only the orientation tag, spliced in
    after SOI."""
    e = "<" if endian == "II" else ">"
    tiff = (endian.encode() + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(e + "I", 0))
    app1 = b"Exif\0\0" + tiff
    return (data[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2)
            + app1 + data[2:])


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_as_cv2(tmp_path, orientation):
    img = photo(12, 20, seed=3)
    base = cv_jpeg(img, 90, "420")
    for endian in ("II", "MM"):
        data = exif_jpeg(base, orientation, endian)
        want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(
            image_io.imdecode(data, device="cpu"), want)
        path = tmp_path / f"o{orientation}{endian}.jpg"
        path.write_bytes(data)
        np.testing.assert_array_equal(image_io.imread(path, device="cpu"),
                                      cv2.imread(str(path)))
        assert image_io.image_size(path) == want.shape[:2]
        kept = image_io.imdecode(
            data, image_io.IMREAD_COLOR | image_io.IMREAD_IGNORE_ORIENTATION,
            device="cpu")
        np.testing.assert_array_equal(
            kept, cv2.imdecode(np.frombuffer(data, np.uint8),
                               cv2.IMREAD_COLOR
                               | cv2.IMREAD_IGNORE_ORIENTATION))


def test_imread_imwrite_dispatch(tmp_path):
    img = photo(40, 56, seed=4)
    gray = img[..., 0].copy()
    depth = (np.arange(40 * 56, dtype=np.uint16) * 29).reshape(40, 56)
    # JPEG: written as cv2.imwrite writes it, read back as cv2.imread
    for name, a in (("c.jpg", img), ("g.jpeg", gray)):
        p = tmp_path / name
        assert image_io.imwrite(p, a, device="cpu")
        q = tmp_path / ("cv_" + name)
        cv2.imwrite(str(q), a)
        assert p.read_bytes() == q.read_bytes()
        for flags in (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE,
                      cv2.IMREAD_UNCHANGED):
            np.testing.assert_array_equal(
                image_io.imread(p, flags, device="cpu"),
                cv2.imread(str(p), flags))
        assert image_io.image_size(p) == a.shape[:2]
    # PNG through data/png.py
    for name, a in (("c.png", img), ("g.png", gray), ("d.png", depth)):
        p = tmp_path / name
        image_io.imwrite(p, a)
        assert image_io.image_size(p) == a.shape[:2]
        np.testing.assert_array_equal(image_io.imread(p), cv2.imread(str(p)))
        np.testing.assert_array_equal(
            image_io.imread(p, image_io.IMREAD_UNCHANGED),
            cv2.imread(str(p), cv2.IMREAD_UNCHANGED))
    np.testing.assert_array_equal(
        image_io.imread(tmp_path / "d.png", image_io.IMREAD_ANYDEPTH),
        cv2.imread(str(tmp_path / "d.png"), cv2.IMREAD_ANYDEPTH))
    # the format comes from the bytes, not the name
    swapped = tmp_path / "really_png.jpg"
    swapped.write_bytes(png.encode_png(img))
    np.testing.assert_array_equal(image_io.imread(swapped), img)


def test_unreadable_files_give_none(tmp_path):
    assert image_io.imread(tmp_path / "missing.jpg") is None
    (tmp_path / "empty.jpg").write_bytes(b"")
    assert image_io.imread(tmp_path / "empty.jpg") is None
    (tmp_path / "text.jpg").write_bytes(b"not an image at all")
    assert image_io.imread(tmp_path / "text.jpg") is None
    data = cv_jpeg(photo(16, 16), 80, "420")
    cut = data[:40]                        # headers only: no frame, no scan
    (tmp_path / "cut.jpg").write_bytes(cut)
    assert image_io.imread(tmp_path / "cut.jpg", device="cpu") is None
    assert cv2.imread(str(tmp_path / "cut.jpg")) is None
    with pytest.raises(ValueError, match="png|PNG|JPEG"):
        image_io.imwrite(tmp_path / "x.bmp", photo(4, 4))


def test_unsupported_constructs_raise_by_name():
    data = bytearray(cv_jpeg(photo(16, 16), 80, "420"))
    sof = data.index(b"\xff\xc0")
    data[sof + 1] = 0xC9                   # arithmetic-coded frame
    with pytest.raises(jpeg.JPEGError, match="arithmetic"):
        jpeg.decode(bytes(data), "cpu")
    with pytest.raises(jpeg.JPEGError, match="SOI"):
        jpeg.info(b"\x89PNG....")


def test_decode_defaults_to_the_card():
    data = cv_jpeg(photo(8, 8), 80, "420")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        jpeg.decode(data)
    with pytest.raises(RuntimeError, match="CUDA"):
        jpeg.encode(photo(8, 8))
