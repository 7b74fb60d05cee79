"""``imread`` / ``imdecode`` / ``imwrite`` without cv2: PNG and JPEG.

The JAX package reads photos, masks and depth maps with ``cv2.imread``
(COCO and balloon images, the demo, TUM frames, nucleus masks) and
writes results with ``cv2.imwrite``. These are those calls for the two
formats the package meets, equal to OpenCV 5's in dtype, shape and every
value:

* the format is chosen by the file's magic bytes on read (PNG through
  data/png.py, JPEG through data/jpeg.py) and by the extension on write;
* the flags as ``imread_`` applies them to the decoder's type (its
  channels at ``IMREAD_UNCHANGED``: a PNG's alpha or tRNS gives 4, a
  four-component JPEG 3): any flags but -1 drop alpha; without
  ``IMREAD_ANYDEPTH`` 16-bit samples are cut to 8; ``IMREAD_COLOR`` (the
  default), or ``IMREAD_ANYCOLOR`` on a colour file, gives [H, W, 3] BGR,
  anything else [H, W] gray (a PNG's colour through libpng's
  ``rgb_to_gray``, a JPEG's as libjpeg outputs it, a CMYK one through
  OpenCV's conversion);
* the EXIF orientation of a JPEG's APP1 or a PNG's eXIf chunk is applied
  as OpenCV 5 applies it (all eight cases) unless the flags hold
  ``IMREAD_IGNORE_ORIENTATION`` or are ``IMREAD_UNCHANGED``;
* an unreadable file (missing, empty, not PNG or JPEG, damaged) gives
  ``None`` and a warning on stderr, as ``cv2.imread`` does.

A JPEG's pixel stages run in torch on ``device`` (the card by default;
``device="cpu"`` for the plain CPU run); a PNG decodes on the host. The
result is a numpy array. ``image_size`` reads the size from the PNG
IHDR or the JPEG SOF header, after the orientation, without decoding.
"""

from __future__ import annotations

import os
import struct
import sys

import numpy as np

from slam_maskrcnn_tpu_torch.data import jpeg, png

IMREAD_UNCHANGED = -1
IMREAD_GRAYSCALE = 0
IMREAD_COLOR = 1
IMREAD_ANYDEPTH = 2
IMREAD_ANYCOLOR = 4
IMREAD_IGNORE_ORIENTATION = 128

JPEG_SOI = b"\xff\xd8\xff"
JPEG_EXTS = (".jpg", ".jpeg", ".jpe")


def _warn(msg: str) -> None:
    print(f"imread: {msg}", file=sys.stderr)


def orient(img: np.ndarray, o: int) -> np.ndarray:
    """EXIF orientation 1-8 applied to an [H, W(, C)] array."""
    if o == 2:
        img = img[:, ::-1]
    elif o == 3:
        img = img[::-1, ::-1]
    elif o == 4:
        img = img[::-1]
    elif o == 5:
        img = img.swapaxes(0, 1)
    elif o == 6:
        img = img[::-1].swapaxes(0, 1)
    elif o == 7:
        img = img[::-1, ::-1].swapaxes(0, 1)
    elif o == 8:
        img = img[:, ::-1].swapaxes(0, 1)
    return np.ascontiguousarray(img)


def _shape(flags: int, channels: int) -> tuple[int, bool]:
    """imread_'s output for a decoder of ``channels`` (its type at
    IMREAD_UNCHANGED): (channels, keep 16 bits). Any flags but -1 drop
    alpha; IMREAD_ANYDEPTH keeps the depth; IMREAD_COLOR, or
    IMREAD_ANYCOLOR on a colour file, gives three channels, else one."""
    if flags == IMREAD_UNCHANGED:
        return channels, True
    color = flags & IMREAD_COLOR or (flags & IMREAD_ANYCOLOR
                                     and channels > 1)
    return (3 if color else 1), bool(flags & IMREAD_ANYDEPTH)


def _oriented(img: np.ndarray, flags: int, o: int) -> np.ndarray:
    if flags != IMREAD_UNCHANGED and not flags & IMREAD_IGNORE_ORIENTATION:
        img = orient(img, o)
    return img


def _png(data: bytes, flags: int) -> np.ndarray:
    img = png.decode(data)
    out = png.convert(img, *_shape(flags, img.cv_channels))
    return _oriented(out, flags, jpeg.tiff_orientation(img.exif))


def _jpeg(data: bytes, flags: int, device) -> np.ndarray:
    channels = _shape(flags, 1 if jpeg.info(data)["ncomp"] == 1 else 3)[0]
    img = jpeg.decode(data, device, gray=channels == 1).cpu().numpy()
    if img.ndim == 2 and channels == 3:
        img = np.repeat(img[:, :, None], 3, axis=2)
    return _oriented(img, flags, jpeg.exif_orientation(data))


def imdecode(data, flags: int = IMREAD_COLOR, device="cuda"):
    """cv2.imdecode(buf, flags) for PNG and JPEG bytes; None if they are
    neither or are damaged."""
    data = bytes(data)
    try:
        if data[:8] == png.SIGNATURE:
            return _png(data, flags)
        if data[:3] == JPEG_SOI:
            return _jpeg(data, flags, device)
    except (jpeg.JPEGError, png.PNGError) as e:
        _warn(f"cannot decode the image: {e}")
        return None
    _warn("not a PNG or JPEG file")
    return None


def imread(path, flags: int = IMREAD_COLOR, device="cuda"):
    """cv2.imread(path, flags) for PNG and JPEG files; None when the file
    is missing or unreadable."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        _warn(f"cannot open {path}: {e}")
        return None
    if not data:
        _warn(f"{path} is empty")
        return None
    return imdecode(data, flags, device)


def imwrite(path, img: np.ndarray, quality: int = 95,
            device="cuda") -> bool:
    """cv2.imwrite(path, img) for ".png" and ".jpg" (the JPEG at
    ``quality``, cv2's default 95, 4:2:0); the format from the
    extension."""
    ext = os.path.splitext(str(path))[1].lower()
    if ext == ".png":
        data = png.encode_png(np.ascontiguousarray(img))
    elif ext in JPEG_EXTS:
        data = jpeg.encode(img, quality=quality, device=device)
    else:
        raise ValueError(f"cannot write {ext!r} files (PNG and JPEG only)")
    with open(path, "wb") as f:
        f.write(data)
    return True


def image_size(path) -> tuple[int, int]:
    """(height, width) of a PNG or JPEG as cv2.imread would return it
    (a JPEG's EXIF orientation 5-8 swaps them), from the headers."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == png.SIGNATURE:
        if data[12:16] != b"IHDR":
            raise png.PNGError(f"{path}: no IHDR chunk")
        w, h = struct.unpack(">II", data[16:24])
        for kind, body in png.chunks(data):      # eXIf comes before IDAT
            if kind == b"IDAT":
                break
            if kind == b"eXIf" and jpeg.tiff_orientation(body) >= 5:
                h, w = w, h
        return int(h), int(w)
    if data[:3] == JPEG_SOI:
        hdr = jpeg.info(data)
        h, w = hdr["height"], hdr["width"]
        if jpeg.exif_orientation(data) >= 5:
            h, w = w, h
        return h, w
    raise ValueError(f"{path}: not a PNG or JPEG file")
