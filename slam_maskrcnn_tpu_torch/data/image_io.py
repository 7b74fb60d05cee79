"""``imread`` / ``imdecode`` / ``imwrite`` without cv2: PNG and JPEG.

The JAX package reads photos with ``cv2.imread`` (COCO and balloon
images, the demo, TUM frames) and writes results with ``cv2.imwrite``.
These are those calls for the two formats the package meets, with
cv2's conventions:

* the format is chosen by the file's magic bytes on read (PNG through
  data/png.py, JPEG through data/jpeg.py) and by the extension on write;
* ``IMREAD_COLOR`` (the default) gives u8 [H, W, 3] BGR, a gray file
  replicated to three channels; ``IMREAD_GRAYSCALE`` gives [H, W] (a
  colour JPEG's luma, as libjpeg outputs it), ``IMREAD_ANYDEPTH`` the
  same with 16-bit PNGs kept u16; ``IMREAD_UNCHANGED`` keeps a gray file
  [H, W] and a colour one BGR;
* a JPEG's EXIF orientation is applied as OpenCV 5 applies it (all
  eight cases) unless the flags hold ``IMREAD_IGNORE_ORIENTATION`` or
  are ``IMREAD_UNCHANGED``;
* an unreadable file (missing, empty, not PNG or JPEG, damaged) gives
  ``None`` and a warning on stderr, as ``cv2.imread`` does.

A JPEG's pixel stages run in torch on ``device`` (the card by default;
``device="cpu"`` for the plain CPU run); the result is a numpy array.
``image_size`` reads the size from the PNG IHDR or the JPEG SOF header,
after the orientation, without decoding.
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


def _mode(flags: int) -> int:
    """The read mode without the orientation bit (-1 stays -1)."""
    return IMREAD_UNCHANGED if flags < 0 else flags & ~IMREAD_IGNORE_ORIENTATION


def _png_flags(img: np.ndarray, flags: int) -> np.ndarray:
    mode = _mode(flags)
    if mode == IMREAD_UNCHANGED:
        return img
    if mode in (IMREAD_GRAYSCALE, IMREAD_ANYDEPTH):
        if img.ndim == 3:
            raise png.PNGError("a colour PNG read as gray is not supported")
        if mode == IMREAD_ANYDEPTH or img.dtype == np.uint8:
            return img
        return (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        if img.dtype != np.uint8:
            img = (img >> 8).astype(np.uint8)
        img = np.repeat(img[:, :, None], 3, axis=2)
    return img


def imdecode(data, flags: int = IMREAD_COLOR, device="cuda"):
    """cv2.imdecode(buf, flags) for PNG and JPEG bytes; None if they are
    neither or are damaged."""
    data = bytes(data)
    try:
        if data[:8] == png.SIGNATURE:
            return _png_flags(png.decode_png(data), flags)
        if data[:3] == JPEG_SOI:
            mode = _mode(flags)
            gray_out = mode in (IMREAD_GRAYSCALE, IMREAD_ANYDEPTH)
            img = jpeg.decode(data, device, gray=gray_out).cpu().numpy()
            if img.ndim == 2 and mode == IMREAD_COLOR:
                img = np.repeat(img[:, :, None], 3, axis=2)
            if mode != IMREAD_UNCHANGED and \
                    not flags & IMREAD_IGNORE_ORIENTATION:
                img = orient(img, jpeg.exif_orientation(data))
            return img
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
        return int(h), int(w)
    if data[:3] == JPEG_SOI:
        hdr = jpeg.info(data)
        h, w = hdr["height"], hdr["width"]
        if jpeg.exif_orientation(data) >= 5:
            h, w = w, h
        return h, w
    raise ValueError(f"{path}: not a PNG or JPEG file")
