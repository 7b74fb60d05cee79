"""Caption text as OpenCV 5's ``putText`` draws it, without cv2.

In OpenCV 5, ``cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, 0.4, c,
1)`` no longer strokes the Hershey font: it draws the embedded TrueType
font Rubik (weight 400) at size 11. Each glyph is rasterised with
coverage antialiasing and no subpixel shift, the pen advances a whole
number of pixels and there is no kerning, so each character is one
coverage bitmap, an offset from the pen and an advance.
``fonts/caption_glyphs.npz`` holds those for the printable ASCII
characters, rendered from OpenCV 5.0.0 by ``tests/make_glyph_table.py``
(see ``fonts/README``). This module is that call for the one (font,
scale, thickness) the package uses; any other raises.

``put_text`` blends each glyph into the image in turn,
``dst = (dst * (255 - a) + color * a + 127) // 255`` per channel, in
place into a u8 [H, W, C] image, and returns it.
"""

from __future__ import annotations

import functools
import os

import numpy as np

FONT_HERSHEY_SIMPLEX = 0
GLYPHS_PATH = os.path.join(os.path.dirname(__file__), "fonts",
                           "caption_glyphs.npz")
# (fontFace, fontScale, thickness) of the only caption call in the package
CAPTION_CALL = (FONT_HERSHEY_SIMPLEX, 0.4, 1)


@functools.lru_cache(maxsize=None)
def glyphs() -> dict:
    """char -> (alpha u8 [h, w], x offset, y offset, advance in pixels);
    the offsets place the bitmap's top left from the pen on the
    baseline."""
    t = np.load(GLYPHS_PATH)
    out, pos = {}, 0
    for ch, (h, w), (x, y), adv in zip(bytes(t["chars"]).decode("ascii"),
                                       t["shape"], t["offset"],
                                       t["advance"]):
        alpha = t["alpha"][pos:pos + h * w].reshape(h, w)
        pos += h * w
        out[ch] = (alpha, int(x), int(y), int(adv))
    return out


def put_text(img: np.ndarray, text: str, org, font_face: int,
             font_scale: float, color, thickness: int = 1) -> np.ndarray:
    """cv2.putText(img, text, org, font_face, font_scale, color,
    thickness) for the one call the package makes (FONT_HERSHEY_SIMPLEX,
    0.4, 1) on a u8 [H, W, C] image, in place; org is the baseline's
    left end (x, y)."""
    key = (int(font_face), float(font_scale), int(thickness))
    if key != CAPTION_CALL:
        raise ValueError(f"put_text draws (FONT_HERSHEY_SIMPLEX, 0.4, 1) "
                         f"only, as OpenCV 5 maps it to its TrueType font; "
                         f"got (font {key[0]}, scale {key[1]}, thickness "
                         f"{key[2]})")
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"put_text draws on u8 [H, W, C] images, got "
                         f"{img.dtype} {img.shape}")
    table = glyphs()
    missing = sorted(set(text) - set(table))
    if missing:
        raise ValueError(f"put_text draws printable ASCII only; got "
                         f"{missing}")
    H, W = img.shape[:2]
    col = np.asarray([int(c) for c in color][:img.shape[2]], np.int32)
    x, base = int(org[0]), int(org[1])
    for ch in text:
        alpha, ix0, iy0, adv = table[ch]
        h, w = alpha.shape
        gx, gy = x + ix0, base + iy0
        x0, y0 = max(gx, 0), max(gy, 0)
        x1, y1 = min(gx + w, W), min(gy + h, H)
        if x0 < x1 and y0 < y1:
            a = alpha[y0 - gy:y1 - gy, x0 - gx:x1 - gx].astype(
                np.int32)[..., None]
            dst = img[y0:y1, x0:x1].astype(np.int32)
            img[y0:y1, x0:x1] = (dst * (255 - a) + col * a + 127) // 255
        x += adv
    return img
