"""Caption text as OpenCV 5's ``putText`` draws it, without cv2.

In OpenCV 5, ``cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, 0.4, c,
1)`` no longer strokes the Hershey font: it draws its embedded TrueType
fonts (Rubik, weight 400, and WenQuanYi Micro Hei for the scripts Rubik
lacks) at size 11. Each glyph is rasterised with coverage antialiasing
and no subpixel shift, the pen advances a whole number of pixels and
there is no kerning, so each code point is one coverage bitmap, an
offset from the pen and an advance. ``fonts/caption_glyphs.npz`` holds
those for every code point OpenCV 5.0.0 draws a glyph for (34,908 of the
BMP, 6 astral), plus the "?" box ("tofu") it draws for every other code
point, controls included, rendered by
``tests/make_glyph_table.py`` (see ``fonts/README``). This module is that
call for the one (font, scale, thickness) the package uses; any other
raises.

``put_text`` blends each glyph into the image in turn,
``dst = (dst * (255 - a) + color * a + 127) // 255`` per channel, in
place into a u8 [H, W, C] image, and returns it. As in putText, "\\0"
ends the text and "\\n" starts a new line ``line_step`` pixels down at
the origin's x, except before the first character (leading "\\n" are
skipped). A lone surrogate, which cv2 cannot encode, raises.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np

FONT_HERSHEY_SIMPLEX = 0
GLYPHS_PATH = os.path.join(os.path.dirname(__file__), "fonts",
                           "caption_glyphs.npz")
# (fontFace, fontScale, thickness) of the only caption call in the package
CAPTION_CALL = (FONT_HERSHEY_SIMPLEX, 0.4, 1)


class GlyphTable(NamedTuple):
    """codepoint [n] ascending after the tofu's -1 at index 0; alpha the
    bitmaps joined, glyph i at start[i] with shape[i] (h, w); offset [n, 2]
    (x, y of the bitmap's top left from the pen on the baseline); advance
    [n] in pixels; line_step the baseline step of "\\n"."""
    codepoint: np.ndarray
    alpha: np.ndarray
    start: np.ndarray
    shape: np.ndarray
    offset: np.ndarray
    advance: np.ndarray
    line_step: int


@functools.lru_cache(maxsize=None)
def table() -> GlyphTable:
    t = np.load(GLYPHS_PATH)
    shape = t["shape"].astype(np.int64)
    start = np.concatenate([[0], np.cumsum(shape[:, 0] * shape[:, 1])])
    return GlyphTable(t["codepoint"], t["alpha"], start, shape,
                      t["offset"].astype(np.int64),
                      t["advance"].astype(np.int64), int(t["line_step"]))


def glyph(ch: str):
    """(alpha u8 [h, w], x offset, y offset, advance) that putText draws
    for the character ch: its own glyph, or the tofu."""
    t = table()
    cp = ord(ch)
    if 0xD800 <= cp < 0xE000:
        raise ValueError(f"put_text: a lone surrogate U+{cp:04X} is not "
                         f"text (cv2 cannot encode it)")
    i = int(np.searchsorted(t.codepoint[1:], cp)) + 1
    if i >= len(t.codepoint) or t.codepoint[i] != cp:
        i = 0
    h, w = t.shape[i]
    alpha = t.alpha[t.start[i]:t.start[i] + h * w].reshape(h, w)
    return alpha, int(t.offset[i, 0]), int(t.offset[i, 1]), \
        int(t.advance[i])


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
    text = text.split("\0", 1)[0].lstrip("\n")
    glyphs = [None if ch == "\n" else glyph(ch) for ch in text]
    H, W = img.shape[:2]
    col = np.asarray([int(c) for c in color][:img.shape[2]], np.int32)
    x, base = int(org[0]), int(org[1])
    for g in glyphs:
        if g is None:
            x, base = int(org[0]), base + table().line_step
            continue
        alpha, ix0, iy0, adv = g
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
