"""Render the caption glyph table of viz/font.py from OpenCV 5's putText.

In OpenCV 5, ``cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, 0.4, c,
1)`` draws its embedded TrueType fonts (Rubik, and WenQuanYi Micro Hei
for the scripts Rubik lacks) at size 11, weight 400. Each glyph is rasterised
with no subpixel shift and blended in turn as
``(dst * (255 - a) + c * a + 127) // 255``, the pen advancing a whole
number of pixels, with no kerning. So every code point is one coverage
bitmap, its offset from the pen and its advance:

* bitmap and offset: the code point drawn alone in white on black, where
  the blend leaves exactly ``a``, trimmed to its ink;
* advance: the one pen step after which the code point followed by "|"
  drawn from the table equals OpenCV's drawing of the pair (the
  generator raises if no step or more than one does).

A code point OpenCV has no glyph for draws the same box (the "tofu"),
controls included; the table keeps the tofu once and every code point
whose drawing differs from it: a scan of the whole BMP and, once, of the
astral planes. Two code points are not glyphs: "\\0" ends the C string
putText receives, and "\\n" starts a new line ``line_step`` pixels down
at the origin's x (after the first drawn character; leading "\\n" are
skipped), which the generator fits from OpenCV's drawing of "a\\nb".

Run with OpenCV 5.0.0 installed (about two minutes, most of it the
astral scan):

    python tests/make_glyph_table.py slam_maskrcnn_tpu_torch/viz/fonts/caption_glyphs.npz
"""

import sys

import cv2
import numpy as np

ORG = (24, 40)
CANVAS = (64, 96)
TOFU_PROBE = 0xE000             # a private-use code point: the tofu
NOT_GLYPHS = (0x00, 0x0A)       # the string's end and the line break
SURROGATES = range(0xD800, 0xE000)
BMP = range(0x10000)
ASTRAL = range(0x10000, 0x110000)


def _draw(text: str) -> np.ndarray:
    img = np.zeros(CANVAS + (3,), np.uint8)
    cv2.putText(img, text, ORG, cv2.FONT_HERSHEY_SIMPLEX, 0.4,
                (255, 255, 255), 1)
    return img[:, :, 0]


def _ink(ch: str):
    """(alpha [h, w] u8, x offset, y offset) of ch drawn alone."""
    a = _draw(ch)
    ys, xs = np.nonzero(a)
    if not len(ys):
        return np.zeros((0, 0), np.uint8), 0, 0
    y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
    if min(y0, x0) == 0 or y1 == CANVAS[0] or x1 == CANVAS[1]:
        raise ValueError(f"U+{ord(ch):04X}: ink reaches the canvas edge")
    return a[y0:y1, x0:x1].copy(), int(x0 - ORG[0]), int(y0 - ORG[1])


def _blend(glyphs) -> np.ndarray:
    """Draw [(alpha, x, y)] in turn, in white on black, as putText."""
    img = np.zeros(CANVAS, np.int32)
    for alpha, x, y in glyphs:
        h, w = alpha.shape
        if h and w:
            x, y = ORG[0] + x, ORG[1] + y
            alpha = alpha.astype(np.int32)
            dst = img[y:y + h, x:x + w]
            img[y:y + h, x:x + w] = (dst * (255 - alpha) + 255 * alpha
                                     + 127) // 255
    return img.astype(np.uint8)


def drawn(codepoints) -> list:
    """The code points among ``codepoints`` whose drawing alone differs
    from the tofu (surrogates and NOT_GLYPHS left out)."""
    tofu = _draw(chr(TOFU_PROBE))
    return [c for c in codepoints
            if c not in SURROGATES and c not in NOT_GLYPHS
            and not np.array_equal(_draw(chr(c)), tofu)]


def render(codepoints) -> dict:
    """The table's arrays for the tofu and ``codepoints`` (ascending):
    {"codepoint" (int32, -1 for the tofu, first), "alpha" (the bitmaps
    flattened and joined), "shape" [n, 2] (h, w), "offset" [n, 2] (x, y
    from the pen on the baseline), "advance" [n]}."""
    chars = [chr(TOFU_PROBE)] + [chr(c) for c in codepoints]
    ink = [_ink(ch) for ch in chars]
    bar = _ink("|")
    advance = []
    for ch, (alpha, x, y) in zip(chars, ink):
        want = _draw(ch + "|")
        fits = [adv for adv in range(0, 32) if np.array_equal(
            _blend([(alpha, x, y), (bar[0], bar[1] + adv, bar[2])]), want)]
        if len(fits) != 1:
            raise ValueError(f"U+{ord(ch):04X}: pen steps {fits} reproduce "
                             f"OpenCV's drawing of it followed by '|'")
        advance.append(fits[0])
    return {
        "codepoint": np.asarray([-1] + list(codepoints), np.int32),
        "alpha": np.concatenate([a.ravel() for a, _, _ in ink]),
        "shape": np.asarray([a.shape for a, _, _ in ink], np.uint8),
        "offset": np.asarray([(x, y) for _, x, y in ink], np.int8),
        "advance": np.asarray(advance, np.uint8),
    }


def line_step() -> int:
    """The baseline step of "\\n": the one step at which "a" and "b" drawn
    on two lines equal OpenCV's drawing of "a\\nb"."""
    a, b = _ink("a"), _ink("b")
    want = _draw("a\nb")
    fits = [s for s in range(1, 24) if np.array_equal(
        _blend([a, (b[0], b[1], b[2] + s)]), want)]
    if len(fits) != 1:
        raise ValueError(f"line steps {fits} reproduce OpenCV's 'a\\nb'")
    return fits[0]


def glyph_table() -> dict:
    """render() of every drawn code point, and the line step."""
    out = render(drawn(BMP) + drawn(ASTRAL))
    out["line_step"] = np.int32(line_step())
    return out


if __name__ == "__main__":
    np.savez_compressed(sys.argv[1], **glyph_table())
