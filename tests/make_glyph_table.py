"""Render the caption glyph table of viz/font.py from OpenCV 5's putText.

In OpenCV 5, ``cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, 0.4, c,
1)`` draws its embedded TrueType font Rubik at size 11, weight 400. Each
glyph is rasterised with no subpixel shift and blended in turn as
``(dst * (255 - a) + c * a + 127) // 255``, the pen advancing a whole
number of pixels, with no kerning. So every printable ASCII character is
one coverage bitmap, its offset from the pen and its advance:

* bitmap and offset: the character drawn alone in white on black, where
  the blend leaves exactly ``a``, trimmed to its ink;
* advance: the one pen step after which the character followed by "|"
  drawn from the table equals OpenCV's drawing of the pair.

Run with OpenCV 5.0.0 installed:

    python tests/make_glyph_table.py slam_maskrcnn_tpu_torch/viz/fonts/caption_glyphs.npz
"""

import sys

import cv2
import numpy as np

CHARS = "".join(chr(c) for c in range(32, 127))
ORG = (24, 40)
CANVAS = (64, 96)


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


def glyph_table() -> dict:
    """{"chars", "alpha" (the bitmaps flattened and joined), "shape",
    "offset" (x, y from the pen on the baseline), "advance"}."""
    ink = {ch: _ink(ch) for ch in CHARS}
    bar = ink["|"]
    advance = []
    for ch in CHARS:
        want = _draw(ch + "|")
        fits = [adv for adv in range(0, 24) if np.array_equal(
            _blend([ink[ch], (bar[0], bar[1] + adv, bar[2])]), want)]
        if len(fits) != 1:
            raise ValueError(f"{ch!r}: pen steps {fits} reproduce "
                             f"OpenCV's drawing of {ch + '|'!r}")
        advance.append(fits[0])
    return {
        "chars": np.frombuffer(CHARS.encode("ascii"), np.uint8).copy(),
        "alpha": np.concatenate([ink[ch][0].ravel() for ch in CHARS]),
        "shape": np.asarray([ink[ch][0].shape for ch in CHARS], np.int32),
        "offset": np.asarray([ink[ch][1:] for ch in CHARS], np.int32),
        "advance": np.asarray(advance, np.int32),
    }


if __name__ == "__main__":
    np.savez_compressed(sys.argv[1], **glyph_table())
