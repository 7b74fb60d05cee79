"""The port's caption text (viz/font.py and its glyph table) against OpenCV 5's
``cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, 0.4, color, 1)`` on
the CPU: every COCO class name, "{:.3f}" scores and "0.91 / 0.73" forms;
captions beyond ASCII (Latin-1 and Latin Extended, Greek, Cyrillic, CJK,
Hangul, Hebrew, Arabic, combining marks, symbols; controls and astral
code points, which draw the tofu); "\\n" and "\\0"; on flat and textured
backgrounds in random colours, text clipped at all four borders. The bar
is bit-equality."""

import zlib

import cv2
import numpy as np
import make_glyph_table
import pytest

from slam_maskrcnn_tpu.samples.coco import COCO_CLASS_NAMES
from slam_maskrcnn_tpu_torch.viz import font

SHAPES_NAMES = ("BG", "square", "circle", "triangle")


def _check(texts, seed, textured, orgs=None, size=(36, 220)):
    rng = np.random.default_rng(seed)
    for k, t in enumerate(texts):
        if textured:
            bg = rng.integers(0, 256, size + (3,), dtype=np.uint8)
        else:
            bg = np.full(size + (3,), rng.integers(0, 256, 3), np.uint8)
        col = tuple(int(v) for v in rng.integers(0, 256, 3))
        org = orgs[k % len(orgs)] if orgs else (int(rng.integers(0, 20)),
                                                int(rng.integers(10, 30)))
        want = cv2.putText(bg.copy(), t, org, cv2.FONT_HERSHEY_SIMPLEX, 0.4,
                           col, 1)
        got = font.put_text(bg.copy(), t, org, font.FONT_HERSHEY_SIMPLEX,
                            0.4, col, 1)
        np.testing.assert_array_equal(got, want, err_msg=f"{t!r} at {org}")


@pytest.mark.parametrize("textured", [False, True])
def test_class_names(textured):
    _check(list(COCO_CLASS_NAMES) + list(SHAPES_NAMES), 0, textured)


@pytest.mark.parametrize("textured", [False, True])
def test_scored_captions(textured):
    rng = np.random.default_rng(1)
    texts = ["{} {:.3f}".format(n, s) for n, s in
             zip(COCO_CLASS_NAMES, rng.random(len(COCO_CLASS_NAMES)))]
    texts += ["{:.2f} / {:.2f}".format(a, b) for a, b in rng.random((20, 2))]
    texts += ["0.91 / 0.73", "1.00 / 0.00", "person 1.000", "0123456789"]
    _check(texts, 2, textured)


def test_clipped_at_every_border():
    texts = ["person 0.987", "traffic light 0.512", "0.91 / 0.73", "dog"]
    orgs = [(-7, 12), (-40, 20), (30, 3), (30, -2), (30, 38), (30, 44),
            (150, 20), (200, 30), (-300, 20), (5, 100)]
    _check(texts * 3, 3, True, orgs=orgs, size=(40, 180))


def test_only_the_packages_call_is_drawn():
    img = np.zeros((20, 40, 3), np.uint8)
    for face, scale, th in ((font.FONT_HERSHEY_SIMPLEX, 0.5, 1),
                            (font.FONT_HERSHEY_SIMPLEX, 0.4, 2), (1, 0.4, 1)):
        with pytest.raises(ValueError, match="FONT_HERSHEY_SIMPLEX, 0.4, 1"):
            font.put_text(img, "x", (0, 10), face, scale, (255, 0, 0), th)
    with pytest.raises(ValueError, match="u8"):
        font.put_text(img.astype(np.float32), "x", (0, 10),
                      font.FONT_HERSHEY_SIMPLEX, 0.4, (255, 0, 0), 1)
    # a lone surrogate is no text: cv2 cannot encode it (and crashes)
    with pytest.raises(ValueError, match="surrogate"):
        font.put_text(img, "caf\ud800", (0, 10), font.FONT_HERSHEY_SIMPLEX,
                      0.4, (255, 0, 0), 1)


def _sample(lo, hi, n, seed):
    """n code points of [lo, hi) drawn with a seed."""
    return sorted(set(np.random.default_rng(seed).integers(lo, hi, n)
                      .tolist()))


# a seeded sample of CJK ideographs and Hangul syllables, and the astral
# code points the table keeps (all of them)
CJK = _sample(0x4E00, 0xA000, 160, 7)
HANGUL = _sample(0xAC00, 0xD7A4, 120, 8)


def test_font_file_is_opencvs_rubik():
    """The committed glyph table is this OpenCV's rendering: the same kept
    code points and entries for everything up to U+04FF (Latin, Greek,
    Cyrillic and the controls, which draw the tofu), for a seeded sample
    of CJK and Hangul, and for its astral glyphs; the same tofu and line
    step."""
    t = np.load(font.GLYPHS_PATH)
    assert sorted(t.files) == ["advance", "alpha", "codepoint", "line_step",
                               "offset", "shape"]
    cps = t["codepoint"]
    assert cps[0] == -1 and np.all(np.diff(cps[1:]) > 0)
    low = cps[(cps >= 0) & (cps < 0x500)].tolist()
    assert low == make_glyph_table.drawn(range(0x500))
    assert set(make_glyph_table.drawn(CJK + HANGUL)) <= set(cps.tolist())
    astral = cps[cps >= 0x10000].tolist()
    assert make_glyph_table.drawn(astral) == astral
    for part in (low, CJK + HANGUL, astral):
        want = make_glyph_table.render(part)
        tbl = font.table()
        idx = [0] + [int(np.searchsorted(cps, c)) for c in part]
        np.testing.assert_array_equal(cps[idx], want["codepoint"])
        for k in ("shape", "offset", "advance"):
            np.testing.assert_array_equal(t[k][idx], want[k], err_msg=k)
        got = np.concatenate([tbl.alpha[tbl.start[i]:tbl.start[i + 1]]
                              for i in idx])
        np.testing.assert_array_equal(got, want["alpha"])
    assert int(t["line_step"]) == make_glyph_table.line_step()
    # coverage: the BMP's 34,908 glyphs; ASCII as before, but "?", which
    # is OpenCV's tofu
    assert ((cps >= 0) & (cps < 0x10000)).sum() == 34908
    assert set(range(32, 127)) - set(cps.tolist()) == {ord("?")}


SCRIPTS = {
    "latin1": "".join(map(chr, range(0xA0, 0x100))),
    "latin_ext": "".join(map(chr, range(0x100, 0x250))),
    "greek_cyrillic": "".join(map(chr, range(0x370, 0x500))),
    "cjk_hangul": "".join(map(chr, CJK + HANGUL)),
    "combining": "a\u0301e\u0300o\u0308n\u0303 \u0300x",
    "controls": "".join(map(chr, list(range(1, 10)) + list(range(11, 32))
                            + list(range(0x7F, 0xA0)))),
    "arabic_hebrew": "".join(map(chr, range(0x5D0, 0x5EB)))
    + "".join(map(chr, range(0x621, 0x64B))),
    "symbols": "\u2190\u2192\u221e\u2264\u20ac\u00b0\u2122\ufffd\ufeff"
    "\u200b\u2003\U0001F600\U00010000\U0010FFFD",
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_beyond_ascii(script):
    """Captions of each script, cut into words of 1-12 code points, on
    textured and flat backgrounds, against cv2.putText bit for bit."""
    chars = SCRIPTS[script]
    rng = np.random.default_rng(zlib.crc32(script.encode()))
    texts, pos = [], 0
    while pos < len(chars):
        n = int(rng.integers(1, 13))
        texts.append(chars[pos:pos + n])
        pos += n
    _check(texts, 11, True, size=(40, 260))
    _check(texts[:8], 12, False, size=(40, 260))


def test_newline_and_nul():
    """"\n" starts a line 14 pixels down at the origin's x, after the first
    character (leading ones are skipped); "\0" ends the text."""
    texts = ["a\nb", "ab\ncd\nef", "\n\nx", "\nx\ny", "a\n\nb", "a\n",
             " \nb", "\u4eba\nb", "caf\u00e9\n\u0436", "a\0b", "\0a",
             "x\n\0y"]
    _check(texts, 13, True, size=(70, 120),
           orgs=[(5, 12), (30, 20), (-3, 60), (60, 30)])


def test_display_instances_non_ascii_class_names():
    """display_instances with the class names "caf\u00e9", "\u0436" and
    "\u4eba" (and their scores) equals the JAX display_instances."""
    import matplotlib
    matplotlib.use("Agg")
    from slam_maskrcnn_tpu.viz import visualize as jv
    from slam_maskrcnn_tpu_torch.viz import visualize as tv

    names = ["BG", "caf\u00e9", "\u0436", "\u4eba"]
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (90, 120, 3), dtype=np.uint8)
    boxes = np.asarray([[0, 0, 40, 60], [30, 20, 80, 90], [50, 70, 89, 119]],
                       np.int32)
    masks = np.zeros((90, 120, 3), bool)
    for i, (y1, x1, y2, x2) in enumerate(boxes):
        masks[y1 + 3:y2 - 3, x1 + 3:x2 - 3, i] = True
    ids = np.asarray([1, 2, 3], np.int32)
    scores = np.asarray([0.91, 0.734, 0.5], np.float32)
    colors = jv.random_colors(3, seed=5)
    for kw in (dict(scores=scores), dict(scores=None),
               dict(scores=scores, captions=["\u4eba 0.9", "ж\nx", "é"])):
        t = tv.display_instances(img, boxes, masks, ids, names,
                                 colors=colors, show=False, **kw)
        j = jv.display_instances(img, boxes, masks, ids, names,
                                 colors=colors, show=False, **kw)
        np.testing.assert_array_equal(t, j, err_msg=str(kw))
