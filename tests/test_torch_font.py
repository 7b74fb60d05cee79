"""The port's caption text (viz/font.py and its glyph table) against OpenCV 5's
``cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, 0.4, color, 1)`` on
the CPU: every COCO class name, "{:.3f}" scores and "0.91 / 0.73" forms,
on flat and textured backgrounds in random colours, text clipped at all
four borders. The bar is bit-equality."""

import cv2
import numpy as np
import pytest
from make_glyph_table import glyph_table

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
    with pytest.raises(ValueError, match="printable ASCII"):
        font.put_text(img, "caf\u00e9", (0, 10), font.FONT_HERSHEY_SIMPLEX,
                      0.4, (255, 0, 0), 1)


def test_font_file_is_opencvs_rubik():
    """The committed glyph table is this OpenCV's rendering of its Rubik
    at size 11, weight 400: every printable ASCII character."""
    want = glyph_table()
    got = np.load(font.GLYPHS_PATH)
    assert sorted(got.files) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(font.glyphs()) == 95
