"""The port's cv2-free drawing (data/draw.py) against cv2 on the CPU, and
its ShapesDataset against the JAX package's: the filled rectangle and
circle over seeded sizes and positions, clipped at every image border or
not; the filled triangles of the shapes dataset, those that cross the
border included; and the dataset's images, masks and class ids for a few
seeds. Bar: bit-equal."""

import cv2
import numpy as np
import pytest

from slam_maskrcnn_tpu.data.shapes import ShapesDataset as JShapes
from slam_maskrcnn_tpu_torch.data import draw
from slam_maskrcnn_tpu_torch.data.shapes import ShapesDataset


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rectangle_and_circle_match_cv2(seed):
    rng = np.random.default_rng(seed)
    clipped = 0
    for _ in range(400):
        H, W = int(rng.integers(8, 160)), int(rng.integers(8, 160))
        x, y = int(rng.integers(-40, W + 40)), int(rng.integers(-40, H + 40))
        s = int(rng.integers(0, 70))
        c = tuple(int(v) for v in rng.integers(0, 256, 3))
        clipped += not (0 <= x - s and x + s < W and 0 <= y - s
                        and y + s < H)
        for want_fn, got_fn in (
                (lambda a: cv2.rectangle(a, (x - s, y - s), (x + s, y + s),
                                         c, -1),
                 lambda a: draw.rectangle(a, (x - s, y - s), (x + s, y + s),
                                          c)),
                (lambda a: cv2.circle(a, (x, y), s, c, -1),
                 lambda a: draw.circle(a, (x, y), s, c))):
            a = np.zeros((H, W, 3), np.uint8)
            b = a.copy()
            want_fn(a)
            got_fn(b)
            np.testing.assert_array_equal(b, a)
    assert clipped > 100


@pytest.mark.parametrize("size", [96, 128, 256])
def test_dataset_triangles_match_cv2(size):
    """Triangles as ShapesDataset draws them (apex up, sides at 60
    degrees, vertices truncated to int), centres and sizes over the
    dataset's whole range at this image size: a quarter of them cross
    the left, right or bottom border."""
    rng = np.random.default_rng(size)
    clipped = 0
    for _ in range(1500):
        y = int(rng.integers(20, size - 21))
        x = int(rng.integers(20, size - 21))
        s = int(rng.integers(20, size // 4))
        pts = np.array([[(x, y - s),
                         (x - s / np.sin(np.radians(60)), y + s),
                         (x + s / np.sin(np.radians(60)), y + s)]], np.int32)
        clipped += bool((pts[..., 0] < 0).any() or (pts[..., 0] >= size).any()
                        or (pts[..., 1] >= size).any())
        a = np.zeros((size, size, 3), np.uint8)
        b = a.copy()
        cv2.fillPoly(a, pts, (7, 100, 250))
        draw.fill_poly(b, pts, (7, 100, 250))
        np.testing.assert_array_equal(b, a)
        m1 = np.zeros((size, size, 1), np.uint8)
        m2 = m1.copy()
        cv2.fillPoly(m1, pts, 1)
        draw.fill_poly(m2, pts, 1)
        np.testing.assert_array_equal(m2, m1)
    assert clipped > 100


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_shapes_dataset_matches_jax(seed):
    jd, td = JShapes(), ShapesDataset()
    jd.load_shapes(12, 128, 128, seed=seed)
    td.load_shapes(12, 128, 128, seed=seed)
    jd.prepare()
    td.prepare()
    assert td.class_names == jd.class_names
    assert td.source_class_ids == jd.source_class_ids
    n_shapes = 0
    for i in td.image_ids:
        np.testing.assert_array_equal(td.load_image(i), jd.load_image(i))
        tm, tc = td.load_mask(i)
        jm, jc = jd.load_mask(i)
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_array_equal(tc, jc)
        n_shapes += len(tc)
    assert n_shapes >= 12
