"""The port's training data pipeline (data/dataset.py) against the JAX
package's on the CPU: data_generator batches for two seeds, with and
without the legacy fliplr augment, bit for bit (the generator's own rng
and numpy's global stream seeded alike on both sides); the 5-error skip;
load_image_gt in the "crop" mode; resize_mask (cv2 INTER_NEAREST) and
minimize_mask (cv2 INTER_LINEAR) against the JAX package's cv2 calls;
image meta compose/parse. Bar: bit-equal."""

import logging

import numpy as np
import pytest

from slam_maskrcnn_tpu.data import dataset as jds
from slam_maskrcnn_tpu.data.shapes import ShapesConfig as JShapesConfig
from slam_maskrcnn_tpu.data.shapes import ShapesDataset as JShapes
from slam_maskrcnn_tpu.models import meta as jmeta
from slam_maskrcnn_tpu_torch.data import dataset as tds
from slam_maskrcnn_tpu_torch.data.shapes import ShapesConfig, ShapesDataset
from slam_maskrcnn_tpu_torch.models import meta as tmeta


def _cfgs(**over):
    base = dict(NAME="shapes_gen", IMAGES_PER_GPU=3, MAX_GT_INSTANCES=2,
                RPN_TRAIN_ANCHORS_PER_IMAGE=64)
    base.update(over)
    return (type("J", (JShapesConfig,), base)(),
            type("T", (ShapesConfig,), base)())


def _pair(n, seed, size=128, bad=()):
    """The JAX and the port shapes datasets; images in ``bad`` raise."""
    class JBad(JShapes):
        def load_image(self, image_id):
            if image_id in bad:
                raise OSError(f"unreadable {image_id}")
            return super().load_image(image_id)

    class TBad(ShapesDataset):
        def load_image(self, image_id):
            if image_id in bad:
                raise OSError(f"unreadable {image_id}")
            return super().load_image(image_id)

    out = []
    for cls in (JBad, TBad):
        d = cls()
        d.load_shapes(n, size, size, seed=seed)
        d.prepare()
        out.append(d)
    return out


@pytest.mark.parametrize("seed,augment", [(0, False), (0, True),
                                          (5, False), (5, True)])
def test_data_generator_matches_jax(seed, augment):
    """Four batches of three (a shuffle per pass over the 7 images; at most
    2 gt per image, so a 3-shape image has its gt subsampled)."""
    jcfg, tcfg = _cfgs()
    jd, td = _pair(7, seed + 1)
    np.random.seed(seed)
    jb = [b for _, b in zip(range(4), jds.data_generator(
        jd, jcfg, augment=augment, seed=seed))]
    np.random.seed(seed)
    tb = [b for _, b in zip(range(4), tds.data_generator(
        td, tcfg, augment=augment, seed=seed))]
    for j, t in zip(jb, tb):
        assert sorted(j) == sorted(t)
        for k in j:
            assert j[k].dtype == t[k].dtype, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert (np.stack([b["rpn_match"] for b in tb]) == 1).sum() > 0
    assert (np.stack([b["gt_class_ids"] for b in tb]) > 0).sum() >= 8


def test_data_generator_error_skip(caplog):
    """Failing images are logged and skipped as in the JAX package; more
    than 5 in a row raise."""
    jcfg, tcfg = _cfgs(IMAGES_PER_GPU=2)
    jd, td = _pair(6, 3, bad=(1, 4))
    np.random.seed(1)
    j = next(jds.data_generator(jd, jcfg, seed=2))
    np.random.seed(1)
    with caplog.at_level(logging.ERROR):
        t = next(tds.data_generator(td, tcfg, seed=2))
    for k in j:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    jd, td = _pair(6, 3, bad=tuple(range(6)))
    for gen in (jds.data_generator(jd, jcfg, seed=2),
                tds.data_generator(td, tcfg, seed=2)):
        with pytest.raises(OSError, match="unreadable"):
            next(gen)


def test_augmentation_raises():
    """An augmentation that changes the image's shape fails the
    Augmenter's shape check (model.py:1263-1265) on every image; as in
    the JAX package, the generator skips 5 and raises on the 6th."""
    from slam_maskrcnn_tpu.data.augment import Augmenter as JAugmenter
    from slam_maskrcnn_tpu_torch.data.augment import Augmenter

    def crop(cls):
        class Crop(cls):
            def apply_image(self, image, params):
                return image[1:]
        return Crop()

    jcfg, tcfg = _cfgs()
    jd, td = _pair(2, 0)
    for gen in (jds.data_generator(jd, jcfg, augmentation=crop(JAugmenter)),
                tds.data_generator(td, tcfg, augmentation=crop(Augmenter))):
        with pytest.raises(AssertionError, match="must not change shape"):
            next(gen)


def test_load_image_gt_crop_mode_matches_jax():
    """IMAGE_RESIZE_MODE "crop": a random 96^2 window of the 128^2 image,
    drawn from numpy's global stream on both sides; masks cropped alike;
    empty ones dropped."""
    jcfg, tcfg = _cfgs(IMAGE_RESIZE_MODE="crop", IMAGE_MIN_DIM=96,
                       USE_MINI_MASK=False)
    jd, td = _pair(6, 9)
    for i in range(6):
        np.random.seed(100 + i)
        j = jds.load_image_gt(jd, jcfg, i)
        np.random.seed(100 + i)
        t = tds.load_image_gt(td, tcfg, i)
        assert t[0].shape == (96, 96, 3)
        for a, b in zip(j, t):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


@pytest.mark.parametrize("scale", [0.37, 0.5, 0.83, 1.0, 1.6, 2.0, 3.3])
def test_resize_and_minimize_mask_match_cv2(scale):
    rng = np.random.default_rng(int(scale * 100))
    H, W, n = 53, 71, 3
    mask = rng.uniform(size=(H, W, n)) < 0.4
    padding = [(2, 3), (4, 1), (0, 0)]
    np.testing.assert_array_equal(
        tds.resize_mask(mask, scale, padding),
        jds.resize_mask(mask, scale, padding))
    np.testing.assert_array_equal(
        tds.resize_mask(mask[:, :, :1], scale, padding),
        jds.resize_mask(mask[:, :, :1], scale, padding))
    boxes = np.array([[3, 5, 40, 60], [10, 0, 53, 20], [0, 30, 7, 71]])
    for shape in ((56, 56), (28, 40)):
        np.testing.assert_array_equal(
            tds.minimize_mask(boxes, mask, shape),
            jds.minimize_mask(boxes, mask, shape))
    np.testing.assert_array_equal(tds.extract_bboxes(mask),
                                  jds.extract_bboxes(mask))


def test_image_meta_round_trip_matches_jax():
    args = (7, (480, 640, 3), (1024, 1024, 3), (128, 0, 896, 1024), 1.6,
            np.array([1, 0, 1, 1]))
    m = tmeta.compose_image_meta(*args)
    np.testing.assert_array_equal(m, jmeta.compose_image_meta(*args))
    jp, tp = jmeta.parse_image_meta(m[None]), tmeta.parse_image_meta(m[None])
    for k in jp:
        np.testing.assert_array_equal(tp[k], jp[k])
