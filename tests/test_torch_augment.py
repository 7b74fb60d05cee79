"""The port's Augmenter (data/augment.py) and its cv2-free geometry and
filters (ops/warp.py, ops/blur.py, data/draw.py ``fill_poly``) against cv2
5 and the JAX package's data/augment.py on the CPU.

Bar: bit-equal everywhere: ``getRotationMatrix2D``; ``warpAffine`` with
INTER_NEAREST on 1-5 channels and INTER_LINEAR on 1, 3 and 4 (u8 and
f32), random rotations, scales, shears and shifts; ``GaussianBlur`` on u8
with the Augmenter's kernel sizes, small images included (the border
reflects more than once); ``cvtColor(RGB2GRAY)``; ``fillPoly`` on random
concave, self-intersecting and out-of-image polygons; every augmenter and
the compositions, image and mask, for the same numpy Generator seed as
the JAX package's; data_generator batches with an Augmenter; and one
``Trainer.train`` step with ``augmentation=`` whose batch equals the JAX
generator's."""

import cv2
import numpy as np
import pytest
import torch

from slam_maskrcnn_tpu.data import augment as jaug
from slam_maskrcnn_tpu.data import dataset as jds
from slam_maskrcnn_tpu.data.shapes import ShapesConfig as JShapesConfig
from slam_maskrcnn_tpu.data.shapes import ShapesDataset as JShapes
from slam_maskrcnn_tpu_torch.data import augment as taug
from slam_maskrcnn_tpu_torch.data import dataset as tds
from slam_maskrcnn_tpu_torch.data import draw
from slam_maskrcnn_tpu_torch.data.shapes import ShapesConfig, ShapesDataset
from slam_maskrcnn_tpu_torch.ops import blur, warp

torch.set_num_threads(2)


def _affine(rng, H, W):
    """A random rotation / scale / shear / shift about the centre, as the
    Augmenter's Affine composes them."""
    M = cv2.getRotationMatrix2D((W / 2.0, H / 2.0), rng.uniform(-180, 180),
                                rng.uniform(0.5, 1.5))
    sh = np.tan(np.deg2rad(rng.uniform(-20, 20)))
    S = np.array([[1.0, sh, -sh * H / 2.0], [0.0, 1.0, 0.0]])
    M = (np.vstack([S, [0, 0, 1]]) @ np.vstack([M, [0, 0, 1]]))[:2]
    M[:, 2] += rng.uniform(-6, 6, 2)
    return M


def test_rotation_matrix_matches_cv2():
    rng = np.random.default_rng(0)
    for k in range(3000):
        w, h = (int(v) for v in rng.integers(1, 2000, 2))
        ang = (float(rng.uniform(-360, 360)) if k % 3
               else float(rng.choice([0, 90, 180, 270, -90])))
        sc = float(rng.uniform(0.2, 3.0)) if k % 2 else 1.0
        np.testing.assert_array_equal(
            warp.rotation_matrix((w / 2.0, h / 2.0), ang, sc),
            cv2.getRotationMatrix2D((w / 2.0, h / 2.0), ang, sc))


@pytest.mark.parametrize("channels", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_warp_affine_matches_cv2(channels, dtype):
    """Nearest on every channel count (OpenCV 5's float path on 1, 3, 4,
    the fixed-point remap on the others), linear on 1, 3, 4; sizes on
    both sides of the 16-pixel vector, so rows end in a tail."""
    rng = np.random.default_rng(channels * 10 + (dtype == np.uint8))
    for _ in range(40):
        H, W = (int(v) for v in rng.integers(3, 150, 2))
        src = rng.integers(0, 256, (H, W, channels)).astype(dtype)
        if channels == 1:
            src = src[..., 0]
        M = _affine(rng, H, W)
        flags = ((cv2.INTER_NEAREST, cv2.INTER_LINEAR)
                 if channels in (1, 3, 4) else (cv2.INTER_NEAREST,))
        for f in flags:
            np.testing.assert_array_equal(
                warp.warp_affine(src, M, (W, H), f),
                cv2.warpAffine(src, M, (W, H), flags=f), err_msg=str(f))


def test_warp_affine_quarter_turns():
    """Affine(rotate=90/180/270) as the nucleus augmentation draws them,
    on square and odd-sized images (half-pixel centres)."""
    rng = np.random.default_rng(4)
    for H, W in ((512, 512), (97, 64), (33, 35)):
        img = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
        mask = (rng.random((H, W, 2)) < 0.3).astype(np.uint8)
        for rot in (90, 180, 270):
            M = cv2.getRotationMatrix2D((W / 2.0, H / 2.0), rot, 1.0)
            np.testing.assert_array_equal(
                warp.warp_affine(img, M, (W, H), warp.INTER_LINEAR),
                cv2.warpAffine(img, M, (W, H), flags=cv2.INTER_LINEAR))
            np.testing.assert_array_equal(
                warp.warp_affine(mask, M, (W, H), warp.INTER_NEAREST),
                cv2.warpAffine(mask, M, (W, H), flags=cv2.INTER_NEAREST))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gaussian_blur_and_gray_match_cv2(seed):
    rng = np.random.default_rng(seed)
    for k in range(60):
        H, W = (int(v) for v in rng.integers(2, 90, 2))
        img = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
        if k % 2:
            img = img[..., 0]
        s = float(rng.uniform(0.05, 5.0))
        ks = max(3, int(2 * round(3 * s) + 1))
        np.testing.assert_array_equal(blur.gaussian_blur(img, ks, s),
                                      cv2.GaussianBlur(img, (ks, ks), s))
    img = rng.integers(0, 256, (300, 300, 3)).astype(np.uint8)
    np.testing.assert_array_equal(blur.rgb_to_gray(img),
                                  cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))


@pytest.mark.parametrize("mode", ["anywhere", "star", "overhang", "inside"])
def test_fill_poly_general_matches_cv2(mode):
    """Concave and self-intersecting polygons of 3-80 vertices: far
    outside the image, star-shaped around a centre near or past the
    border, overhanging every border, or inside."""
    rng = np.random.default_rng(["anywhere", "star", "overhang",
                                 "inside"].index(mode))
    outside = 0
    for k in range(250):
        H, W = (int(v) for v in rng.integers(4, 200, 2))
        nv = int(rng.integers(3, 80))
        if mode == "anywhere":
            pts = np.stack([rng.integers(-3 * W, 4 * W, nv),
                            rng.integers(-3 * H, 4 * H, nv)], -1)
        elif mode == "star":
            cx, cy = rng.uniform(-0.3, 1.3) * W, rng.uniform(-0.3, 1.3) * H
            th = np.sort(rng.uniform(0, 2 * np.pi, nv))
            r = rng.uniform(0.1, 0.8, nv) * max(H, W)
            pts = np.round(np.stack([cx + r * np.cos(th),
                                     cy + r * np.sin(th)], -1))
        elif mode == "overhang":
            pts = np.stack([rng.integers(-W // 3, W + W // 3, nv),
                            rng.integers(-H // 3, H + H // 3, nv)], -1)
        else:
            pts = np.stack([rng.integers(0, W, nv),
                            rng.integers(0, H, nv)], -1)
        pts = pts.astype(np.int32)
        outside += bool((pts < 0).any() or (pts[:, 0] >= W).any()
                        or (pts[:, 1] >= H).any())
        color = (1,) if k % 2 else (5, 200, 17)
        a = np.zeros((H, W, len(color)), np.uint8)
        b = a.copy()
        cv2.fillPoly(a, [pts], color)
        draw.fill_poly(b, pts, color)
        np.testing.assert_array_equal(b, a)
    assert mode == "inside" or outside > 100


def _image_mask(seed, H=96, W=128, n=3):
    """A noise image with n rectangular instance masks (the red channel
    brightened over them)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(20, 200, (H, W, 3)).astype(np.uint8)
    mask = np.zeros((H, W, n), bool)
    for i in range(n):
        y, x = rng.integers(0, H - 20), rng.integers(0, W - 20)
        h, w = rng.integers(10, 40, 2)
        mask[y:y + h, x:x + w, i] = True
    img[..., 0][mask.any(-1)] = 250
    return img, mask


def _pair(build):
    """The same augmenter built from each package's classes."""
    return build(jaug), build(taug)


AUGMENTERS = {
    "fliplr": lambda m: m.Fliplr(0.5),
    "flipud": lambda m: m.Flipud(0.5),
    "affine": lambda m: m.Affine(rotate=(-30, 30), scale=(0.8, 1.2),
                                 translate_percent=(-0.1, 0.1),
                                 shear=(-8, 8)),
    "rot90": lambda m: m.Affine(rotate=90),
    "crop_and_pad": lambda m: m.CropAndPad(percent=(-0.2, 0.2)),
    "multiply": lambda m: m.Multiply((0.5, 1.5)),
    "noise": lambda m: m.AdditiveGaussianNoise((2.0, 12.0)),
    "blur": lambda m: m.GaussianBlur((0.0, 5.0)),
    "sequential": lambda m: m.Sequential([
        m.Fliplr(0.5), m.Sometimes(0.8, m.Affine(rotate=(-15, 15))),
        m.OneOf([m.Multiply((0.8, 1.2)), m.GaussianBlur((0.5, 1.5))]),
        m.SomeOf(1, [m.Flipud(1.0), m.CropAndPad((-0.1, 0.1))])]),
    "nucleus": lambda m: m.SomeOf(2, [
        m.Fliplr(0.5), m.Flipud(0.5),
        m.OneOf([m.Affine(rotate=90), m.Affine(rotate=180),
                 m.Affine(rotate=270)]),
        m.Multiply((0.8, 1.5)), m.GaussianBlur((0.0, 5.0))]),
}


@pytest.mark.parametrize("name", sorted(AUGMENTERS))
@pytest.mark.parametrize("n", [1, 2, 4])
def test_augmenter_matches_jax(name, n):
    """Eight draws from one Generator seed on each side: images and masks
    bit-equal, the draws consumed alike (the next number equal)."""
    ja, ta = _pair(AUGMENTERS[name])
    img, mask = _image_mask(len(name) + n, n=n)
    jr, tr = np.random.default_rng(7), np.random.default_rng(7)
    changed = 0
    for _ in range(8):
        ji, jm = ja(img, mask, jr)
        ti, tm = ta(img, mask, tr)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tm, jm)
        assert ti.shape == img.shape and tm.shape == mask.shape
        changed += not np.array_equal(ti, img)
    assert tr.random() == jr.random()
    assert changed > 0


def _configs(**over):
    base = dict(NAME="aug_gen", IMAGES_PER_GPU=2, MAX_GT_INSTANCES=3,
                RPN_TRAIN_ANCHORS_PER_IMAGE=64)
    base.update(over)
    return (type("J", (JShapesConfig,), base)(),
            type("T", (ShapesConfig,), base)())


def _datasets(n, seed):
    out = []
    for cls in (JShapes, ShapesDataset):
        d = cls()
        d.load_shapes(n, 128, 128, seed=seed)
        d.prepare()
        out.append(d)
    return out


@pytest.mark.parametrize("name", ["nucleus", "sequential"])
def test_data_generator_with_augmentation_matches_jax(name):
    """Three batches of two with an Augmenter drawing from the generator's
    own Generator: every array bit-equal."""
    jcfg, tcfg = _configs()
    jd, td = _datasets(5, 11)
    ja, ta = _pair(AUGMENTERS[name])
    np.random.seed(3)
    jb = [b for _, b in zip(range(3), jds.data_generator(
        jd, jcfg, seed=4, augmentation=ja))]
    np.random.seed(3)
    tb = [b for _, b in zip(range(3), tds.data_generator(
        td, tcfg, seed=4, augmentation=ta))]
    for j, t in zip(jb, tb):
        for k in j:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert (np.stack([b["gt_class_ids"] for b in tb]) > 0).sum() >= 6


def test_trainer_train_with_augmentation(monkeypatch):
    """Trainer.train(..., augmentation=aug) on the CPU: one step at a tiny
    config, the batch it trains on equal to the JAX generator's under the
    same seeds (the generator's own seed pinned by wrapping
    data_generator), the loss finite."""
    from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from slam_maskrcnn_tpu_torch.train import trainer as ttr

    over = dict(BACKBONE="resnet50", POST_NMS_ROIS_TRAINING=64,
                TRAIN_ROIS_PER_IMAGE=16, COMPUTE_DTYPE="float32",
                STEPS_PER_EPOCH=1)
    jcfg, tcfg = _configs(**over)
    jd, td = _datasets(4, 2)
    ja, ta = _pair(AUGMENTERS["nucleus"])
    seen = []
    real_gen, real_to = tds.data_generator, ttr.batch_to_device
    monkeypatch.setattr(tds, "data_generator",
                        lambda *a, **k: real_gen(*a, **dict(k, seed=9)))
    monkeypatch.setattr(ttr, "batch_to_device",
                        lambda b, dev: seen.append(
                            {k: v.copy() for k, v in b.items()})
                        or real_to(b, dev))
    model = MaskRCNN("training", tcfg, device="cpu")
    model.init_params(0)
    np.random.seed(6)
    hist = ttr.Trainer(model, tcfg).train(td, epochs=1, layers="heads",
                                          checkpoint=False, verbose=0,
                                          augmentation=ta)
    assert len(seen) == 1 and np.isfinite(hist).all()
    np.random.seed(6)
    want = next(jds.data_generator(jd, jcfg, shuffle=True, seed=9,
                                   augmentation=ja))
    for k in want:
        np.testing.assert_array_equal(seen[0][k], want[k], err_msg=k)
