"""The port's trained-detector path against the JAX package on the CPU:
the committed parity scenes (slam_maskrcnn_tpu_torch/data/detect_scenes.npz)
against a fresh drawing; cv2's bilinear resize (ops/resize.py); molding
(``mold_inputs``, bit-equal); ``unmold_detections``; and detection of the
20 scenes with ``weights/shapes_r2_f16.h5`` in float32, port vs JAX.

Bars, f32 on each half of the 20 scenes: a same-class box match at IoU
0.9 for >= 95% of the JAX detections, score MAD <= 0.01, and mAP@50
against ground truth within 0.02 of the JAX package's."""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_maskrcnn_tpu.models import MaskRCNN as JMaskRCNN
from slam_maskrcnn_tpu.models.anchors import get_anchors as j_anchors
from slam_maskrcnn_tpu.models.import_h5 import load_h5_weights as j_load
from slam_maskrcnn_tpu.models.mask_rcnn import unmold_mask as j_unmold_mask
from slam_maskrcnn_tpu.samples.train_shapes import \
    InferenceShapesConfig as JShapes
from slam_maskrcnn_tpu_torch.eval.metrics import compute_ap
from slam_maskrcnn_tpu_torch.models.mask_rcnn import (MaskRCNN,
                                                      resize_image,
                                                      unmold_mask)
from slam_maskrcnn_tpu_torch.ops.resize import resize_linear
from slam_maskrcnn_tpu_torch.samples.train_shapes import (
    SCENES, InferenceShapesConfig, detect_scenes)
from slam_maskrcnn_tpu_torch.testing import match_detections

# the suite runs several workers on few cores: keep torch's thread pool
# small, or its spinning threads starve one another
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINED = os.path.join(REPO, "weights", "shapes_r2_f16.h5")


def build_detect_scenes():
    """tools/parity_gate.py ``build_detect_scenes``: three sizes x seeds of
    the JAX ShapesDataset, plus four 64x384 stretched scenes. Returns the
    arrays of detect_scenes.npz."""
    from slam_maskrcnn_tpu.data.dataset import extract_bboxes
    from slam_maskrcnn_tpu.data.shapes import ShapesDataset

    images, gts = [], []
    for size, n, seed in ((128, 6, 9), (96, 5, 21), (192, 5, 31)):
        ds = ShapesDataset()
        ds.load_shapes(n, size, size, seed=seed)
        ds.prepare()
        for i in ds.image_ids:
            images.append(ds.load_image(i))
            m, cls = ds.load_mask(i)
            gts.append((extract_bboxes(m), cls, m))
    ds = ShapesDataset()
    ds.load_shapes(4, 128, 128, seed=77)
    ds.prepare()
    for i in ds.image_ids:
        img = ds.load_image(i)
        images.append(cv2.resize(img, (384, 64),
                                 interpolation=cv2.INTER_LINEAR))
        m, cls = ds.load_mask(i)
        ms = np.stack([cv2.resize(m[..., k].astype(np.uint8), (384, 64),
                                  interpolation=cv2.INTER_NEAREST)
                       for k in range(m.shape[-1])], -1).astype(bool)
        gts.append((extract_bboxes(ms), cls, ms))
    out = {"n": np.array(len(images))}
    for i, (img, (b, c, m)) in enumerate(zip(images, gts)):
        out.update({f"image{i}": img, f"boxes{i}": b, f"class_ids{i}": c,
                    f"masks{i}": m})
    return out


def test_detect_scenes_npz_is_current():
    """The committed scenes equal a fresh drawing (the card has no cv2 to
    draw them); regenerate with np.savez_compressed(SCENES,
    **build_detect_scenes()) if the drawing ever changes."""
    want = build_detect_scenes()
    got = np.load(SCENES)
    assert sorted(got.files) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(detect_scenes()) == 20


SIZES_U8 = [((96, 96), (128, 128)), ((192, 192), (128, 128)),
            ((64, 384), (21, 128)), ((480, 640), (768, 1024)),
            ((37, 91), (80, 13)), ((13, 17), (40, 41)), ((100, 100), (50, 50)),
            ((28, 28), (5, 9)), ((28, 28), (57, 3)), ((9, 9), (1, 7)),
            ((130, 129), (128, 127)), ((200, 100), (199, 99)),
            ((28, 28), (14, 14))]


@pytest.mark.parametrize("src,dst", SIZES_U8)
@pytest.mark.parametrize("ch", [1, 3])
def test_resize_u8_bit_equal_to_cv2(src, dst, ch):
    rng = np.random.default_rng(sum(src) + sum(dst) + ch)
    img = rng.integers(0, 256, src + ((ch,) if ch > 1 else ())).astype(
        np.uint8)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    got = resize_linear(torch.from_numpy(img), dst).numpy()
    np.testing.assert_array_equal(got, want)


def test_resize_f32_within_ulps_of_cv2():
    """The float path (the mask paste): within 2 float32 ulp of 255."""
    rng = np.random.default_rng(9)
    for src, dst in SIZES_U8:
        img = rng.integers(0, 256, src).astype(np.float32)
        want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
        got = resize_linear(torch.from_numpy(img), dst).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=3.1e-5)


class Rect(JShapes):
    IMAGE_RESIZE_MODE = "rect"
    IMAGE_RECT_SHAPE = (128, 192)


class Pad64(JShapes):
    IMAGE_RESIZE_MODE = "pad64"
    IMAGE_MIN_DIM = 100


@pytest.mark.parametrize("jcfg", [JShapes, Rect, Pad64],
                         ids=["square", "rect", "pad64"])
def test_mold_inputs_bit_equal_to_jax(jcfg):
    """Every committed scene plus odd sizes: molded images and windows."""
    rng = np.random.default_rng(1)
    images = [s[0] for s in detect_scenes()] + [
        rng.integers(0, 256, hw + (3,)).astype(np.uint8)
        for hw in ((480, 640), (77, 45), (130, 129))]
    jm = JMaskRCNN("inference", jcfg())
    tcfg = type("T" + jcfg.__name__, (InferenceShapesConfig,),
                {k: getattr(jcfg, k) for k in ("IMAGE_RESIZE_MODE",
                                               "IMAGE_RECT_SHAPE",
                                               "IMAGE_MIN_DIM")})()
    tm = MaskRCNN("inference", tcfg, device="cpu")
    for img in images:
        jmolded, jwin = jm.mold_inputs([img])
        tmolded, twin = tm.mold_inputs([img])
        np.testing.assert_array_equal(twin, jwin)
        np.testing.assert_array_equal(tmolded.numpy(), jmolded)


def test_resize_image_modes():
    """"none" keeps the image; "crop" (training) takes the JAX package's
    random min_dim window, drawn from numpy's global stream."""
    from slam_maskrcnn_tpu.models.mask_rcnn import resize_image as j_resize

    img = np.zeros((10, 20, 3), np.uint8)
    out, window, scale, pad = resize_image(img, mode="none")
    assert window == (0, 0, 10, 20) and scale == 1.0
    img = np.random.default_rng(3).integers(0, 256, (10, 20, 3), np.uint8)
    for seed in range(4):
        np.random.seed(seed)
        j = j_resize(img, 8, 8, mode="crop")
        np.random.seed(seed)
        t = resize_image(img, 8, 8, mode="crop")
        np.testing.assert_array_equal(t[0].numpy(), j[0])
        assert tuple(t[1]) == tuple(j[1]) and t[2] == j[2]
        assert t[3] == j[3] and tuple(t[4]) == tuple(j[4])


def _fixed_detections(rng, D, n_valid, window):
    """Molded-normalized detections [D, 6] inside the normalized window
    (clipped to it, as the detection layer does), n_valid rows of them,
    some thin enough to unmold to zero area, then zero rows."""
    wy1, wx1, wy2, wx2 = (np.asarray(window, np.float64)
                          - [0, 0, 1, 1]) / 127.0
    y1 = rng.uniform(wy1, wy2, D)
    x1 = rng.uniform(wx1, wx2, D)
    h = rng.uniform(0.001, 0.4, D) * (wy2 - wy1)
    w = rng.uniform(0.001, 0.4, D) * (wx2 - wx1)
    det = np.zeros((D, 6), np.float32)
    det[:, 0], det[:, 1] = y1, x1
    det[:, 2], det[:, 3] = np.minimum(y1 + h, wy2), np.minimum(x1 + w, wx2)
    det[:, 4] = rng.integers(1, 4, D)
    det[:, 5] = rng.uniform(0.7, 1.0, D)
    det[n_valid:] = 0
    return det


@pytest.mark.parametrize("shape,window", [((128, 128, 3), (0, 0, 128, 128)),
                                          ((96, 96, 3), (0, 0, 128, 128)),
                                          ((64, 384, 3), (53, 0, 74, 128))])
def test_unmold_detections_matches_jax(shape, window):
    """Fixed detections and smooth u8 masks: rois, class ids and scores
    equal; the pasted masks equal but for pixels whose interpolated value
    sits within float32 rounding of the 127.5 threshold (counted)."""
    rng = np.random.default_rng(sum(shape))
    det = _fixed_detections(rng, 12, 9, window)
    yy, xx = np.mgrid[:28, :28]
    masks = np.stack([np.clip(255 * (1.3 - np.hypot(yy - c[0], xx - c[1])
                                     / r), 0, 255)
                      for c, r in zip(rng.uniform(8, 20, (12, 2)),
                                      rng.uniform(6, 14, 12))]).astype(
        np.uint8)
    jm = JMaskRCNN("inference", JShapes())
    tm = MaskRCNN("inference", InferenceShapesConfig(), device="cpu")
    want = jm.unmold_detections(det, masks, shape, (128, 128, 3), window)
    got = tm.unmold_detections(det, torch.from_numpy(masks), shape,
                               (128, 128, 3), window)
    for k in ("rois", "class_ids", "scores"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["rois"].dtype == np.int32 and len(want["rois"]) >= 3
    assert got["masks"].shape == want["masks"].shape
    differ = int((got["masks"] != want["masks"]).sum())
    assert differ <= 2, f"{differ} pasted pixels differ"
    assert want["masks"].any()


def test_unmold_mask_paste_against_cv2():
    """unmold_mask alone, box sizes up and down from 28: the paste equals
    cv2's on all but a handful of threshold pixels."""
    rng = np.random.default_rng(4)
    total = differ = 0
    for _ in range(40):
        m = np.clip(rng.normal(127, 90, (28, 28)), 0, 255).astype(np.uint8)
        y1, x1 = rng.integers(0, 60, 2)
        h, w = rng.integers(1, 70, 2)
        box = np.array([y1, x1, y1 + h, x1 + w])
        want = j_unmold_mask(m, box, (140, 140))
        got = unmold_mask(torch.from_numpy(m), box, (140, 140)).numpy()
        total += h * w
        differ += int((got != want).sum())
    assert differ <= 1e-4 * total, (differ, total)


def _jax_trained(cfg_cls):
    """The JAX model with the committed checkpoint, strictly, on zeros
    shaped by jax.eval_shape (nothing to initialise)."""
    jm = JMaskRCNN("inference", cfg_cls())
    shape = tuple(int(s) for s in jm.config.IMAGE_SHAPE[:2])
    tree = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0),
                          jnp.zeros((1,) + shape + (3,)),
                          jnp.asarray(j_anchors(jm.config,
                                                jm.config.IMAGE_SHAPE)),
                          jnp.zeros((1, 4)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), tree)
    jm.params = j_load(TRAINED, zeros, strict=True)
    return jm


class JF32(JShapes):
    COMPUTE_DTYPE = "float32"


class TF32(InferenceShapesConfig):
    COMPUTE_DTYPE = "float32"


def f32_parity(lo: int, hi: int):
    """Detect scenes lo..hi-1 in float32 with the port and the JAX package
    and hold them to the bars of the module docstring (checked on each
    half of the 20 scenes, one half per test file, to keep each file's
    time down). Returns (matched, JAX detections, score MAD, JAX mAP, port
    mAP)."""
    scenes = detect_scenes()[lo:hi]
    jm = _jax_trained(JF32)
    tm = MaskRCNN("inference", TF32(), device="cpu").load_weights(TRAINED)
    n_jax = matched = 0
    mad_sum, ap_j, ap_t = 0.0, [], []
    for img, gb, gc, gm in scenes:
        j, t = jm.detect([img])[0], tm.detect([img])[0]
        assert t["masks"].shape[:2] == img.shape[:2]
        k, mad = match_detections(j["rois"], j["class_ids"], j["scores"],
                                  t["rois"], t["class_ids"], t["scores"],
                                  iou_thr=0.9)
        n_jax += len(j["rois"])
        matched += k
        mad_sum += mad * k
        for res, aps in ((j, ap_j), (t, ap_t)):
            aps.append(compute_ap(gb, gc, gm, res["rois"].astype(np.float32),
                                  res["class_ids"], res["scores"],
                                  res["masks"])[0])
    m_j, m_t = float(np.mean(ap_j)), float(np.mean(ap_t))
    assert n_jax >= 20, n_jax
    assert matched >= 0.95 * n_jax, (matched, n_jax)
    assert mad_sum / matched <= 0.01, mad_sum / matched
    assert abs(m_j - m_t) <= 0.02, (m_j, m_t)
    return matched, n_jax, mad_sum / matched, m_j, m_t


def test_f32_detect_matches_jax_first_half():
    """Scenes 0-9 (the 128^2 and 96^2 scenes); 10-19 are held in
    tests/test_torch_detect_f32.py."""
    f32_parity(0, 10)
