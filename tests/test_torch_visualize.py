"""The port's viz/visualize.py against the JAX package's on the CPU: every
function on the same numpy inputs, the colours passed in (or
``random_colors`` seeded on both sides: the JAX one shuffles unseeded).
The composites must be bit-equal (boxes by data/draw.py, captions by
viz/font.py, both OpenCV 5's pixels); a ``save_path`` PNG must read back
equal; the matplotlib figures must carry the same image arrays, titles,
tick labels, texts and lines."""

import matplotlib

matplotlib.use("Agg")

import cv2  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from slam_maskrcnn_tpu.models import MaskRCNN as JMaskRCNN  # noqa: E402
from slam_maskrcnn_tpu.samples.coco import COCO_CLASS_NAMES  # noqa: E402
from slam_maskrcnn_tpu.viz import visualize as jv  # noqa: E402
from slam_maskrcnn_tpu_torch.data.image_io import imread  # noqa: E402
from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN  # noqa: E402
from slam_maskrcnn_tpu_torch.models.weights import \
    load_jax_params  # noqa: E402
from slam_maskrcnn_tpu_torch.viz import visualize as tv  # noqa: E402
from test_torch_north_star import _configs, _variables  # noqa: E402

torch.set_num_threads(2)


def scene(seed, H=96, W=128, N=4):
    """An image, N boxes inside it (some touching the border) with masks
    inside the boxes, class ids and scores."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    boxes, masks = [], np.zeros((H, W, N), bool)
    for i in range(N):
        y1 = int(rng.integers(0, H - 20))
        x1 = int(rng.integers(0, W - 20))
        y2 = min(H - 1, y1 + int(rng.integers(10, 50)))
        x2 = min(W - 1, x1 + int(rng.integers(10, 70)))
        if i == 0:
            y1, x1 = 0, 0                  # caption pushed to y = 10
        boxes.append((y1, x1, y2, x2))
        yy, xx = np.mgrid[:H, :W]
        cy, cx = (y1 + y2) / 2, (x1 + x2) / 2
        masks[..., i] = (((yy - cy) / ((y2 - y1) / 2 + 1)) ** 2
                         + ((xx - cx) / ((x2 - x1) / 2 + 1)) ** 2) < 1
    class_ids = rng.integers(1, 81, N).astype(np.int32)
    scores = rng.uniform(0.5, 1.0, N).astype(np.float32)
    return img, np.asarray(boxes, np.int32), masks, class_ids, scores


_RANDOM_COLORS = jv.random_colors


def seeded_colors(N, bright=True, seed=None):
    return _RANDOM_COLORS(N, bright, seed=5)


@pytest.fixture
def seeded(monkeypatch):
    monkeypatch.setattr(jv, "random_colors", seeded_colors)
    monkeypatch.setattr(tv, "random_colors", seeded_colors)


@pytest.mark.parametrize("seed", [0, 1])
def test_random_colors_and_apply_mask(seed):
    for n in (1, 3, 8):
        assert tv.random_colors(n, seed=seed) == jv.random_colors(n, seed=seed)
        assert tv.random_colors(n, False, seed) == \
            jv.random_colors(n, False, seed)
    img, _, masks, _, _ = scene(seed)
    col = jv.random_colors(1, seed=seed)[0]
    for a in (img, img.astype(np.float32)):
        np.testing.assert_array_equal(tv.apply_mask(a, masks[..., 1], col),
                                      jv.apply_mask(a, masks[..., 1], col))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_draw_boxes_and_draw_box(seed):
    img, boxes, _, _, _ = scene(seed)
    beyond = np.concatenate([boxes, [[-5, -5, 200, 300], [40, 50, 40, 50]]])
    for color in ((1.0, 1.0, 0.0), (0.2, 0.5, 0.9)):
        np.testing.assert_array_equal(tv.draw_boxes(img, beyond, color),
                                      jv.draw_boxes(img, beyond, color))
    for b in boxes:
        np.testing.assert_array_equal(
            tv.draw_box(img.copy(), b, (10, 200, 30)),
            jv.draw_box(img.copy(), b, (10, 200, 30)))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_display_instances_bit_equal(tmp_path, seed):
    img, boxes, masks, ids, scores = scene(seed)
    colors = jv.random_colors(len(boxes), seed=seed)
    for kw in (dict(), dict(captions=["a caption", "0.91 / 0.73", "", "x"]),
               dict(show_mask=False), dict(show_bbox=False),
               dict(scores=None)):
        args = dict(dict(scores=scores), **kw)
        t = tv.display_instances(img, boxes, masks, ids, COCO_CLASS_NAMES,
                                 colors=colors, show=False, **args)
        j = jv.display_instances(img, boxes, masks, ids, COCO_CLASS_NAMES,
                                 colors=colors, show=False, **args)
        np.testing.assert_array_equal(t, j, err_msg=str(kw))
    tp, jp = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    tv.display_instances(img, boxes, masks, ids, COCO_CLASS_NAMES, scores,
                         colors=colors, show=False, save_path=tp)
    jv.display_instances(img, boxes, masks, ids, COCO_CLASS_NAMES, scores,
                         colors=colors, show=False, save_path=jp)
    np.testing.assert_array_equal(imread(tp), cv2.imread(jp))
    # no detections
    np.testing.assert_array_equal(
        tv.display_instances(img, boxes[:0], masks[..., :0], ids[:0],
                             COCO_CLASS_NAMES, scores[:0], show=False),
        jv.display_instances(img, boxes[:0], masks[..., :0], ids[:0],
                             COCO_CLASS_NAMES, scores[:0], show=False))


@pytest.mark.parametrize("seed", [0, 1])
def test_display_differences_bit_equal(seed):
    img, boxes, masks, ids, scores = scene(seed, N=5)
    gt = (boxes[:3], ids[:3], masks[..., :3])
    shifted = np.clip(boxes[1:] + 2, 0, 95)
    pred = (shifted, np.concatenate([ids[1:3], ids[3:]]),
            scores[1:], np.roll(masks[..., 1:], 1, axis=0))
    for thr in (0.5, 0.0):
        t = tv.display_differences(img, *gt, *pred, COCO_CLASS_NAMES,
                                   score_threshold=thr)
        j = jv.display_differences(img, *gt, *pred, COCO_CLASS_NAMES,
                                   score_threshold=thr)
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("seed", [0, 1])
def test_draw_rois_bit_equal(seeded, seed):
    img, boxes, masks, ids, _ = scene(seed, N=14)
    rng = np.random.default_rng(seed)
    refined = np.clip(boxes + rng.integers(-4, 5, boxes.shape), 0, 95)
    ids = ids.copy()
    ids[::3] = 0                            # background rois: gray only
    for limit, m in ((10, masks), (20, None)):
        t = tv.draw_rois(img, boxes, refined, m, ids, COCO_CLASS_NAMES,
                         limit=limit, seed=seed)
        j = jv.draw_rois(img, boxes, refined, m, ids, COCO_CLASS_NAMES,
                         limit=limit, seed=seed)
        np.testing.assert_array_equal(t, j)


def _figure(fig):
    """What a figure shows: per axes its title, tick labels, texts, the
    arrays of its images and the data of its lines."""
    out = []
    for ax in fig.axes:
        out.append(dict(
            title=ax.get_title(),
            xt=[t.get_text() for t in ax.get_xticklabels()],
            yt=[t.get_text() for t in ax.get_yticklabels()],
            xlabel=ax.get_xlabel(), ylabel=ax.get_ylabel(),
            texts=[t.get_text() for t in ax.texts],
            images=[np.asarray(im.get_array()) for im in ax.images],
            lines=[np.asarray(ln.get_xydata()) for ln in ax.get_lines()]))
    return out


def _same_figures(a, b):
    fa, fb = _figure(a), _figure(b)
    assert len(fa) == len(fb) > 0
    for x, y in zip(fa, fb):
        for k in ("title", "xt", "yt", "xlabel", "ylabel", "texts"):
            assert x[k] == y[k], k
        for k in ("images", "lines"):
            assert len(x[k]) == len(y[k])
            for p, q in zip(x[k], y[k]):
                np.testing.assert_array_equal(p, q)
    plt.close(a)
    plt.close(b)


def test_matplotlib_figures_match(tmp_path):
    img, boxes, masks, ids, scores = scene(4, N=6)
    ids = np.array([1, 3, 3, 1, 17, 3], np.int32)
    _same_figures(tv.display_images([img, img[..., 0]], ["a", "b"], cols=2),
                  jv.display_images([img, img[..., 0]], ["a", "b"], cols=2))
    _same_figures(tv.display_top_masks(img, masks, ids, COCO_CLASS_NAMES),
                  jv.display_top_masks(img, masks, ids, COCO_CLASS_NAMES))
    p = np.linspace(1, 0.2, 9)
    r = np.linspace(0, 1, 9)
    _same_figures(tv.plot_precision_recall(0.6543, p, r),
                  jv.plot_precision_recall(0.6543, p, r))
    ov = np.random.default_rng(0).random((3, 4))
    _same_figures(
        tv.plot_overlaps(ids[:4], ids[1:4], scores[:3], ov, COCO_CLASS_NAMES),
        jv.plot_overlaps(ids[:4], ids[1:4], scores[:3], ov, COCO_CLASS_NAMES))
    act = np.random.default_rng(1).random((1, 12, 10, 5)).astype(np.float32)
    _same_figures(tv.display_activations(act, channels=4, cols=2),
                  jv.display_activations(act, channels=4, cols=2))
    colors = jv.random_colors(len(boxes), seed=1)
    ft, fj = plt.figure(), plt.figure()
    at, aj = ft.add_subplot(1, 1, 1), fj.add_subplot(1, 1, 1)
    tv.display_instances(img, boxes, masks, ids, COCO_CLASS_NAMES, scores,
                         title="t", ax=at, colors=colors, show=True)
    jv.display_instances(img, boxes, masks, ids, COCO_CLASS_NAMES, scores,
                         title="t", ax=aj, colors=colors, show=True)
    _same_figures(ft, fj)
    tv.plot_precision_recall(0.5, p, r, save_path=str(tmp_path / "pr.png"))
    assert imread(tmp_path / "pr.png") is not None


def test_display_weight_stats_matches():
    jcfg, tcfg = _configs()
    jm = JMaskRCNN("inference", jcfg)
    v = _variables(jm, 2)
    jm.params = jax.tree.map(jnp.asarray, v)
    tm = MaskRCNN("inference", tcfg, device="cpu")
    load_jax_params(v, tm, device="cpu")
    jrows = {r["name"]: r for r in jv.display_weight_stats(jm)}
    trows = {r["name"]: r for r in tv.display_weight_stats(tm)}
    assert sorted(trows) == sorted(jrows) and len(trows) > 100
    for name, a in trows.items():
        b = jrows[name]
        assert tuple(a["shape"]) == tuple(b["shape"])
        for k in ("min", "max", "mean", "std"):
            assert a[k] == pytest.approx(b[k], rel=1e-5, abs=1e-6), k
