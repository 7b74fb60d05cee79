"""The port's samples (samples/{nucleus, mini_coco, balloon, mask_image,
coco, dataset_audit, sample_train_smoke}.py) against the JAX package's on
the CPU.

The drivers run on a stub model that returns fixed detections (the same
in both packages), so what is compared is the driver: ``submit.csv``
equal; ``make_mini_coco``'s annotation JSON equal and its PNGs decoding
to equal pixels, ``run_protocol``'s stats within 1e-12; the balloon and
nucleus trees of the smoke gates equal pixel for pixel, their datasets'
masks equal (VIA polygons filled as cv2.fillPoly fills them), the splash
PNG equal; ``template_match_mask_detect`` the same location, box and
mask; ``evaluate_coco`` and ``detection_to_coco_results`` equal; the
audit report equal. One tiny-config detect through ``ObjectTracker.step``
runs on seeded weights carried by ``load_jax_params``: the same box (to a
pixel), class and score (1e-4), and masks agreeing on >= 99% of pixels.
One training step and its held-out evaluation run through the smoke
gate's ``run_one`` at a tiny config, and the gates' training batches
equal the JAX package's."""

import importlib.util
import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_maskrcnn_tpu.samples import balloon as jballoon
from slam_maskrcnn_tpu.samples import coco as jcoco
from slam_maskrcnn_tpu.samples import dataset_audit as jaudit
from slam_maskrcnn_tpu.samples import mask_image as jmi
from slam_maskrcnn_tpu.samples import mini_coco as jmini
from slam_maskrcnn_tpu.samples import nucleus as jnuc
from slam_maskrcnn_tpu_torch.data.png import read_png
from slam_maskrcnn_tpu_torch.samples import balloon as tballoon
from slam_maskrcnn_tpu_torch.samples import coco as tcoco
from slam_maskrcnn_tpu_torch.samples import dataset_audit as taudit
from slam_maskrcnn_tpu_torch.samples import mask_image as tmi
from slam_maskrcnn_tpu_torch.samples import mini_coco as tmini
from slam_maskrcnn_tpu_torch.samples import nucleus as tnuc
from slam_maskrcnn_tpu_torch.samples import sample_train_smoke as tsmoke

torch.set_num_threads(2)

_spec = importlib.util.spec_from_file_location(
    "jax_sample_train_smoke", os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "tools",
        "sample_train_smoke.py"))
jsmoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jsmoke)


class Stub:
    """A model whose ``detect`` returns fixed detections: ``n`` boxes
    drawn from a seed made of the image's shape and pixel sum, each with
    an elliptic mask inside its box (overlapping one another)."""

    device = torch.device("cpu")

    def __init__(self, n=4, classes=(1,)):
        self.n, self.classes = n, classes

    def detect(self, images, verbose=0):
        out = []
        for img in images:
            H, W = img.shape[:2]
            rng = np.random.default_rng(int(img.sum()) + 7 * H + W)
            rois, masks = [], np.zeros((H, W, self.n), bool)
            yy, xx = np.mgrid[:H, :W]
            for k in range(self.n):
                h = int(rng.integers(3, max(4, H // 2)))
                w = int(rng.integers(3, max(4, W // 2)))
                y, x = int(rng.integers(0, H - h)), int(rng.integers(0, W - w))
                rois.append([y, x, y + h, x + w])
                masks[..., k] = (((yy - y - h / 2) / (h / 2)) ** 2
                                 + ((xx - x - w / 2) / (w / 2)) ** 2) <= 1
            out.append(dict(
                rois=np.asarray(rois, np.int32).reshape(-1, 4),
                class_ids=np.asarray([self.classes[k % len(self.classes)]
                                      for k in range(self.n)], np.int32),
                scores=rng.uniform(0.5, 1.0, self.n).astype(np.float32),
                masks=masks))
        return out


def _pixels_equal(path_a, path_b):
    a = cv2.imread(str(path_a), cv2.IMREAD_UNCHANGED)
    b = cv2.imread(str(path_b), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(a, b)


def _same_tree(a, b):
    fa = sorted(os.path.relpath(os.path.join(d, f), a)
                for d, _, fs in os.walk(a) for f in fs)
    fb = sorted(os.path.relpath(os.path.join(d, f), b)
                for d, _, fs in os.walk(b) for f in fs)
    assert fa == fb and fa
    for f in fa:
        if f.endswith(".png"):
            _pixels_equal(os.path.join(a, f), os.path.join(b, f))
        else:
            with open(os.path.join(a, f)) as x, open(os.path.join(b, f)) as y:
                assert json.load(x) == json.load(y), f
    return fa


@pytest.mark.parametrize("seed", [1, 9])
def test_nucleus_tree_dataset_and_submit_match_jax(tmp_path, seed):
    jroot, troot = tmp_path / "j", tmp_path / "t"
    jsmoke.make_nucleus_tree(str(jroot), n=3, seed=seed)
    tsmoke.make_nucleus_tree(str(troot), n=3, seed=seed)
    _same_tree(jroot, troot)
    jd, td = jnuc.NucleusDataset(), tnuc.NucleusDataset()
    jd.load_nucleus(str(jroot), "stage1_train")
    td.load_nucleus(str(troot), "stage1_train")
    jd.prepare()
    td.prepare()
    for i in td.image_ids:
        np.testing.assert_array_equal(td.load_image(i), jd.load_image(i))
        tm, tc = td.load_mask(i)
        jm, jc = jd.load_mask(i)
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_array_equal(tc, jc)
    jp = jnuc.detect(Stub(5), str(jroot), "stage1_train", str(tmp_path / "jo"))
    tp = tnuc.detect(Stub(5), str(troot), "stage1_train", str(tmp_path / "to"))
    with open(jp) as a, open(tp) as b:
        text = b.read()
        assert text == a.read()
    assert text.count("\n") == 3 * 5


def test_nucleus_colour_mask_pngs_match_jax(tmp_path):
    """Mask PNGs saved in colour: both read them at IMREAD_GRAYSCALE
    (libpng's colour to gray, which truncates), so every one of the 512
    near-black colours (channels 0..7) keeps or loses its pixel as in the
    JAX load_mask; cvtColor's rounding differs on 18 of them."""
    root = tmp_path / "stage1_train" / "nuc0"
    os.makedirs(root / "images")
    os.makedirs(root / "masks")
    cv2.imwrite(str(root / "images" / "nuc0.png"),
                np.full((16, 32, 3), 90, np.uint8))
    c = np.arange(512)
    near_black = np.stack([c % 8, c // 8 % 8, c // 64], -1).reshape(
        16, 32, 3).astype(np.uint8)
    rng = np.random.default_rng(4)
    for j, img in enumerate((near_black, near_black[::-1, ::-1],
                             rng.integers(0, 256, (16, 32, 3)))):
        cv2.imwrite(str(root / "masks" / f"m{j}.png"), img.astype(np.uint8))
    jd, td = jnuc.NucleusDataset(), tnuc.NucleusDataset()
    jd.load_nucleus(str(tmp_path), "stage1_train")
    td.load_nucleus(str(tmp_path), "stage1_train")
    jd.prepare()
    td.prepare()
    (tm, tc), (jm, jc) = td.load_mask(0), jd.load_mask(0)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tc, jc)
    rounded = cv2.cvtColor(near_black,
                           cv2.COLOR_BGR2GRAY) > 0
    assert (rounded != jm[..., 0]).sum() == 18


def test_kaggle_rle_matches_jax():
    rng = np.random.default_rng(3)
    for _ in range(5):
        m = rng.random((23, 31)) < 0.3
        s = tnuc.rle_encode_kaggle(m)
        assert s == jnuc.rle_encode_kaggle(m)
        np.testing.assert_array_equal(tnuc.rle_decode_kaggle(s, m.shape), m)
    masks = rng.random((20, 25, 4)) < 0.4
    scores = rng.random(4)
    assert tnuc.mask_to_rle("x", masks, scores) == \
        jnuc.mask_to_rle("x", masks, scores)
    assert tnuc.mask_to_rle("y", masks[..., :0], scores[:0]) == "y,"


def _perfect(ds, image_id, rng):
    from slam_maskrcnn_tpu_torch.data.dataset import extract_bboxes
    masks, ids = ds.load_mask(image_id)
    return {"rois": extract_bboxes(masks).astype(np.float32),
            "class_ids": np.abs(ids),
            "scores": 0.6 + 0.4 * rng.random(len(ids)), "masks": masks}


def test_mini_coco_matches_jax(tmp_path):
    jp = jmini.make_mini_coco(str(tmp_path / "j"), n_images=8, size=96,
                              seed=3)
    tp = tmini.make_mini_coco(str(tmp_path / "t"), n_images=8, size=96,
                              seed=3)
    assert os.path.basename(tp) == os.path.basename(jp)
    _same_tree(tmp_path / "j", tmp_path / "t")
    jd, td = jcoco.CocoDataset(), tcoco.CocoDataset()
    jd.load_coco(str(tmp_path / "j"), "val", "2014")
    td.load_coco(str(tmp_path / "t"), "val", "2014")
    jd.prepare()
    td.prepare()
    assert td.class_names == jd.class_names
    for i in td.image_ids:
        np.testing.assert_array_equal(td.load_image(i), jd.load_image(i))
        for a, b in zip(td.load_mask(i), jd.load_mask(i)):
            np.testing.assert_array_equal(a, b)

    def degraded(ds, seed):
        rng = np.random.default_rng(seed)

        def get(i):
            r = _perfect(ds, i, rng)
            keep = slice(0, max(1, len(r["class_ids"]) - 1))
            r = {k: v[keep] if k != "masks" else v[..., keep]
                 for k, v in r.items()}
            r["rois"] = r["rois"] + rng.normal(0, 1.5, r["rois"].shape)
            return r
        return get

    ts = tmini.run_protocol(td, degraded(td, 5), verbose=False)
    js = jmini.run_protocol(jd, degraded(jd, 5), verbose=False)
    assert sorted(ts) == sorted(js)
    for k in ("bbox", "segm"):
        for f in js[k]:
            np.testing.assert_allclose(ts[k][f], js[k][f], rtol=0,
                                       atol=1e-12)
    assert abs(ts["compute_ap50_mean"] - js["compute_ap50_mean"]) <= 1e-12
    assert 0.2 < ts["bbox"]["ap50"] < 1.0


def test_coco_sample_matches_jax(tmp_path):
    """CocoDataset on polygon / RLE / crowd annotations, evaluate_coco and
    detection_to_coco_results on the stub."""
    img_dir = tmp_path / "val2014"
    img_dir.mkdir()
    rng = np.random.default_rng(2)
    cv2.imwrite(str(img_dir / "a.png"),
                rng.integers(0, 255, (40, 60, 3)).astype(np.uint8))
    cv2.imwrite(str(img_dir / "b.png"),
                rng.integers(0, 255, (40, 60, 3)).astype(np.uint8))
    (tmp_path / "annotations").mkdir()
    m = np.zeros((40, 60), np.uint8)
    m[5:20, 30:50] = 1
    r = tcoco.rle_decode  # noqa: F841 (the port's codec, imported)
    from slam_maskrcnn_tpu_torch.eval.rle import rle_encode, counts_to_string
    enc = rle_encode(m)
    doc = {"images": [{"id": 1, "file_name": "a.png", "width": 60,
                       "height": 40},
                      {"id": 2, "file_name": "b.png", "width": 60,
                       "height": 40}],
           "categories": [{"id": 7, "name": "truck"},
                          {"id": 3, "name": "cat"}],
           "annotations": [
               {"id": 1, "image_id": 1, "category_id": 7, "iscrowd": 0,
                "segmentation": [[10.4, 10, 30.6, 4.5, 25, 18, 30, 30,
                                  -4, 33, 12, 20]], "area": 300,
                "bbox": [0, 0, 1, 1]},
               {"id": 2, "image_id": 1, "category_id": 3, "iscrowd": 1,
                "segmentation": {"size": [40, 60],
                                 "counts": counts_to_string(enc["counts"])},
                "area": 300, "bbox": [0, 0, 1, 1]},
               {"id": 3, "image_id": 2, "category_id": 3, "iscrowd": 0,
                "segmentation": {"size": [40, 60],
                                 "counts": [int(c) for c in enc["counts"]]},
                "area": 300, "bbox": [0, 0, 1, 1]}]}
    (tmp_path / "annotations" / "instances_minival2014.json").write_text(
        json.dumps(doc))
    jd, td = jcoco.CocoDataset(), tcoco.CocoDataset()
    jd.load_coco(str(tmp_path), "minival", "2014")
    td.load_coco(str(tmp_path), "minival", "2014")
    jd.prepare()
    td.prepare()
    for i in td.image_ids:
        for a, b in zip(td.load_mask(i), jd.load_mask(i)):
            np.testing.assert_array_equal(a, b)
    stub = Stub(3, classes=(1, 2))
    assert tcoco.evaluate_coco(stub, td, verbose=0) == \
        jcoco.evaluate_coco(stub, jd, verbose=0)
    for i in td.image_ids:
        r = stub.detect([td.load_image(i)])[0]
        assert tcoco.detection_to_coco_results(td, i, r) == \
            jcoco.detection_to_coco_results(jd, i, r)


@pytest.mark.parametrize("seed", [0, 7])
def test_balloon_tree_dataset_and_splash_match_jax(tmp_path, seed):
    jroot, troot = tmp_path / "j", tmp_path / "t"
    jsmoke.make_balloon_tree(str(jroot), n=3, seed=seed)
    tsmoke.make_balloon_tree(str(troot), n=3, seed=seed)
    _same_tree(jroot, troot)
    jd, td = jballoon.BalloonDataset(), tballoon.BalloonDataset()
    jd.load_balloon(str(jroot), "train")
    td.load_balloon(str(troot), "train")
    jd.prepare()
    td.prepare()
    for i in td.image_ids:
        assert (td.image_info[i]["height"], td.image_info[i]["width"]) == \
            (jd.image_info[i]["height"], jd.image_info[i]["width"])
        for a, b in zip(td.load_mask(i), jd.load_mask(i)):
            np.testing.assert_array_equal(a, b)
        assert td.load_mask(i)[0].any()
    img = td.load_image(0)
    r = Stub(2).detect([img])[0]
    np.testing.assert_array_equal(tballoon.color_splash(img, r["masks"]),
                                  jballoon.color_splash(img, r["masks"]))
    np.testing.assert_array_equal(
        tballoon.color_splash(img, r["masks"][..., :0]),
        jballoon.color_splash(img, r["masks"][..., :0]))
    src = str(troot / "train" / "b0.png")
    (tmp_path / "jo").mkdir()
    (tmp_path / "to").mkdir()
    a = jballoon.detect_and_color_splash(Stub(2), image_path=src,
                                         out_dir=str(tmp_path / "jo"))
    b = tballoon.detect_and_color_splash(Stub(2), image_path=src,
                                         out_dir=str(tmp_path / "to"))
    _pixels_equal(a, b)
    # the video branch: a Motion-JPEG AVI of the tree's image, each output
    # frame the port's JPEG of the splash of its decoded input frame
    from slam_maskrcnn_tpu_torch.data import avi, jpeg
    bgr = cv2.imread(src)
    H, W = bgr.shape[:2]
    w = avi.AviWriter(str(tmp_path / "in.avi"), 5.0, (W, H), device="cpu")
    for k in range(2):
        w.write(np.ascontiguousarray(np.roll(bgr, 3 * k, axis=1)))
    w.release()
    out = tballoon.detect_and_color_splash(
        Stub(2), video_path=str(tmp_path / "in.avi"),
        out_dir=str(tmp_path / "to"))
    src_r, out_r = avi.AviReader(tmp_path / "in.avi"), avi.AviReader(out)
    assert (len(out_r), out_r.width, out_r.height, out_r.fps) == \
        (2, W, H, 5.0)
    for k in range(2):
        rgb = np.ascontiguousarray(src_r.read(k, device="cpu")[:, :, ::-1])
        splash = tballoon.color_splash(rgb, Stub(2).detect([rgb])[0]["masks"])
        assert out_r.frame_bytes(k) == jpeg.encode(
            np.ascontiguousarray(splash[:, :, ::-1]), device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_template_match_matches_jax(seed):
    """The previous target's crop found again in a new frame (a shifted,
    noisier copy), the detection re-run on the expanded window, its box
    and mask mapped back: the port's torch cross-correlation against
    cv2.matchTemplate + minMaxLoc."""
    rng = np.random.default_rng(seed)
    H, W = 90, 120
    frame = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    y, x = int(rng.integers(5, H - 40)), int(rng.integers(5, W - 50))
    crop = frame[y:y + 30, x:x + 40].copy()
    nxt = np.roll(frame, (int(rng.integers(-4, 5)), int(rng.integers(-4, 5))),
                  (0, 1))
    nxt = np.clip(nxt + rng.integers(-10, 10, nxt.shape), 0, 255).astype(
        np.uint8)
    names = ["BG", "bottle", "cup", "vase"]
    stub = Stub(3, classes=(1, 3))
    res = tmi.match_template(nxt, crop, device="cpu")
    want = cv2.matchTemplate(nxt, crop, cv2.TM_CCOEFF_NORMED)
    np.testing.assert_allclose(res.numpy(), want, rtol=0, atol=1e-4)
    assert tmi.max_location(res) == cv2.minMaxLoc(want)[3]
    t = tmi.template_match_mask_detect(stub, nxt, crop, None, names)
    j = jmi.template_match_mask_detect(stub, nxt, crop, None, names)
    for k in ("box", "mask"):
        np.testing.assert_array_equal(t[k], j[k])
    assert (t["class_id"], t["score"]) == (j["class_id"], j["score"])
    assert tmi.template_match_mask_detect(stub, nxt, crop[:5], None,
                                          names) is None


def test_tracker_helpers_match_jax():
    rng = np.random.default_rng(5)
    for _ in range(20):
        a, b = np.sort(rng.uniform(0, 50, (2, 2, 2)), axis=1)
        b1 = [a[0, 0], a[0, 1], a[1, 0] + 1, a[1, 1] + 1]
        b2 = [b[0, 0], b[0, 1], b[1, 0] + 1, b[1, 1] + 1]
        assert tmi.calc_overlap_ratio(b1, b2) == jmi.calc_overlap_ratio(b1,
                                                                        b2)
    depth = rng.integers(0, 10000, (30, 40)).astype(np.uint16)
    mask = rng.random((30, 40)) < 0.5
    np.testing.assert_array_equal(tmi.depth_filter_median(depth, mask, 2000),
                                  jmi.depth_filter_median(depth, mask, 2000))
    r = Stub(4, classes=(1, 2, 5)).detect([depth[..., None]])[0]
    names = ["BG", "bottle", "cup", "vase", "x", "chair"]
    for prev in (None, [0, 0, 10, 10]):
        assert tmi.pick_mask(r, names, prev_box=prev) == \
            jmi.pick_mask(r, names, prev_box=prev)
    d = dict(box=np.array([0, 0, 10, 10]), mask=mask, class_id=1, score=0.9)
    m = dict(box=np.array([1, 1, 11, 11]), mask=~mask, class_id=1, score=0.8)
    for args in ((d, m), (d, None), (None, m)):
        a, b = tmi.union_mask_roi(*args), jmi.union_mask_roi(*args)
        np.testing.assert_array_equal(a["mask"], b["mask"])


def test_tracker_step_tiny_model_matches_jax(tmp_path):
    """ObjectTracker.step on two frames with the tiny model of
    test_torch_north_star (seed-3 weights carried by load_jax_params):
    the picked target's box, class, score and mask, and the written
    outputs and log."""
    from slam_maskrcnn_tpu.data.synthetic import default_scene, make_sequence
    from slam_maskrcnn_tpu.fusion.state import make_intrinsic
    from slam_maskrcnn_tpu.models import MaskRCNN as JMaskRCNN
    from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from slam_maskrcnn_tpu_torch.models.weights import load_jax_params
    from test_torch_north_star import _configs, _steady_heads, _variables

    jcfg, tcfg = _configs()
    jm = JMaskRCNN("inference", jcfg)
    v = _steady_heads(_variables(jm, 3))
    jm.params = jax.tree.map(jnp.asarray, v)
    tm = MaskRCNN("inference", tcfg, device="cpu")
    load_jax_params(v, tm, device="cpu")
    K4 = make_intrinsic(100.0, 100.0, 64.0, 48.0)
    frames = make_sequence(default_scene(), K4, 96, 128, 3)
    names = ["BG", "bottle", "cup", "vase"]
    jt, tt = jmi.ObjectTracker(jm, names), tmi.ObjectTracker(tm, names)
    for fr in frames[1:]:
        rgb = np.ascontiguousarray(fr["color"][..., ::-1])
        depth = fr["depth"].astype(np.float32)
        j, t = jt.step(rgb, depth), tt.step(rgb, depth)
        assert j is not None and t is not None
        assert np.abs(np.asarray(t["box"]) - np.asarray(j["box"])).max() <= 1
        assert t["class_id"] == j["class_id"]
        assert abs(t["score"] - j["score"]) <= 1e-4
        assert (t["mask"] == j["mask"]).mean() >= 0.99
        tt.write_outputs(rgb, t, str(tmp_path / "rgb"), str(tmp_path / "g"),
                         "f.png")
        g = read_png(str(tmp_path / "g" / "f.png"))
        np.testing.assert_array_equal(g > 0, t["mask"])
    tt.write_log(str(tmp_path / "log.txt"))
    assert len(tt.log) == 2 and [n for n, _ in tt.log] == \
        [n for n, _ in jt.log]


def test_dataset_audit_matches_jax(tmp_path):
    for stream, stamps in (("rgb", [1.0, 1.5, 2.25, 5.0]),
                           ("depth", [1.1, 3.0]), ("mask", [])):
        os.makedirs(tmp_path / stream)
        for s in stamps:
            (tmp_path / stream / f"{s:.6f}.png").write_bytes(b"")
    (tmp_path / "rgb" / "notes.png").write_bytes(b"")
    a = taudit.audit(str(tmp_path), str(tmp_path / "t" / "n.txt"))
    b = jaudit.audit(str(tmp_path), str(tmp_path / "j" / "n.txt"))
    assert a == b and a["rgb"]["total"] == 5
    assert (tmp_path / "t" / "n.txt").read_text() == \
        (tmp_path / "j" / "n.txt").read_text()


def test_smoke_run_one_tiny(tmp_path):
    """The smoke gate's protocol at a tiny config on the balloon tree:
    one f32 step with TRAIN_BN, then mAP@50 on one held-out image."""
    from slam_maskrcnn_tpu_torch.models.mask_rcnn import MaskRCNN

    cfg, ds, val_ds, inf_cfg = tsmoke.balloon_setup(str(tmp_path), 2, 1,
                                                    True)
    tiny = dict(BACKBONE="resnet50", IMAGE_MIN_DIM=128, IMAGE_MAX_DIM=128,
                POST_NMS_ROIS_TRAINING=64, POST_NMS_ROIS_INFERENCE=64,
                TRAIN_ROIS_PER_IMAGE=16, RPN_ANCHOR_SCALES=(8, 16, 32, 64,
                                                            128))
    cfg = type("TinyBalloon", (type(cfg),), tiny)()
    inf_cfg = type("TinyBalloonInf", (type(inf_cfg),), tiny)()
    model = MaskRCNN("training", cfg, device="cpu")
    model.init_params(0)
    out = tsmoke.run_one("balloon", model, cfg, ds, 1, 2, lr=1e-3,
                         val_ds=val_ds, min_map=0.5, inf_cfg=inf_cfg,
                         decay_after=0.5)
    assert out["steps"] == 2 and len(out["loss_curve"]) == 2
    assert np.isfinite(out["loss_curve"]).all()
    assert out["eval_images"] == 1 and 0.0 <= out["map50"] <= 1.0
    assert out["map50_pass"] == (out["map50"] >= 0.5)
    (img,) = out["per_image"]
    assert abs(img["ap"] - out["map50"]) <= 5e-4
    assert len(img["best_box_iou"]) == 1


def test_samples_import_without_jax_cv2_h5py_pil_matplotlib(tmp_path):
    """The slice's modules run with jax, flax, cv2, h5py, PIL and
    matplotlib blocked (none is installed where the port runs) and load no
    module of the JAX package: the Augmenter, the RLE core and the COCO
    stack work, and every new entry point defaults to the card (raising
    without one)."""
    import subprocess
    import sys

    code = r"""
import sys
for m in ("jax", "flax", "cv2", "h5py", "PIL", "matplotlib"):
    sys.modules[m] = None
import numpy as np
import chip_smoke
import slam_maskrcnn_tpu_torch.testing
from slam_maskrcnn_tpu_torch.data import augment as A
from slam_maskrcnn_tpu_torch.eval import rle
from slam_maskrcnn_tpu_torch.eval.cocoeval import COCOevalLite
from slam_maskrcnn_tpu_torch.samples import (balloon, coco, dataset_audit,
                                             mask_image, mini_coco, nucleus,
                                             sample_train_smoke)
bad = [m for m in sys.modules if m.startswith("slam_maskrcnn_tpu.")
       or m == "slam_maskrcnn_tpu"]
assert not bad, bad
img = np.full((40, 50, 3), 90, np.uint8)
mask = np.zeros((40, 50, 2), bool)
mask[5:20, 5:30] = True
aug = A.Sequential([A.Affine(rotate=30), A.GaussianBlur(1.5),
                    A.CropAndPad(0.1), A.Fliplr(1.0)])
im, mk = aug(img, mask, np.random.default_rng(0))
assert im.shape == img.shape and mk.any()
r = rle.rle_encode(mk[..., 0].astype(np.uint8))
assert rle.rle_area(r) == int(mk[..., 0].sum())
root = sys.argv[1]
mini_coco.main(["generate", "--dir", root, "--images", "2"])
raised = []
for call in (lambda: nucleus.main(["detect", "--dataset", root]),
             lambda: mini_coco.main(["evaluate", "--dir", root]),
             lambda: balloon.main(["splash", "--image", "x.png"]),
             lambda: coco.main(["evaluate", "--dataset", root]),
             lambda: sample_train_smoke.main(["--samples", "balloon",
                                              "--out", root + "/s.json"])):
    try:
        call()
    except RuntimeError as e:
        raised.append("CUDA" in str(e))
print(raised)
"""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=repo)
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=repo, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == str([True] * 5), out.stdout


@pytest.mark.parametrize("sample", ["balloon", "nucleus"])
def test_smoke_gate_batches_match_jax(tmp_path, sample):
    """The gates' training batches: the smoke trees through each sample's
    dataset and data_generator, molded as the sample's config molds them
    (balloon "square" with padding, nucleus "crop"; cut to 256 and 128
    px), bit-equal to the JAX package's under the same seeds."""
    from slam_maskrcnn_tpu.data.dataset import data_generator as jgen
    from slam_maskrcnn_tpu_torch.data.dataset import data_generator as tgen

    if sample == "balloon":
        jsmoke.make_balloon_tree(str(tmp_path), n=4)
        over = dict(IMAGE_MIN_DIM=200, IMAGE_MAX_DIM=256)
        jc = type("J", (jballoon.BalloonConfig,), over)()
        tc = type("T", (tballoon.BalloonConfig,), over)()
        jd, td = jballoon.BalloonDataset(), tballoon.BalloonDataset()
        jd.load_balloon(str(tmp_path), "train")
        td.load_balloon(str(tmp_path), "train")
    else:
        jsmoke.make_nucleus_tree(str(tmp_path), n=4)
        over = dict(IMAGE_MIN_DIM=128, IMAGE_MAX_DIM=128, IMAGES_PER_GPU=2)
        jc = type("J", (jnuc.NucleusConfig,), over)()
        tc = type("T", (tnuc.NucleusConfig,), over)()
        jd, td = jnuc.NucleusDataset(), tnuc.NucleusDataset()
        jd.load_nucleus(str(tmp_path), "stage1_train")
        td.load_nucleus(str(tmp_path), "stage1_train")
    jd.prepare()
    td.prepare()
    np.random.seed(1)
    jb = [b for _, b in zip(range(3), jgen(jd, jc, seed=2))]
    np.random.seed(1)
    tb = [b for _, b in zip(range(3), tgen(td, tc, seed=2))]
    for j, t in zip(jb, tb):
        for k in j:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert (np.stack([b["gt_class_ids"] for b in tb]) > 0).sum() >= 6
