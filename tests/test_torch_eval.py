"""The port's COCO eval stack (eval/rle.py with its g++-built core
csrc/rle.cpp, eval/cocoeval.py, eval/coco_api.py) against the JAX
package's on the CPU.

Bars: RLE counts, strings, decodes, merges, areas and boxes bit-equal to
the JAX package's and to the port's plain numpy versions; ``rle_iou``
within 1e-12; ``COCOevalLite`` stats (bbox, segm, keypoints, every area
range, maxDets and IoU threshold) within 1e-12; the hand goldens of
tests/test_eval_goldens.py reproduced exactly; ``COCO`` index queries,
``loadRes`` and ``annToMask`` (polygons filled as cv2.fillPoly) equal to
the JAX package's."""

import copy
import json

import numpy as np
import pytest

import test_eval_goldens as G
from slam_maskrcnn_tpu.eval import rle as jrle
from slam_maskrcnn_tpu.eval.coco_api import COCO as JCOCO
from slam_maskrcnn_tpu.eval.cocoeval import COCOevalLite as JEval
from slam_maskrcnn_tpu_torch.eval import rle
from slam_maskrcnn_tpu_torch.eval.coco_api import COCO
from slam_maskrcnn_tpu_torch.eval.cocoeval import COCOevalLite, _oks_iou


def _masks(seed, n=6, h=37, w=53):
    rng = np.random.default_rng(seed)
    out = [(rng.random((h, w)) < p).astype(np.uint8)
           for p in rng.uniform(0.05, 0.6, n)]
    out[0][:] = 0                                    # empty
    out[1][:] = 1                                    # full: counts start 0
    out[2][:, 3:9] = 1                               # a column block
    return out


def test_native_core_is_built_from_csrc():
    lib = rle.native()
    assert lib is rle.native()
    assert rle.library_path().endswith(".so")
    assert "rle-" in rle.library_path()


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """No numpy fallback: a failed g++ build raises."""
    monkeypatch.setattr(rle, "_lib", None)
    monkeypatch.setattr(rle, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(rle, "GXX_FLAGS", ("-O3", "--no-such-flag"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        rle.rle_encode(np.ones((3, 3), np.uint8))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rle_codec_matches_jax_and_plain(seed):
    ms = _masks(seed)
    for m in ms:
        r = rle.rle_encode(m)
        np.testing.assert_array_equal(r["counts"],
                                      jrle.rle_encode(m)["counts"])
        np.testing.assert_array_equal(r["counts"],
                                      rle.rle_encode_plain(m)["counts"])
        assert r["size"] == [m.shape[0], m.shape[1]]
        np.testing.assert_array_equal(rle.rle_decode(r), m)
        np.testing.assert_array_equal(rle.rle_decode_plain(r), m)
        assert rle.rle_area(r) == rle.rle_area_plain(r) == int(m.sum())
        s = rle.counts_to_string(r["counts"])
        assert s == jrle.counts_to_string(r["counts"])
        np.testing.assert_array_equal(rle.string_to_counts(s), r["counts"])
        assert rle.mask_to_rle_string(m) == jrle.mask_to_rle_string(m)
        np.testing.assert_array_equal(rle.rle_to_bbox(r),
                                      jrle.rle_to_bbox(r))
    # a short RLE leaves the tail zero on both paths
    short = {"size": [5, 4], "counts": np.array([3, 4], np.uint32)}
    np.testing.assert_array_equal(rle.rle_decode(short),
                                  rle.rle_decode_plain(short))
    np.testing.assert_array_equal(rle.rle_decode(short),
                                  jrle.rle_decode(short))


@pytest.mark.parametrize("seed", [0, 1])
def test_rle_merge_and_iou_match_jax(seed):
    rs = [rle.rle_encode(m) for m in _masks(seed + 10)]
    for intersect in (False, True):
        for k in (2, 3, len(rs)):
            got = rle.rle_merge(rs[:k], intersect)["counts"]
            np.testing.assert_array_equal(
                got, jrle.rle_merge(rs[:k], intersect)["counts"])
            np.testing.assert_array_equal(
                got, rle.rle_merge_plain(rs[:k], intersect)["counts"])
    crowd = [False, True, False, True, False, False]
    got = rle.rle_iou(rs, rs[::-1], iscrowd=crowd)
    np.testing.assert_allclose(got, jrle.rle_iou(rs, rs[::-1],
                                                 iscrowd=crowd),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, rle.rle_iou_plain(rs, rs[::-1],
                                                      iscrowd=crowd),
                               rtol=0, atol=1e-12)


def test_hand_goldens():
    """tests/test_eval_goldens.py's hand-derived values, on the port."""
    np.testing.assert_array_equal(rle.rle_encode(G.M1)["counts"],
                                  G.M1_COUNTS)
    np.testing.assert_array_equal(rle.rle_encode(G.M_TOP)["counts"],
                                  G.M_TOP_COUNTS)
    np.testing.assert_array_equal(rle.rle_encode(G.M_LEFT)["counts"],
                                  G.M_LEFT_COUNTS)
    np.testing.assert_array_equal(
        rle.rle_decode({"size": [4, 4], "counts": np.asarray(G.M1_COUNTS)}),
        G.M1)
    assert rle.counts_to_string(np.asarray(G.M1_COUNTS, np.uint32)) \
        == G.M1_STRING
    assert rle.counts_to_string(np.asarray([0, 300], np.uint32)) == "0\\9"
    np.testing.assert_array_equal(rle.string_to_counts("0\\9"), [0, 300])
    top, left = rle.rle_encode(G.M_TOP), rle.rle_encode(G.M_LEFT)
    np.testing.assert_allclose(rle.rle_iou([top], [left]), [[4.0 / 12.0]],
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(rle.rle_iou([top], [left], iscrowd=[True]),
                               [[0.5]], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(rle.rle_merge([top, left])["counts"],
                                  [0, 10, 2, 2, 2])
    np.testing.assert_array_equal(
        rle.rle_merge([top, left], intersect=True)["counts"],
        [0, 2, 2, 2, 10])
    np.testing.assert_array_equal(
        rle.rle_to_bbox({"size": [4, 4], "counts": np.asarray(G.M1_COUNTS)}),
        [0, 0, 4, 4])
    np.testing.assert_array_equal(
        rle.fr_py_objects([1.0, 1.0, 1.0, 2.0], 4, 4)["counts"], [5, 2, 9])


@pytest.mark.parametrize("thr,ap,ar,crowd", [
    (0.5, 56.0 / 101.0, 2.0 / 3.0, False),
    (0.75, 34.0 / 101.0, 1.0 / 3.0, False),
    (0.5, 67.0 / 101.0, 2.0 / 3.0, True)])
def test_cocoeval_hand_table(thr, ap, ar, crowd):
    gts = copy.deepcopy(G.GTS)
    if crowd:
        gts.append(dict(image_id=1, class_id=1, bbox=[40, 40, 48, 48],
                        area=64, iscrowd=1))
    r = COCOevalLite(gts, copy.deepcopy(G.DTS), iou_type="bbox",
                     iou_thrs=[thr]).evaluate()[("all", 100)]
    np.testing.assert_allclose([r["ap"], r["ar"]], [ap, ar], rtol=0,
                               atol=1e-12)


def test_oks_and_keypoint_goldens():
    sig = np.array([0.5, 0.5])
    gt = [dict(keypoints=[10, 10, 2, 20, 10, 2], kpt_bbox=[5, 5, 20, 10],
               area=100.0)]
    dt = [dict(keypoints=[10, 12, 2, 20, 10, 2])]
    np.testing.assert_allclose(_oks_iou(dt, gt, sig)[0, 0],
                               (np.exp(-0.02) + 1.0) / 2.0, rtol=0,
                               atol=1e-12)
    gts = [dict(image_id=1, class_id=1, keypoints=[10, 10, 2, 20, 10, 2],
                kpt_bbox=[5, 5, 20, 10], area=100.0, iscrowd=0)]
    dts = [dict(image_id=1, class_id=1, keypoints=[10, 12, 2, 20, 10, 2],
                area=100.0, score=0.9)]
    for thr, want in ((0.5, 1.0), (0.995, 0.0)):
        ev = COCOevalLite(gts, dts, iou_type="keypoints", iou_thrs=[thr],
                          max_dets=(20,), kpt_sigmas=[0.5, 0.5])
        assert ev.evaluate()[("all", 20)]["ap"] == want
    g = [dict(image_id=1, class_id=1, rle=rle.rle_encode(G.M_LEFT), area=8,
              iscrowd=0)]
    d = [dict(image_id=1, class_id=1, rle=rle.rle_encode(G.M_TOP), area=8,
              score=0.9)]
    assert COCOevalLite(g, d, iou_type="segm", iou_thrs=[0.5]).evaluate()[
        ("all", 100)]["ap"] == 0.0


def _random_eval_sets(seed, kind):
    """Ground truth and detections over 4 images and 3 classes, some
    crowds, sizes across the small / medium / large ranges; detections
    jittered from the gt plus false positives."""
    rng = np.random.default_rng(seed)
    H = W = 160
    gts, dts = [], []
    for img in range(4):
        for k in range(int(rng.integers(3, 8))):
            cls = int(rng.integers(1, 4))
            h, w = rng.uniform(4, 120, 2)
            y, x = rng.uniform(0, H - h), rng.uniform(0, W - w)
            g = dict(image_id=img, class_id=cls, iscrowd=int(k == 5),
                     bbox=[y, x, y + h, x + w], area=float(h * w))
            m = np.zeros((H, W), np.uint8)
            m[int(y):int(y + h), int(x):int(x + w)] = 1
            g["rle"] = rle.rle_encode(m)
            kp = np.stack([rng.uniform(x, x + w, 17),
                           rng.uniform(y, y + h, 17),
                           rng.integers(0, 3, 17)], -1)
            g["keypoints"] = kp.reshape(-1).tolist()
            g["kpt_bbox"] = [x, y, w, h]
            if kind == "segm":
                g["area"] = float(m.sum())
            gts.append(g)
            for _ in range(int(rng.integers(0, 3))):
                d = copy.deepcopy(g)
                d.pop("iscrowd")
                j = rng.normal(0, 0.08 * max(h, w), 4)
                d["bbox"] = [d["bbox"][0] + j[0], d["bbox"][1] + j[1],
                             d["bbox"][2] + j[2], d["bbox"][3] + j[3]]
                dm = np.roll(m, (int(j[0]), int(j[1])), (0, 1))
                d["rle"] = rle.rle_encode(dm)
                d["keypoints"] = (kp + np.c_[rng.normal(0, 3, (17, 2)),
                                             np.zeros(17)]).reshape(-1)
                d["score"] = float(rng.uniform(0.05, 1.0))
                d["class_id"] = cls if rng.random() < 0.85 else 1 + cls % 3
                if kind == "segm":
                    d["area"] = float(dm.sum())
                dts.append(d)
    return gts, dts


@pytest.mark.parametrize("kind", ["bbox", "segm", "keypoints"])
@pytest.mark.parametrize("seed", [0, 1])
def test_cocoeval_matches_jax(kind, seed):
    gts, dts = _random_eval_sets(seed, kind)
    want = JEval(copy.deepcopy(gts), copy.deepcopy(dts),
                 iou_type=kind).evaluate()
    ev = COCOevalLite(gts, dts, iou_type=kind)
    got = ev.evaluate()
    assert sorted(got) == sorted(want)
    n = 0
    for key in want:
        for field in ("ap", "ar"):
            np.testing.assert_allclose(got[key][field], want[key][field],
                                       rtol=0, atol=1e-12, equal_nan=True)
        np.testing.assert_allclose(got[key]["ap_per_thr"],
                                   want[key]["ap_per_thr"], rtol=0,
                                   atol=1e-12, equal_nan=True)
        n += np.isfinite(got[key]["ap"])
    assert n >= 6
    assert len(ev.summarize(out=lambda s: None)) == 12


def _coco_json(seed):
    """A small COCO annotation document: polygons (concave, overhanging
    the image), uncompressed and compressed RLE, a crowd."""
    rng = np.random.default_rng(seed)
    images = [{"id": i + 1, "file_name": f"{i}.png", "width": 90,
               "height": 70} for i in range(3)]
    cats = [{"id": 7, "name": "a", "supercategory": "s"},
            {"id": 9, "name": "b", "supercategory": "t"}]
    anns = []
    for i in range(12):
        img = images[i % 3]
        kind = i % 3
        if kind == 0:
            cx, cy = rng.uniform(-10, 100), rng.uniform(-10, 80)
            th = np.sort(rng.uniform(0, 2 * np.pi, 9))
            r = rng.uniform(5, 40, 9)
            seg = [np.stack([cx + r * np.cos(th), cy + r * np.sin(th)],
                            -1).reshape(-1).round(2).tolist()]
        else:
            m = np.zeros((70, 90), np.uint8)
            y, x = rng.integers(0, 50), rng.integers(0, 70)
            m[y:y + 15, x:x + 18] = 1
            r_ = rle.rle_encode(m)
            seg = {"size": r_["size"],
                   "counts": ([int(c) for c in r_["counts"]] if kind == 1
                              else rle.counts_to_string(r_["counts"]))}
        anns.append({"id": i + 1, "image_id": img["id"],
                     "category_id": cats[i % 2]["id"], "segmentation": seg,
                     "area": float(100 + i), "iscrowd": int(i == 4),
                     "bbox": [1.0, 2.0, 3.0, 4.0]})
    return {"images": images, "categories": cats, "annotations": anns}


@pytest.mark.parametrize("seed", [0, 1])
def test_coco_api_matches_jax(seed, tmp_path):
    doc = _coco_json(seed)
    path = tmp_path / "ann.json"
    path.write_text(json.dumps(doc))
    j, t = JCOCO(str(path)), COCO(str(path))
    assert sorted(t.getAnnIds()) == sorted(j.getAnnIds())
    assert t.getAnnIds(imgIds=[2], catIds=[9]) == j.getAnnIds(imgIds=[2],
                                                              catIds=[9])
    assert t.getAnnIds(areaRng=[103, 109], iscrowd=0) == \
        j.getAnnIds(areaRng=[103, 109], iscrowd=0)
    assert t.getCatIds(supNms=["t"]) == j.getCatIds(supNms=["t"])
    assert sorted(t.getImgIds(catIds=[7])) == sorted(j.getImgIds(catIds=[7]))
    for ann in t.loadAnns(t.getAnnIds()):
        np.testing.assert_array_equal(t.annToMask(ann), j.annToMask(ann))
        np.testing.assert_array_equal(t.annToRLE(ann)["counts"],
                                      j.annToRLE(ann)["counts"])
    assert sum(t.annToMask(a).sum() for a in t.loadAnns(t.getAnnIds())) > 0
    res = [{"image_id": 1 + k % 3, "category_id": 7, "score": 0.5,
            "bbox": [3.0 + k, 4.0, 10.0, 12.0]} for k in range(4)]
    m = np.zeros((70, 90), np.uint8)
    m[10:30, 20:41] = 1
    res.append({"image_id": 2, "category_id": 9, "score": 0.7,
                "segmentation": rle.mask_to_rle_string(m)})
    rt, rj = t.loadRes(copy.deepcopy(res)), j.loadRes(copy.deepcopy(res))
    assert rt.dataset["annotations"] == rj.dataset["annotations"]
    nump = np.array([[1, 5.0, 6.0, 7.0, 8.0, 0.3, 7]])
    assert t.loadNumpyAnnotations(nump) == j.loadNumpyAnnotations(nump)
    with pytest.raises(ValueError, match="unknown image"):
        t.loadRes([{"image_id": 99, "category_id": 7, "bbox": [0, 0, 1, 1],
                    "score": 1.0}])


@pytest.mark.parametrize("seed", [0, 1])
def test_fr_py_objects_matches_jax(seed):
    """Polygons (rounded float vertices, concave, partly outside),
    boxes and RLE dicts, single and listed."""
    rng = np.random.default_rng(seed + 40)
    h, w = 50, 70
    polys = []
    for _ in range(6):
        cx, cy = rng.uniform(-5, 75), rng.uniform(-5, 55)
        th = np.sort(rng.uniform(0, 2 * np.pi, 12))
        r = rng.uniform(3, 35, 12)
        polys.append(np.stack([cx + r * np.cos(th), cy + r * np.sin(th)],
                              -1).reshape(-1).tolist())
    boxes = [[5.4, 8.6, 10.2, 12.5], [-3.0, 40.0, 20.0, 30.0]]
    cases = [polys, polys[0], boxes, boxes[0], np.asarray(boxes),
             {"size": [h, w], "counts": [10, 20, 30]},
             [{"size": [h, w], "counts": rle.counts_to_string(
                 np.array([3, 5, 7], np.uint32))}]]
    for obj in cases:
        got, want = rle.fr_py_objects(obj, h, w), jrle.fr_py_objects(obj, h, w)
        got = got if isinstance(got, list) else [got]
        want = want if isinstance(want, list) else [want]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a["counts"], b["counts"])
    assert sum(rle.rle_area(r) for r in rle.fr_py_objects(polys, h, w)) > 0
