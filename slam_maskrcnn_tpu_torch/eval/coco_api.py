"""COCO annotation API — the pycocotools ``COCO`` class surface.

Port of slam_maskrcnn_tpu/eval/coco_api.py (the reference's vendored
``Mask_RCNN/pycocotools/coco.py:66-433``): the same public methods over
plain COCO JSON, on the port's RLE codec (eval/rle.py). Differences kept
deliberately, as in the JAX package:

* polygons rasterise as cv2.fillPoly fills them (data/draw.py, the mask
  path of samples/coco.py) rather than by the upstream frPyObjects scan
  conversion: mask boundaries can differ by sub-pixel rounding;
* ``download`` is not provided (zero-egress environments; the reference's
  version just fetches image URLs);
* ``showAnns`` imports matplotlib when called, never at import.
"""

from __future__ import annotations

import copy
import json
import time

import numpy as np


def _as_list(x):
    return x if isinstance(x, (list, tuple, np.ndarray)) else [x]


class COCO:
    """Index over a COCO-format annotation dict or JSON file."""

    def __init__(self, annotation_file=None):
        self.dataset = {}
        self.anns, self.cats, self.imgs = {}, {}, {}
        self.imgToAnns, self.catToImgs = {}, {}
        if annotation_file is not None:
            if isinstance(annotation_file, dict):
                self.dataset = annotation_file
            else:
                t = time.time()
                with open(annotation_file) as f:
                    self.dataset = json.load(f)
                print(f"loading annotations took {time.time() - t:.2f}s")
            if not isinstance(self.dataset, dict):
                raise TypeError("annotation file must hold a JSON object")
            self.createIndex()

    def createIndex(self):
        self.anns = {a["id"]: a for a in self.dataset.get("annotations", [])}
        self.cats = {c["id"]: c for c in self.dataset.get("categories", [])}
        self.imgs = {i["id"]: i for i in self.dataset.get("images", [])}
        self.imgToAnns = {}
        self.catToImgs = {}
        for a in self.dataset.get("annotations", []):
            self.imgToAnns.setdefault(a["image_id"], []).append(a)
            self.catToImgs.setdefault(a["category_id"], []).append(
                a["image_id"])

    def info(self):
        for k, v in self.dataset.get("info", {}).items():
            print(f"{k}: {v}")

    def getAnnIds(self, imgIds=[], catIds=[], areaRng=[], iscrowd=None):
        imgIds, catIds = _as_list(imgIds), _as_list(catIds)
        if imgIds:
            anns = [a for i in imgIds for a in self.imgToAnns.get(i, [])]
        else:
            anns = list(self.anns.values())
        if catIds:
            wanted = set(catIds)
            anns = [a for a in anns if a["category_id"] in wanted]
        if areaRng:
            lo, hi = areaRng
            anns = [a for a in anns if lo < a["area"] < hi]
        if iscrowd is not None:
            anns = [a for a in anns if a.get("iscrowd", 0) == iscrowd]
        return [a["id"] for a in anns]

    def getCatIds(self, catNms=[], supNms=[], catIds=[]):
        catNms, supNms, catIds = map(_as_list, (catNms, supNms, catIds))
        cats = self.dataset.get("categories", [])
        if catNms:
            cats = [c for c in cats if c["name"] in catNms]
        if supNms:
            cats = [c for c in cats if c.get("supercategory") in supNms]
        if catIds:
            wanted = set(catIds)
            cats = [c for c in cats if c["id"] in wanted]
        return [c["id"] for c in cats]

    def getImgIds(self, imgIds=[], catIds=[]):
        imgIds, catIds = _as_list(imgIds), _as_list(catIds)
        ids = set(imgIds) if imgIds else set(self.imgs)
        for i, cat in enumerate(catIds):
            with_cat = set(self.catToImgs.get(cat, []))
            ids = with_cat if (i == 0 and not imgIds) else ids & with_cat
        return list(ids)

    def loadAnns(self, ids=[]):
        return [self.anns[i] for i in _as_list(ids)]

    def loadCats(self, ids=[]):
        return [self.cats[i] for i in _as_list(ids)]

    def loadImgs(self, ids=[]):
        return [self.imgs[i] for i in _as_list(ids)]

    def loadRes(self, resFile):
        """Detection results (list of dicts, or a JSON file of them) ->
        a new COCO holding them as annotations (coco.py:292-356 contract:
        images carried over, ids assigned, areas/bboxes derived)."""
        res = COCO()
        res.dataset = {"images": [img for img in
                                  self.dataset.get("images", [])]}
        if isinstance(resFile, str):
            with open(resFile) as f:
                anns = json.load(f)
        elif isinstance(resFile, np.ndarray):
            anns = self.loadNumpyAnnotations(resFile)
        else:
            anns = copy.deepcopy(resFile)
        if not isinstance(anns, list):
            raise TypeError("results must be a list of dicts")
        img_ids = {a["image_id"] for a in anns}
        if not img_ids <= set(self.imgs):
            raise ValueError("results reference unknown image ids")
        res.dataset["categories"] = copy.deepcopy(
            self.dataset.get("categories", []))
        # area/bbox are recomputed UNCONDITIONALLY (pycocotools
        # coco.py:318-342 contract): results carrying stale area fields
        # must not bucket into different area ranges than upstream would.
        # Branch order matches upstream: a bbox result gets area = w*h even
        # when it also carries a segmentation.
        for i, a in enumerate(anns):
            a["id"] = i + 1
            if "bbox" in a and a["bbox"] != []:
                x, y, w, h = a["bbox"]
                a["area"] = float(w * h)
                if "segmentation" not in a:
                    a["segmentation"] = [[x, y, x, y + h, x + w, y + h,
                                          x + w, y]]
            elif "segmentation" in a:
                m = _seg_mask(a["segmentation"])
                ys, xs = np.nonzero(m)
                if ys.size:
                    a["bbox"] = [float(xs.min()), float(ys.min()),
                                 float(xs.max() - xs.min() + 1),
                                 float(ys.max() - ys.min() + 1)]
                else:
                    a["bbox"] = [0.0, 0.0, 0.0, 0.0]
                a["area"] = float(m.sum())
            a.setdefault("iscrowd", 0)
        res.dataset["annotations"] = anns
        res.createIndex()
        return res

    def loadNumpyAnnotations(self, data):
        """[N, 7] float rows (imageID, x1, y1, w, h, score, class) ->
        result dicts (coco.py:382-403)."""
        data = np.asarray(data)
        if data.ndim != 2 or data.shape[1] != 7:
            raise ValueError("expected an [N, 7] array")
        return [{"image_id": int(r[0]),
                 "bbox": [float(r[1]), float(r[2]), float(r[3]), float(r[4])],
                 "score": float(r[5]),
                 "category_id": int(r[6])} for r in data]

    def annToRLE(self, ann):
        """Annotation segmentation -> native RLE dict {size, counts}
        (column-major counts, eval/rle.py form)."""
        from slam_maskrcnn_tpu_torch.eval.rle import rle_encode

        return rle_encode(self.annToMask(ann).astype(np.uint8))

    def annToMask(self, ann):
        """Annotation -> bool [H, W] (polygons, uncompressed or compressed
        RLE — the three upstream formats, coco.py:405-433)."""
        from slam_maskrcnn_tpu_torch.samples.coco import ann_to_mask

        img = self.imgs[ann["image_id"]]
        return ann_to_mask(ann, img["height"], img["width"])

    def showAnns(self, anns):
        """Draw polygon/bbox annotations on the current matplotlib axes."""
        import matplotlib.pyplot as plt
        from matplotlib.patches import Polygon, Rectangle

        ax = plt.gca()
        rng = np.random.default_rng(0)
        for ann in anns:
            color = rng.random(3) * 0.6 + 0.4
            seg = ann.get("segmentation")
            if isinstance(seg, list):
                for poly in seg:
                    pts = np.asarray(poly).reshape(-1, 2)
                    ax.add_patch(Polygon(pts, facecolor=list(color) + [0.4],
                                         edgecolor=color))
            elif "bbox" in ann:
                x, y, w, h = ann["bbox"]
                ax.add_patch(Rectangle((x, y), w, h, fill=False,
                                       edgecolor=color))


def _seg_mask(seg):
    from slam_maskrcnn_tpu_torch.eval.rle import rle_decode, string_to_counts

    counts = seg["counts"]
    if isinstance(counts, str):
        counts = string_to_counts(counts)
    return rle_decode({"size": seg["size"],
                       "counts": np.asarray(counts, np.uint32)})
