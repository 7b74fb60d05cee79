"""COCO-protocol detection evaluation (COCOeval-lite).

Port of slam_maskrcnn_tpu/eval/cocoeval.py, host-side numpy as there. A
compact, dependency-free implementation of the pycocotools COCOeval
protocol the reference runs (``Mask_RCNN/samples/coco/coco.py:342-391`` via
the vendored ``pycocotools/cocoeval.py``): per-class greedy matching at IoU
thresholds 0.5:0.05:0.95, area-range and maxDets breakdowns, the standard
12-line summary. Works on in-memory ground truth + results (boxes or RLE
masks via eval/rle.py).

Structured like pycocotools so a 5k-image eval is feasible: annotations are
indexed by (image, class) once, the IoU matrix is computed once per
(image, class) (it is area/maxDets-independent), greedy matching runs once
per (image, class, area) at the largest maxDets, and the smaller maxDets
settings are exact score-order slices of those matches (greedy matching of
the top-k detections is unaffected by later detections).
"""

from __future__ import annotations

import numpy as np

from slam_maskrcnn_tpu_torch.eval.rle import rle_iou

AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def _box_iou(d, g, iscrowd):
    y1 = np.maximum(d[:, None, 0], g[None, :, 0])
    x1 = np.maximum(d[:, None, 1], g[None, :, 1])
    y2 = np.minimum(d[:, None, 2], g[None, :, 2])
    x2 = np.minimum(d[:, None, 3], g[None, :, 3])
    inter = np.maximum(y2 - y1, 0) * np.maximum(x2 - x1, 0)
    ad = (d[:, 2] - d[:, 0]) * (d[:, 3] - d[:, 1])
    ag = (g[:, 2] - g[:, 0]) * (g[:, 3] - g[:, 1])
    union = ad[:, None] + ag[None, :] - inter
    union = np.where(np.asarray(iscrowd)[None, :], ad[:, None], union)
    return inter / np.maximum(union, 1e-10)


# COCO 17-keypoint OKS sigmas (pycocotools cocoeval.py:523, the
# Params.kpt_oks_sigmas default)
COCO_KPT_SIGMAS = np.array(
    [.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62,
     1.07, 1.07, .87, .87, .89, .89]) / 10.0


def _oks_iou(dts, gts, sigmas):
    """Object-keypoint-similarity matrix [len(dts), len(gts)]
    (= pycocotools computeOks, cocoeval.py:203-235): per-keypoint
    Gaussian falloff normalized by sigma and gt area, averaged over the
    gt's labeled keypoints; a gt with NO labeled keypoints falls back to
    distances outside its doubled bbox. dts are score-sorted by the
    caller. Keypoints are flat [x0, y0, v0, x1, y1, v1, ...]; gt bbox
    here is COCO [x, y, w, h]."""
    vars_ = (sigmas * 2.0) ** 2
    k = len(sigmas)
    ious = np.zeros((len(dts), len(gts)))
    for j, gt in enumerate(gts):
        g = np.asarray(gt["keypoints"], np.float64)
        xg, yg, vg = g[0::3], g[1::3], g[2::3]
        k1 = int(np.count_nonzero(vg > 0))
        x, y, w, h = [float(v) for v in gt["kpt_bbox"]]
        x0, x1 = x - w, x + w * 2
        y0, y1 = y - h, y + h * 2
        for i, dt in enumerate(dts):
            d = np.asarray(dt["keypoints"], np.float64)
            xd, yd = d[0::3], d[1::3]
            if k1 > 0:
                dx, dy = xd - xg, yd - yg
            else:
                z = np.zeros(k)
                dx = (np.maximum(z, x0 - xd) + np.maximum(z, xd - x1))
                dy = (np.maximum(z, y0 - yd) + np.maximum(z, yd - y1))
            e = ((dx ** 2 + dy ** 2) / vars_
                 / (float(gt["area"]) + np.spacing(1)) / 2.0)
            if k1 > 0:
                e = e[vg > 0]
            ious[i, j] = np.sum(np.exp(-e)) / e.shape[0]
    return ious


class COCOevalLite:
    """Evaluate detections against ground truth.

    gts: list of dicts per image:
      {image_id, class_id, bbox [y1,x1,y2,x2] or rle, area, iscrowd};
      keypoint eval adds keypoints [x0,y0,v0,...] and kpt_bbox [x,y,w,h].
    dts: same + score.
    iou_type: "bbox" | "segm" | "keypoints" (OKS).
    """

    def __init__(self, gts, dts, iou_type="bbox",
                 iou_thrs=None, max_dets=(1, 10, 100), kpt_sigmas=None):
        self.iou_type = iou_type
        self.iou_thrs = (np.arange(0.5, 1.0, 0.05)
                         if iou_thrs is None else np.asarray(iou_thrs))
        self.max_dets = max_dets
        self.recall_thrs = np.linspace(0, 1, 101)
        self.kpt_sigmas = (COCO_KPT_SIGMAS if kpt_sigmas is None
                           else np.asarray(kpt_sigmas, np.float64))
        self.gts = gts
        self.dts = dts
        self.img_ids = sorted({g["image_id"] for g in gts}
                              | {d["image_id"] for d in dts})
        self.cat_ids = sorted({g["class_id"] for g in gts})
        self.stats = None

    def _iou(self, dts, gts):
        if not dts or not gts:
            return np.zeros((len(dts), len(gts)))
        crowd = [bool(g.get("iscrowd", 0)) for g in gts]
        if self.iou_type == "segm":
            return rle_iou([d["rle"] for d in dts], [g["rle"] for g in gts],
                           iscrowd=crowd)
        if self.iou_type == "keypoints":
            return _oks_iou(dts, gts, self.kpt_sigmas)
        return _box_iou(np.asarray([d["bbox"] for d in dts], np.float64),
                        np.asarray([g["bbox"] for g in gts], np.float64),
                        crowd)

    def _index(self):
        """Index annotations by (image, class) and pre-sort/pre-IoU once."""
        if getattr(self, "_by_ic", None) is not None:
            return
        by_ic_g: dict = {}
        by_ic_d: dict = {}
        for g in self.gts:
            by_ic_g.setdefault((g["image_id"], g["class_id"]), []).append(g)
        for d in self.dts:
            by_ic_d.setdefault((d["image_id"], d["class_id"]), []).append(d)
        max_det = max(self.max_dets)
        self._by_ic = {}
        for key in set(by_ic_g) | set(by_ic_d):
            gts = by_ic_g.get(key, [])
            dts = sorted(by_ic_d.get(key, []),
                         key=lambda d: -d["score"])[:max_det]
            self._by_ic[key] = (gts, dts, self._iou(dts, gts))

    def _evaluate_img(self, img_id, cat_id, area_rng):
        """Greedy matching for one (image, class, area) at the largest
        maxDets (= pycocotools evaluateImg; smaller maxDets are slices)."""
        gts, dts, ious_full = self._by_ic.get((img_id, cat_id),
                                              ([], [], None))
        if not gts and not dts:
            return None
        for g in gts:
            g["_ignore"] = (g.get("iscrowd", 0)
                            or g["area"] < area_rng[0]
                            or g["area"] > area_rng[1])
        order = sorted(range(len(gts)), key=lambda i: gts[i]["_ignore"])
        gts = [gts[i] for i in order]
        ious = (ious_full[:, order] if len(gts) and len(dts)
                else np.zeros((len(dts), len(gts))))

        T = len(self.iou_thrs)
        gt_m = np.zeros((T, len(gts)))
        dt_m = np.zeros((T, len(dts)))
        dt_ig = np.zeros((T, len(dts)))
        # explicit bool dtype: an empty list would default to float64 and
        # `~` on floats raises (hit when an image has detections of a
        # class with no ground truth of that class)
        g_ig = np.array([g["_ignore"] for g in gts], dtype=bool)
        for t, thr in enumerate(self.iou_thrs):
            for di in range(len(dts)):
                best = min(thr, 1 - 1e-10)
                m = -1
                for gi in range(len(gts)):
                    if gt_m[t, gi] > 0 and not gts[gi].get("iscrowd", 0):
                        continue
                    if m > -1 and not g_ig[m] and g_ig[gi]:
                        break
                    if ious[di, gi] < best:
                        continue
                    best = ious[di, gi]
                    m = gi
                if m == -1:
                    continue
                dt_ig[t, di] = g_ig[m]
                dt_m[t, di] = 1
                gt_m[t, m] = 1
        # unmatched dets outside the area range are ignored
        a = np.array([(d["area"] < area_rng[0] or d["area"] > area_rng[1])
                      for d in dts], bool) if dts else np.zeros((0,), bool)
        dt_ig = np.logical_or(dt_ig.astype(bool),
                              (dt_m == 0) & a[None, :])
        return dict(dt_scores=[d["score"] for d in dts], dt_m=dt_m,
                    dt_ig=dt_ig, n_gt=int((~g_ig).sum()))

    def evaluate(self):
        """Accumulate AP/AR over classes, IoU thresholds, areas, maxDets.

        Matching runs once per (class, area, image); each maxDets setting
        is an exact slice of those matches (pycocotools accumulate
        structure)."""
        self._index()
        results = {}
        T = len(self.iou_thrs)
        for area_name, area_rng in AREA_RANGES.items():
            # per (cat): matches at the largest maxDets, then slice
            acc = {md: dict(ap=[], ar=[],
                            ap_per_t=[[] for _ in range(T)])
                   for md in self.max_dets}
            for cat in self.cat_ids:
                evs = [self._evaluate_img(i, cat, area_rng)
                       for i in self.img_ids]
                evs = [e for e in evs if e is not None]
                if not evs:
                    continue
                n_gt = sum(e["n_gt"] for e in evs)
                if n_gt == 0:
                    continue
                for max_det in self.max_dets:
                    # slice each image's detections to max_det (they are
                    # stored score-sorted per image), then merge-sort
                    scores = np.concatenate(
                        [np.asarray(e["dt_scores"][:max_det]) for e in evs])
                    order = np.argsort(-scores, kind="mergesort")
                    aps, ars = [], []
                    for t in range(T):
                        dm = np.concatenate(
                            [e["dt_m"][t][:max_det] for e in evs])[order]
                        dig = np.concatenate(
                            [e["dt_ig"][t][:max_det] for e in evs])[order]
                        keep = ~dig.astype(bool)
                        tp = np.cumsum(dm[keep] > 0)
                        fp = np.cumsum(dm[keep] == 0)
                        rc = tp / n_gt
                        pr = tp / np.maximum(tp + fp, 1e-10)
                        # precision envelope + 101-point interpolation
                        for i in range(len(pr) - 1, 0, -1):
                            pr[i - 1] = max(pr[i - 1], pr[i])
                        inds = np.searchsorted(rc, self.recall_thrs,
                                               side="left")
                        q = np.array([pr[i] if i < len(pr) else 0.0
                                      for i in inds])
                        aps.append(q.mean())
                        ars.append(rc[-1] if len(rc) else 0.0)
                        acc[max_det]["ap_per_t"][t].append(q.mean())
                    acc[max_det]["ap"].append(np.mean(aps))
                    acc[max_det]["ar"].append(np.mean(ars))
            for max_det in self.max_dets:
                a = acc[max_det]
                results[(area_name, max_det)] = dict(
                    ap=float(np.mean(a["ap"])) if a["ap"] else float("nan"),
                    ar=float(np.mean(a["ar"])) if a["ar"] else float("nan"),
                    ap_per_thr=[float(np.mean(x)) if x else float("nan")
                                for x in a["ap_per_t"]])
        self.stats = results
        return results

    def summarize(self, out=print):
        """The standard 12-line COCO summary."""
        if self.stats is None:
            self.evaluate()
        r = self.stats
        md = max(self.max_dets)
        lines = [
            ("Average Precision  (AP) @[ IoU=0.50:0.95 | area=   all | "
             f"maxDets={md:3d} ] = {r[('all', md)]['ap']:.3f}"),
            ("Average Precision  (AP) @[ IoU=0.50      | area=   all | "
             f"maxDets={md:3d} ] = {r[('all', md)]['ap_per_thr'][0]:.3f}"),
            ("Average Precision  (AP) @[ IoU=0.75      | area=   all | "
             f"maxDets={md:3d} ] = {r[('all', md)]['ap_per_thr'][5]:.3f}"),
        ]
        for a in ("small", "medium", "large"):
            lines.append(
                f"Average Precision  (AP) @[ IoU=0.50:0.95 | area={a:>6s} | "
                f"maxDets={md:3d} ] = {r[(a, md)]['ap']:.3f}")
        for m in self.max_dets:
            lines.append(
                "Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | "
                f"maxDets={m:3d} ] = {r[('all', m)]['ar']:.3f}")
        for a in ("small", "medium", "large"):
            lines.append(
                f"Average Recall     (AR) @[ IoU=0.50:0.95 | area={a:>6s} | "
                f"maxDets={md:3d} ] = {r[(a, md)]['ar']:.3f}")
        for ln in lines:
            out(ln)
        return lines
