"""Single/multi-object tracking mask pipeline with template-match fallback.

Port of slam_maskrcnn_tpu/samples/mask_image.py, which is
``Mask_RCNN/mask_image.py`` / ``multi_mask_image.py`` (the earlier
per-object variant drivers): detect candidate classes directly; when a
target is lost, fall back to template matching against the previous
target crop (expanded 25%), re-run detection on the crop and map boxes
back to full-frame coordinates (mask_image.py:117-145); union direct and
template results by IoU (:163-183); median±range depth filter (:104-112);
write rgb_mask/gray_mask images and a detection log (:148-160, 305-307).

The JAX package matches templates with cv2.matchTemplate
(TM_CCOEFF_NORMED) and cv2.minMaxLoc; the port computes the same
normalised cross-correlation in torch on the model's device
(``match_template``: float64, a convolution for the numerator, box sums
for the window statistics, OpenCV's rule where the window is flat) and
takes the first maximum in row-major order, as minMaxLoc does. Where the
maximum is unique both find the same location. Outputs are written by
data/png.py.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from slam_maskrcnn_tpu_torch.device import resolve_device

# the reference's candidate classes (mask_image.py:33)
CANDIDATE_CLASSES = ("bottle", "cup", "vase")


def calc_overlap_ratio(box1, box2):
    """IoU of (y1, x1, y2, x2) (mask_image.py:163-175)."""
    y1 = max(box1[0], box2[0])
    x1 = max(box1[1], box2[1])
    y2 = min(box1[2], box2[2])
    x2 = min(box1[3], box2[3])
    inter = max(y2 - y1, 0) * max(x2 - x1, 0)
    a1 = (box1[2] - box1[0]) * (box1[3] - box1[1])
    a2 = (box2[2] - box2[0]) * (box2[3] - box2[1])
    return inter / max(a1 + a2 - inter, 1e-9)


def depth_filter_median(depth, mask, dep_range=3000):
    """Median±range depth gate (mask_image.py:104-112)."""
    if not mask.any():
        return mask
    med = np.median(depth[mask])
    bad = (depth < med - dep_range) | (depth > med + dep_range)
    out = mask.copy()
    out[bad] = False
    return out


def pick_mask(result, class_names, candidates=CANDIDATE_CLASSES,
              prev_box=None):
    """Choose the tracked target among detections: a candidate class,
    preferring overlap with the previous box (mask_image.py:56-101)."""
    best = None
    best_key = (-1.0, -1.0)
    for i, cid in enumerate(result["class_ids"]):
        name = class_names[cid] if cid < len(class_names) else ""
        if name not in candidates:
            continue
        iou = (calc_overlap_ratio(result["rois"][i], prev_box)
               if prev_box is not None else 0.0)
        key = (iou, float(result["scores"][i]))
        if key > best_key:
            best_key = key
            best = i
    return best


def match_template(image, templ, device="cuda") -> torch.Tensor:
    """= cv2.matchTemplate(image, templ, cv2.TM_CCOEFF_NORMED) for u8
    [H, W, C] and [h, w, C] arrays: [H - h + 1, W - w + 1] float64 on
    ``device`` (the card unless the caller asks for the CPU). R = sum(T' I) / sqrt(sum(T'^2) sum(I'^2)) over the window
    and the channels, T' and I' less their per-channel means; where the
    denominator t is not above |numerator|, OpenCV's rule: +-1 below
    1.125 t, else 0."""
    device = resolve_device(device)
    img = torch.as_tensor(np.ascontiguousarray(image), device=device)
    tpl = torch.as_tensor(np.ascontiguousarray(templ), device=device)
    if img.dim() == 2:
        img, tpl = img[..., None], tpl[..., None]
    img = img.to(torch.float64).permute(2, 0, 1)[None]     # [1, C, H, W]
    tpl = tpl.to(torch.float64).permute(2, 0, 1)           # [C, h, w]
    C, h, w = tpl.shape
    n = float(h * w)
    tz = tpl - tpl.mean(dim=(1, 2), keepdim=True)
    num = F.conv2d(img, tz[None])[0, 0]
    ones = torch.ones((C, 1, h, w), dtype=torch.float64, device=img.device)
    s1 = F.conv2d(img, ones, groups=C)[0]                  # [C, H', W']
    s2 = F.conv2d(img * img, ones, groups=C)[0]
    var = (s2 - s1 * s1 / n).sum(0).clamp_min(0.0)
    t = torch.sqrt(var) * torch.sqrt((tz * tz).sum())
    a = num.abs()
    return torch.where(a < t, num / t, torch.where(
        a < t * 1.125, torch.sign(num), torch.zeros_like(num)))


def max_location(res: torch.Tensor) -> tuple[int, int]:
    """cv2.minMaxLoc's max_loc (x, y): the first maximum in row-major
    order."""
    i = int(torch.argmax(res.reshape(-1)))
    return i % res.shape[1], i // res.shape[1]


def template_match_mask_detect(model, rgb, prev_crop, prev_box,
                               class_names, expand=0.25):
    """Template-match fallback (mask_image.py:117-145): locate the previous
    target crop, expand the matched box 25%, re-run detection on the
    subimage, map results back to full-frame coordinates."""
    H, W = rgb.shape[:2]
    if prev_crop is None or prev_crop.size == 0:
        return None
    ph, pw = prev_crop.shape[:2]
    if ph >= H or pw >= W or ph < 8 or pw < 8:
        return None
    x0, y0 = max_location(match_template(rgb, prev_crop, model.device))
    dy, dx = int(ph * expand), int(pw * expand)
    y1 = max(y0 - dy, 0)
    x1 = max(x0 - dx, 0)
    y2 = min(y0 + ph + dy, H)
    x2 = min(x0 + pw + dx, W)
    sub = np.ascontiguousarray(rgb[y1:y2, x1:x2])
    r = model.detect([sub], verbose=0)[0]
    idx = pick_mask(r, class_names)
    if idx is None:
        return None
    # map back to full frame
    box = r["rois"][idx] + np.array([y1, x1, y1, x1])
    mask = np.zeros((H, W), bool)
    mask[y1:y2, x1:x2] = r["masks"][:, :, idx]
    return dict(box=box, mask=mask, class_id=int(r["class_ids"][idx]),
                score=float(r["scores"][idx]))


def union_mask_roi(direct, matched, iou_thresh=0.3):
    """Merge direct + template-match results by IoU
    (mask_image.py:163-183): agreement -> union mask; else prefer direct."""
    if direct is None:
        return matched
    if matched is None:
        return direct
    if calc_overlap_ratio(direct["box"], matched["box"]) >= iou_thresh:
        out = dict(direct)
        out["mask"] = direct["mask"] | matched["mask"]
        return out
    return direct


class ObjectTracker:
    """Frame-to-frame single-target tracker (the mask_image.py main loop,
    :200-307)."""

    def __init__(self, model, class_names, candidates=CANDIDATE_CLASSES,
                 dep_range=3000):
        self.model = model
        self.class_names = class_names
        self.candidates = candidates
        self.dep_range = dep_range
        self.prev_box = None
        self.prev_crop = None
        self.log = []

    def step(self, rgb, depth=None):
        """Returns dict(box, mask, class_id, score) or None."""
        r = self.model.detect([rgb], verbose=0)[0]
        idx = pick_mask(r, self.class_names, self.candidates, self.prev_box)
        direct = None
        if idx is not None:
            direct = dict(box=r["rois"][idx], mask=r["masks"][:, :, idx],
                          class_id=int(r["class_ids"][idx]),
                          score=float(r["scores"][idx]))
        matched = None
        if direct is None and self.prev_crop is not None:
            matched = template_match_mask_detect(
                self.model, rgb, self.prev_crop, self.prev_box,
                self.class_names)
        result = union_mask_roi(direct, matched)
        if result is not None:
            if depth is not None:
                result["mask"] = depth_filter_median(
                    depth, result["mask"], self.dep_range)
            y1, x1, y2, x2 = [int(v) for v in result["box"]]
            self.prev_box = result["box"]
            self.prev_crop = np.ascontiguousarray(rgb[y1:y2, x1:x2])
            self.log.append((self.class_names[result["class_id"]],
                             result["score"]))
        return result

    def write_outputs(self, rgb, result, out_rgb_dir, out_gray_dir, name):
        """rgb_mask / gray_mask outputs (mask_image.py:148-160)."""
        from slam_maskrcnn_tpu_torch.data.png import write_png

        os.makedirs(out_rgb_dir, exist_ok=True)
        os.makedirs(out_gray_dir, exist_ok=True)
        gray = np.zeros(rgb.shape[:2], np.uint8)
        vis = rgb.copy()
        if result is not None:
            gray[result["mask"]] = 255
            vis[~result["mask"]] //= 3
        write_png(os.path.join(out_rgb_dir, name),
                  np.ascontiguousarray(vis[:, :, ::-1]))
        write_png(os.path.join(out_gray_dir, name), gray)

    def write_log(self, path):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            for name, score in self.log:
                f.write(f"{name} {score:.4f}\n")
