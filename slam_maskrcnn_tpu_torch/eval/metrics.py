"""Detection evaluation metrics (VOC-style mAP).

Copy of slam_maskrcnn_tpu/eval/metrics.py (the port keeps its own copy):
the reference's self-contained eval in ``Mask_RCNN/mrcnn/utils.py``:
``compute_matches`` (:661), ``compute_ap`` (:720), ``compute_ap_range``
(:759), ``compute_recall`` (:783). Pure numpy, mask-IoU based.
"""

from __future__ import annotations

import numpy as np


def compute_overlaps_masks(masks1: np.ndarray, masks2: np.ndarray):
    """Mask IoU [N1, N2]; masks [H, W, N] (utils.py:98-113)."""
    if masks1.shape[-1] == 0 or masks2.shape[-1] == 0:
        return np.zeros((masks1.shape[-1], masks2.shape[-1]))
    m1 = masks1.reshape(-1, masks1.shape[-1]).astype(np.float64)
    m2 = masks2.reshape(-1, masks2.shape[-1]).astype(np.float64)
    area1 = m1.sum(0)
    area2 = m2.sum(0)
    inter = m1.T @ m2
    union = area1[:, None] + area2[None, :] - inter
    return inter / np.maximum(union, 1e-10)


def compute_overlaps_boxes(boxes1, boxes2):
    y1 = np.maximum(boxes1[:, None, 0], boxes2[None, :, 0])
    x1 = np.maximum(boxes1[:, None, 1], boxes2[None, :, 1])
    y2 = np.minimum(boxes1[:, None, 2], boxes2[None, :, 2])
    x2 = np.minimum(boxes1[:, None, 3], boxes2[None, :, 3])
    inter = np.maximum(y2 - y1, 0) * np.maximum(x2 - x1, 0)
    a1 = (boxes1[:, 2] - boxes1[:, 0]) * (boxes1[:, 3] - boxes1[:, 1])
    a2 = (boxes2[:, 2] - boxes2[:, 0]) * (boxes2[:, 3] - boxes2[:, 1])
    return inter / np.maximum(a1[:, None] + a2[None, :] - inter, 1e-10)


def compute_matches(gt_boxes, gt_class_ids, gt_masks,
                    pred_boxes, pred_class_ids, pred_scores, pred_masks,
                    iou_threshold=0.5, score_threshold=0.0):
    """Greedy matching by descending score (utils.py:661-717).
    Returns (gt_match, pred_match, overlaps)."""
    indices = np.argsort(pred_scores)[::-1]
    pred_boxes = pred_boxes[indices]
    pred_class_ids = pred_class_ids[indices]
    pred_scores = pred_scores[indices]
    pred_masks = pred_masks[..., indices]

    overlaps = compute_overlaps_masks(pred_masks, gt_masks)

    pred_match = -1 * np.ones([pred_boxes.shape[0]])
    gt_match = -1 * np.ones([gt_boxes.shape[0]])
    for i in range(len(pred_boxes)):
        sorted_ixs = np.argsort(overlaps[i])[::-1]
        low_score_idx = np.where(
            overlaps[i, sorted_ixs] < score_threshold)[0]
        if low_score_idx.size > 0:
            sorted_ixs = sorted_ixs[:low_score_idx[0]]
        for j in sorted_ixs:
            if gt_match[j] > -1:
                continue
            if overlaps[i, j] < iou_threshold:
                break
            if pred_class_ids[i] == gt_class_ids[j]:
                gt_match[j] = i
                pred_match[i] = j
                break
    return gt_match, pred_match, overlaps


def compute_ap(gt_boxes, gt_class_ids, gt_masks,
               pred_boxes, pred_class_ids, pred_scores, pred_masks,
               iou_threshold=0.5):
    """VOC-style AP at one IoU (utils.py:720-756).
    Returns (mAP, precisions, recalls, overlaps)."""
    gt_match, pred_match, overlaps = compute_matches(
        gt_boxes, gt_class_ids, gt_masks,
        pred_boxes, pred_class_ids, pred_scores, pred_masks, iou_threshold)

    precisions = np.cumsum(pred_match > -1) / (np.arange(len(pred_match)) + 1)
    recalls = np.cumsum(pred_match > -1).astype(np.float32) / max(len(gt_match), 1)

    precisions = np.concatenate([[0], precisions, [0]])
    recalls = np.concatenate([[0], recalls, [1]])
    for i in range(len(precisions) - 2, -1, -1):
        precisions[i] = np.maximum(precisions[i], precisions[i + 1])
    indices = np.where(recalls[:-1] != recalls[1:])[0] + 1
    mAP = np.sum((recalls[indices] - recalls[indices - 1])
                 * precisions[indices])
    return mAP, precisions, recalls, overlaps


def compute_ap_range(gt_box, gt_class_id, gt_mask,
                     pred_box, pred_class_id, pred_score, pred_mask,
                     iou_thresholds=None, verbose=0):
    """COCO-style AP over IoU 0.5:0.05:0.95 (utils.py:759-780)."""
    iou_thresholds = iou_thresholds if iou_thresholds is not None \
        else np.arange(0.5, 1.0, 0.05)
    ap = 0.0
    for t in iou_thresholds:
        a, _, _, _ = compute_ap(gt_box, gt_class_id, gt_mask,
                                pred_box, pred_class_id, pred_score,
                                pred_mask, iou_threshold=t)
        if verbose:
            print(f"AP @{t:.2f}:\t {a:.3f}")
        ap += a
    ap /= len(iou_thresholds)
    if verbose:
        print(f"AP @{iou_thresholds[0]:.2f}-{iou_thresholds[-1]:.2f}:\t {ap:.3f}")
    return ap


def compute_recall(pred_boxes, gt_boxes, iou):
    """Recall at IoU (utils.py:783-798). Returns (recall, positive_ids)."""
    overlaps = compute_overlaps_boxes(pred_boxes, gt_boxes)
    iou_max = np.max(overlaps, axis=1)
    iou_argmax = np.argmax(overlaps, axis=1)
    positive_ids = np.where(iou_max >= iou)[0]
    matched_gt = iou_argmax[positive_ids]
    recall = len(set(matched_gt)) / gt_boxes.shape[0]
    return recall, positive_ids
