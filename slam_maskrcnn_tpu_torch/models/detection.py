"""Detection refinement: class-specific deltas + per-class NMS + top-k.

Port of slam_maskrcnn_tpu/models/detection.py (``refine_detections_graph``,
``Mask_RCNN/mrcnn/model.py:689-828``). Per-class NMS is the class-offset
trick: every box shifts by ``class_id * 2`` (boxes are normalized to
[0, 1], so classes never overlap), then ONE fixed-size greedy NMS; greedy
order is global score order but suppression only acts within a class, so
the result equals per-class NMS + merge + top-k by score.
"""

from __future__ import annotations

import torch

from slam_maskrcnn_tpu_torch.ops.boxes import apply_box_deltas, clip_boxes
from slam_maskrcnn_tpu_torch.ops.nms import non_max_suppression
from slam_maskrcnn_tpu_torch.utils.profiling import sync

NEG_INF = -1e9


def detection_layer(rois: torch.Tensor, probs: torch.Tensor,
                    deltas: torch.Tensor, windows: torch.Tensor, *,
                    max_instances: int, min_confidence: float,
                    nms_threshold: float, bbox_std=(0.1, 0.1, 0.2, 0.2)):
    """Batched over images: rois [B, N, 4], probs [B, N, C], deltas
    [B, N, C, 4], windows [B, 4] normalized. Returns (detections
    [B, max_instances, 6] = (y1, x1, y2, x2, class_id, score) zero-padded,
    valid [B, max_instances])."""
    with sync("heads.const"):
        std = torch.as_tensor(bbox_std, dtype=torch.float32,
                              device=rois.device)
    class_ids = torch.argmax(probs, dim=2)                  # first max wins
    class_scores = torch.gather(probs, 2, class_ids[..., None])[..., 0]
    deltas_specific = torch.gather(
        deltas, 2, class_ids[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
    refined = apply_box_deltas(rois, deltas_specific * std)
    refined = torch.stack([clip_boxes(refined[b], windows[b])
                           for b in range(rois.shape[0])])

    keep = class_ids > 0
    if min_confidence:
        keep &= class_scores >= min_confidence
    # zero-padded rois from the proposal stage have zero area
    area = (rois[..., 2] - rois[..., 0]) * (rois[..., 3] - rois[..., 1])
    keep &= area > 0

    nms_boxes = refined + class_ids.float()[..., None] * 2.0
    nms_scores = torch.where(keep, class_scores,
                             torch.full_like(class_scores, NEG_INF))
    idx, valid = non_max_suppression(nms_boxes, nms_scores, max_instances,
                                     nms_threshold,
                                     score_threshold=NEG_INF / 2)
    det_boxes = torch.gather(refined, 1, idx[..., None].expand(-1, -1, 4))
    det_ids = torch.gather(class_ids, 1, idx).float()
    det_scores = torch.gather(class_scores, 1, idx)
    detections = torch.cat([det_boxes, det_ids[..., None],
                            det_scores[..., None]], dim=2)
    detections = torch.where(valid[..., None], detections,
                             torch.zeros_like(detections))
    return detections, valid
