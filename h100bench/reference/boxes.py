"""Box operations, a frozen copy of the port's ``ops/boxes.py``. Convention:
(y1, x1, y2, x2), as the reference
(``Mask_RCNN/mrcnn/utils.py:32-230``); port of slam_maskrcnn_tpu/ops/boxes.py.
"""

from __future__ import annotations

import torch


def compute_iou_matrix(boxes1: torch.Tensor,
                       boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU [N, M]. = ``utils.compute_overlaps`` (utils.py:79-95)."""
    y1 = torch.maximum(boxes1[:, None, 0], boxes2[None, :, 0])
    x1 = torch.maximum(boxes1[:, None, 1], boxes2[None, :, 1])
    y2 = torch.minimum(boxes1[:, None, 2], boxes2[None, :, 2])
    x2 = torch.minimum(boxes1[:, None, 3], boxes2[None, :, 3])
    inter = (y2 - y1).clamp_min(0) * (x2 - x1).clamp_min(0)
    a1 = (boxes1[:, 2] - boxes1[:, 0]) * (boxes1[:, 3] - boxes1[:, 1])
    a2 = (boxes2[:, 2] - boxes2[:, 0]) * (boxes2[:, 3] - boxes2[:, 1])
    union = a1[:, None] + a2[None, :] - inter
    return inter / union.clamp_min(1e-10)


def apply_box_deltas(boxes: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Apply (dy, dx, log dh, log dw) refinements (utils.py:153-174)."""
    h = boxes[..., 2] - boxes[..., 0]
    w = boxes[..., 3] - boxes[..., 1]
    cy = boxes[..., 0] + 0.5 * h
    cx = boxes[..., 1] + 0.5 * w
    cy = cy + deltas[..., 0] * h
    cx = cx + deltas[..., 1] * w
    h = h * torch.exp(deltas[..., 2])
    w = w * torch.exp(deltas[..., 3])
    y1 = cy - 0.5 * h
    x1 = cx - 0.5 * w
    return torch.stack([y1, x1, y1 + h, x1 + w], dim=-1)


def clip_boxes(boxes: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Clip to window (y1, x1, y2, x2) (model.py:250-259)."""
    wy1, wx1, wy2, wx2 = window[0], window[1], window[2], window[3]
    y1 = torch.minimum(torch.maximum(boxes[..., 0], wy1), wy2)
    x1 = torch.minimum(torch.maximum(boxes[..., 1], wx1), wx2)
    y2 = torch.minimum(torch.maximum(boxes[..., 2], wy1), wy2)
    x2 = torch.minimum(torch.maximum(boxes[..., 3], wx1), wx2)
    return torch.stack([y1, x1, y2, x2], dim=-1)


def box_refinement(box: torch.Tensor, gt_box: torch.Tensor) -> torch.Tensor:
    """Inverse of apply_box_deltas: the deltas taking box to gt_box
    (``utils.box_refinement_graph``, utils.py:177-200), heights and widths
    floored at 1e-8."""
    h = box[..., 2] - box[..., 0]
    w = box[..., 3] - box[..., 1]
    cy = box[..., 0] + 0.5 * h
    cx = box[..., 1] + 0.5 * w
    gh = gt_box[..., 2] - gt_box[..., 0]
    gw = gt_box[..., 3] - gt_box[..., 1]
    gcy = gt_box[..., 0] + 0.5 * gh
    gcx = gt_box[..., 1] + 0.5 * gw
    h = h.clamp_min(1e-8)
    w = w.clamp_min(1e-8)
    return torch.stack([(gcy - cy) / h, (gcx - cx) / w,
                        torch.log(gh.clamp_min(1e-8) / h),
                        torch.log(gw.clamp_min(1e-8) / w)], dim=-1)
