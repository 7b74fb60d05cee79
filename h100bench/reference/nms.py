"""Greedy non-maximum suppression with a fixed-size output, plain PyTorch.

The port's ``ops/nms.non_max_suppression_plain`` (which its NMS kernel
equals bit for bit) runs one image at a time; this is the same selection
rule and the same IoU arithmetic (``boxes.compute_iou_matrix``'s, element by
element) over a whole batch at once, so that a reference detect of 16
frames takes tens of milliseconds of selections, not seconds: each
selection takes the live box of highest score (first index on ties), then
kills every box of that image with IoU > iou_threshold.
"""

from __future__ import annotations

import torch

NEG_INF = -1e9


def non_max_suppression(boxes: torch.Tensor, scores: torch.Tensor,
                        max_output: int, iou_threshold: float = 0.5,
                        score_threshold: float = float("-inf")):
    """boxes [..., n, 4], scores [..., n] (one leading batch dim at most).
    Returns (indices i64 [..., max_output], valid bool); invalid slots
    hold 0."""
    batched = scores.dim() == 2
    b = boxes if batched else boxes[None]
    s = scores if batched else scores[None]
    B, n = s.shape
    live = torch.where(s > score_threshold, s, torch.full_like(s, NEG_INF))
    arange = torch.arange(n, device=s.device)[None]
    rows = torch.arange(B, device=s.device)
    neg = torch.full_like(live, NEG_INF)
    idxs, valid = [], []
    for _ in range(max_output):
        idx = torch.argmax(live, dim=1)                    # [B]
        ok = live[rows, idx] > NEG_INF / 2
        sel = b[rows, idx]                                 # [B, 4]
        iou = _iou_rows(sel, b)
        kill = (iou > iou_threshold) | (arange == idx[:, None])
        live = torch.where(kill, neg, live)
        idxs.append(idx)
        valid.append(ok)
    idx = torch.stack(idxs, 1)
    ok = torch.stack(valid, 1)
    idx = torch.where(ok, idx, torch.zeros_like(idx))
    return (idx, ok) if batched else (idx[0], ok[0])


def _iou_rows(sel: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """IoU of each image's selected box [B, 4] with its boxes [B, n, 4]:
    compute_iou_matrix's operations in its order, batched."""
    y1 = torch.maximum(sel[:, None, 0], boxes[:, :, 0])
    x1 = torch.maximum(sel[:, None, 1], boxes[:, :, 1])
    y2 = torch.minimum(sel[:, None, 2], boxes[:, :, 2])
    x2 = torch.minimum(sel[:, None, 3], boxes[:, :, 3])
    inter = (y2 - y1).clamp_min(0) * (x2 - x1).clamp_min(0)
    a1 = (sel[:, 2] - sel[:, 0]) * (sel[:, 3] - sel[:, 1])
    a2 = (boxes[:, :, 2] - boxes[:, :, 0]) * (boxes[:, :, 3] - boxes[:, :, 1])
    union = a1[:, None] + a2 - inter
    return inter / union.clamp_min(1e-10)
