"""Greedy non-maximum suppression with a fixed-size output.

Port of slam_maskrcnn_tpu/ops/nms.py. ``non_max_suppression`` returns
exactly ``max_output`` indices plus a validity mask, in selection order
(the reference's pad-to-count contract, model.py:328-333). On a CUDA tensor
it launches the kernel of csrc/nms.cu (one thread block per image); on a
CPU tensor it runs ``non_max_suppression_plain``, the same algorithm as a
fixed-trip loop of tensor ops.
"""

from __future__ import annotations

import torch

from slam_maskrcnn_tpu_torch import kernels
from slam_maskrcnn_tpu_torch.device import on_cuda
from slam_maskrcnn_tpu_torch.ops.boxes import compute_iou_matrix

NEG_INF = -1e9


def non_max_suppression_plain(boxes: torch.Tensor, scores: torch.Tensor,
                              max_output: int, iou_threshold: float = 0.5,
                              score_threshold: float = float("-inf")):
    """Greedy NMS of one image: boxes [n, 4], scores [n]. Returns (indices
    i64 [max_output], valid bool [max_output]); invalid slots hold 0.

    = ops/nms.non_max_suppression:29 — each selection takes the live box
    of highest score (first index on ties, as torch.argmax and
    jnp.argmax), then kills every box with IoU > iou_threshold."""
    n = boxes.shape[0]
    live = torch.where(scores > score_threshold, scores,
                       torch.full_like(scores, NEG_INF))
    arange = torch.arange(n, device=boxes.device)
    neg = torch.full_like(live, NEG_INF)
    idxs, valid = [], []
    for _ in range(max_output):
        idx = torch.argmax(live)
        ok = live[idx] > NEG_INF / 2
        iou = compute_iou_matrix(boxes[idx][None], boxes)[0]
        kill = (iou > iou_threshold) | (arange == idx)
        live = torch.where(kill, neg, live)
        idxs.append(idx)
        valid.append(ok)
    idxs = torch.stack(idxs) if idxs else arange[:0]
    valid = (torch.stack(valid) if valid
             else torch.zeros(0, dtype=torch.bool, device=boxes.device))
    return torch.where(valid, idxs, torch.zeros_like(idxs)), valid


def _nms_cuda(boxes, scores, max_output, iou_threshold, score_threshold):
    B, n = scores.shape
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError("nms kernel takes float32 boxes and scores")
    if boxes.shape != (B, n, 4) or boxes.device != scores.device:
        raise ValueError(f"boxes [{B}, {n}, 4] on the scores' device "
                         f"expected, got {tuple(boxes.shape)} on "
                         f"{boxes.device}")
    boxes = boxes.contiguous()
    scores = scores.contiguous()
    idx = torch.empty(B, max_output, dtype=torch.int32, device=boxes.device)
    valid = torch.empty(B, max_output, dtype=torch.uint8, device=boxes.device)
    fn = kernels.lib("nms").nms_cuda
    kernels.launches.add("nms")
    err = fn(kernels.ptr(boxes), kernels.ptr(scores), B, n, max_output,
             float(iou_threshold), float(score_threshold), kernels.ptr(idx),
             kernels.ptr(valid), kernels.stream_ptr(boxes.device))
    kernels.check(err, "nms kernel")
    return idx.long(), valid.bool()


def non_max_suppression(boxes: torch.Tensor, scores: torch.Tensor,
                        max_output: int, iou_threshold: float = 0.5,
                        score_threshold: float = float("-inf")):
    """Greedy NMS over boxes [..., n, 4] and scores [..., n] (one leading
    batch dim at most). Returns (indices i64 [..., max_output], valid bool).

    CUDA tensors launch the kernel (one launch for the whole batch); CPU
    tensors take the plain version image by image."""
    batched = scores.dim() == 2
    b = boxes if batched else boxes[None]
    s = scores if batched else scores[None]
    if on_cuda(s):
        idx, valid = _nms_cuda(b, s, max_output, iou_threshold,
                               score_threshold)
    else:
        outs = [non_max_suppression_plain(b[i], s[i], max_output,
                                          iou_threshold, score_threshold)
                for i in range(s.shape[0])]
        idx = torch.stack([o[0] for o in outs])
        valid = torch.stack([o[1] for o in outs])
    return (idx, valid) if batched else (idx[0], valid[0])
