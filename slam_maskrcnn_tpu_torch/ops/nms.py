"""Greedy non-maximum suppression with a fixed-size output.

Port of slam_maskrcnn_tpu/ops/nms.py. ``non_max_suppression`` returns
exactly ``max_output`` indices plus a validity mask, in selection order
(the reference's pad-to-count contract, model.py:328-333). On a CUDA tensor
it launches the kernel of csrc/nms.cu (one thread block per image, the
boxes in its threads' registers, so at most ``NMS_MAX_N`` boxes an image:
more raises); on a CPU tensor it runs ``non_max_suppression_plain``, the
same algorithm as a fixed-trip loop of tensor ops.

``variant="sorted"`` (the JAX package's ``_nms_pallas_sorted_jit``) gives
the same selection another way: a stable sort by descending score, the
suppression mask of greedy NMS over the sorted boxes (the kernel of
csrc/nms_sorted.cu on a CUDA tensor, ``nms_sorted_suppression_plain`` on a
CPU tensor), then the first ``max_output`` kept boxes mapped back through
the sort order. No entry point takes it by default.
"""

from __future__ import annotations

import torch

from slam_maskrcnn_tpu_torch import kernels
from slam_maskrcnn_tpu_torch.device import on_cuda
from slam_maskrcnn_tpu_torch.ops.boxes import compute_iou_matrix

NEG_INF = -1e9
# csrc/nms.cu keeps 1 to 8 boxes in each of its 1024 threads (NMS_MAX_N
# there)
NMS_MAX_N = 8192


def check_nms_size(n: int) -> None:
    """Raise if the argmax kernel cannot take ``n`` boxes an image."""
    if n > NMS_MAX_N:
        raise ValueError(f"nms kernel takes at most {NMS_MAX_N} boxes an "
                         f"image, got {n}")


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
    check_nms_size(n)
    boxes = boxes.contiguous()
    if boxes.data_ptr() % 16:            # the kernel reads a box as a float4
        boxes = boxes.clone()
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


def nms_sorted_suppression_plain(boxes: torch.Tensor,
                                 iou_threshold: float) -> torch.Tensor:
    """Plain PyTorch version of the sorted-NMS kernel: boxes [n, 4] in
    selection (score-descending) order -> sup u8 [n], 1 where an earlier
    kept box overlaps the box with IoU > iou_threshold. A loop over the
    boxes in order; no host sync."""
    n = boxes.shape[0]
    arange = torch.arange(n, device=boxes.device)
    sup = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    for i in range(n):
        iou = compute_iou_matrix(boxes[i][None], boxes)[0]
        sup = sup | ((iou > iou_threshold) & (arange > i) & ~sup[i])
    return sup.to(torch.uint8)


def _nms_sorted_cuda(boxes: torch.Tensor,
                     iou_threshold: float) -> torch.Tensor:
    """boxes f32 [B, n, 4] sorted by descending score -> sup u8 [B, n]."""
    if boxes.dtype != torch.float32 or boxes.dim() != 3 \
            or boxes.shape[-1] != 4 or not boxes.is_cuda:
        raise ValueError("sorted nms kernel takes float32 CUDA boxes "
                         f"[B, n, 4], got {boxes.dtype} "
                         f"{tuple(boxes.shape)} on {boxes.device}")
    boxes = boxes.contiguous()
    if boxes.data_ptr() % 16:            # the kernel reads a box as a float4
        boxes = boxes.clone()
    B, n = boxes.shape[:2]
    if B > 65535:
        raise ValueError(f"sorted nms kernel takes at most 65535 images, "
                         f"got {B}")
    nw = (n + 63) // 64
    # the pair bit matrix; the kernel writes (and the scan reads) only the
    # words of column chunks at or after each row's own chunk
    bits = torch.empty(B, n, nw, dtype=torch.int64, device=boxes.device)
    sup = torch.empty(B, n, dtype=torch.uint8, device=boxes.device)
    fn = kernels.lib("nms_sorted").nms_sorted_cuda
    kernels.launches.add("nms_sorted")
    err = fn(kernels.ptr(boxes), B, n, float(iou_threshold),
             kernels.ptr(bits), kernels.ptr(sup),
             kernels.stream_ptr(boxes.device))
    kernels.check(err, "sorted nms kernel")
    return sup


def _nms_sorted(boxes, scores, max_output, iou_threshold, score_threshold):
    """The sorted variant on a batch: boxes [B, n, 4], scores [B, n]."""
    B, n = scores.shape
    dev = scores.device
    live = torch.where(scores > score_threshold, scores,
                       torch.full_like(scores, NEG_INF))
    # descending, ties to the lower original index (a stable sort)
    s_sorted, order = torch.sort(live, dim=1, descending=True, stable=True)
    b_sorted = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    if on_cuda(scores):
        sup = _nms_sorted_cuda(b_sorted.float(), iou_threshold)
    else:
        sup = torch.stack([nms_sorted_suppression_plain(b_sorted[i],
                                                        iou_threshold)
                           for i in range(B)])
    keep = (sup == 0) & (s_sorted > NEG_INF / 2)
    # the first max_output kept entries, in order; the rest (0, invalid)
    pos = torch.cumsum(keep, dim=1) - 1
    slot = torch.where(keep & (pos < max_output), pos,
                       torch.full_like(pos, max_output))
    idx = torch.zeros(B, max_output + 1, dtype=torch.int64, device=dev)
    idx.scatter_(1, slot, order)
    valid = torch.zeros(B, max_output + 1, dtype=torch.bool, device=dev)
    valid.scatter_(1, slot, keep)
    idx, valid = idx[:, :max_output], valid[:, :max_output]
    return torch.where(valid, idx, torch.zeros_like(idx)), valid


def non_max_suppression(boxes: torch.Tensor, scores: torch.Tensor,
                        max_output: int, iou_threshold: float = 0.5,
                        score_threshold: float = float("-inf"),
                        variant: str = "argmax"):
    """Greedy NMS over boxes [..., n, 4] and scores [..., n] (one leading
    batch dim at most). Returns (indices i64 [..., max_output], valid bool).

    CUDA tensors launch the kernel (one launch for the whole batch); CPU
    tensors take the plain version image by image. ``variant``: "argmax"
    (default, one selection at a time) or "sorted" (sort, suppression mask,
    cut; see the module docstring): both give the same selection."""
    if variant not in ("argmax", "sorted"):
        raise ValueError(f"variant {variant!r}: 'argmax' or 'sorted'")
    batched = scores.dim() == 2
    b = boxes if batched else boxes[None]
    s = scores if batched else scores[None]
    if variant == "sorted":
        idx, valid = _nms_sorted(b, s, max_output, iou_threshold,
                                 score_threshold)
    elif on_cuda(s):
        idx, valid = _nms_cuda(b, s, max_output, iou_threshold,
                               score_threshold)
    else:
        outs = [non_max_suppression_plain(b[i], s[i], max_output,
                                          iou_threshold, score_threshold)
                for i in range(s.shape[0])]
        idx = torch.stack([o[0] for o in outs])
        valid = torch.stack([o[1] for o in outs])
    return (idx, valid) if batched else (idx[0], valid[0])
