"""Proposal generation: top-k anchors -> deltas -> clip -> NMS -> pad.

Port of slam_maskrcnn_tpu/models/proposal.py (``ProposalLayer``,
``Mask_RCNN/mrcnn/model.py:261-338``) with a fixed-size padded output.
"""

from __future__ import annotations

import torch

from slam_maskrcnn_tpu_torch.ops.boxes import apply_box_deltas, clip_boxes
from slam_maskrcnn_tpu_torch.ops.nms import non_max_suppression


def generate_proposals(rpn_probs: torch.Tensor, rpn_bbox: torch.Tensor,
                       anchors: torch.Tensor, proposal_count: int,
                       nms_threshold: float = 0.7, pre_nms_limit: int = 6000,
                       bbox_std=(0.1, 0.1, 0.2, 0.2)):
    """rpn_probs [B, A, 2], rpn_bbox [B, A, 4], anchors [A, 4] normalized.
    Returns (proposals [B, proposal_count, 4] zero-padded, valid [B, count]).

    The pre-NMS pool is the top ``pre_nms_limit`` scores with ties to the
    lower anchor index (= lax.top_k): a stable descending sort, because
    torch.topk promises no order among ties. One NMS launch covers the
    batch."""
    std = torch.as_tensor(bbox_std, dtype=torch.float32,
                          device=rpn_probs.device)
    scores = rpn_probs[:, :, 1]
    k = min(pre_nms_limit, anchors.shape[0])
    top_scores, ix = torch.sort(scores, dim=1, descending=True, stable=True)
    top_scores, ix = top_scores[:, :k], ix[:, :k]
    top_deltas = torch.gather(rpn_bbox, 1, ix[..., None].expand(-1, -1, 4))
    boxes = apply_box_deltas(anchors[ix], top_deltas * std)
    window = torch.tensor([0.0, 0.0, 1.0, 1.0], device=rpn_probs.device)
    boxes = clip_boxes(boxes, window)
    idx, valid = non_max_suppression(boxes, top_scores, proposal_count,
                                     nms_threshold)
    props = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    props = torch.where(valid[..., None], props, torch.zeros_like(props))
    return props, valid
