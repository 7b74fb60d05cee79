"""Training target builders.

Port of slam_maskrcnn_tpu/models/targets.py:

* ``build_rpn_targets``: per image, in the data pipeline
  (= ``Mask_RCNN/mrcnn/model.py:1450-1558``), a copy: anchor-aligned
  deltas (zeros at non-positives), positives and negatives subsampled with
  numpy's global stream as the JAX package does. The JAX package matches
  anchors to gt in host numpy (``_match_np`` here); given
  ``DeviceAnchors``, the port matches them on their device
  (``match_anchors``: one call of csrc/rpn_targets.cu on a card,
  ``rpn_match_plain`` on the CPU) with the same labels, and keeps the
  draws and the deltas on the host.
* ``detection_targets``: on the device, static shapes, a batch at once
  (= ``DetectionTargetLayer``, ``model.py:491-682``; the JAX package's jnp
  function vmapped over images): IoU matching, 33%-positive subsampling,
  per-roi class / delta / mask targets. The random subsample is the JAX
  package's noisy-score top-k with its two uniform draws passed in
  (``pos_noise``, ``neg_noise``; ``draw_target_noise`` makes them from a
  ``torch.Generator``), and ``lax.top_k`` a stable descending sort (the
  lower index first on ties). Mask targets crop the gt mini-masks with
  ops/roi_align.py ``crop_and_resize`` and round, as the jnp
  ``crop_and_resize`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_maskrcnn_tpu_torch import kernels
from slam_maskrcnn_tpu_torch.ops.boxes import (box_refinement,
                                               compute_iou_matrix)
from slam_maskrcnn_tpu_torch.ops.roi_align import crop_and_resize
from slam_maskrcnn_tpu_torch.utils.profiling import sync


class DeviceAnchors:
    """The f32 pixel anchors ``px`` [A, 4] and the same bits as a tensor
    ``t`` on ``device`` (uploaded once). Given as ``build_rpn_targets``'
    anchors, they move its matching of anchors to gt onto that device."""

    def __init__(self, px: np.ndarray, device):
        self.px = px
        self.t = torch.from_numpy(px)
        if torch.device(device).type != "cpu":
            with sync("rpn.anchors"):
                self.t = self.t.to(device)


def build_rpn_targets(anchors, gt_class_ids: np.ndarray,
                      gt_boxes: np.ndarray, config
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Returns (rpn_match [A] in {-1, 0, 1}, rpn_bbox [A, 4] aligned).
    ``anchors``: [A, 4] in numpy, or ``DeviceAnchors``, whose matching of
    anchors to gt runs on their device (``match_anchors``: csrc/
    rpn_targets.cu on a card, ``rpn_match_plain`` on the CPU) with the same
    result; the subsample and the deltas stay here either way."""
    on_device = anchors if isinstance(anchors, DeviceAnchors) else None
    if on_device is not None:
        anchors = on_device.px
    rpn_match = np.zeros(anchors.shape[0], np.int32)
    rpn_bbox = np.zeros((anchors.shape[0], 4), np.float32)
    if gt_boxes.shape[0] == 0:
        return rpn_match, rpn_bbox

    # crowds (negative ids) don't count as gt; anchors overlapping a crowd
    # box are neutral (model.py:1472-1487)
    crowd_ix = np.where(gt_class_ids < 0)[0]
    crowd_boxes = gt_boxes[crowd_ix]
    if crowd_ix.shape[0] > 0:
        gt_boxes = gt_boxes[np.where(gt_class_ids > 0)[0]]
    if gt_boxes.shape[0] == 0:
        return rpn_match, rpn_bbox
    if on_device is None:
        rpn_match, anchor_iou_argmax = _match_np(anchors, gt_boxes,
                                                 crowd_boxes)
    else:
        rpn_match, anchor_iou_argmax = match_anchors(on_device.t, gt_boxes,
                                                     crowd_boxes)

    # subsample (model.py:1507-1519)
    ids = np.where(rpn_match == 1)[0]
    extra = len(ids) - config.RPN_TRAIN_ANCHORS_PER_IMAGE // 2
    if extra > 0:
        rpn_match[np.random.choice(ids, extra, replace=False)] = 0
    ids = np.where(rpn_match == -1)[0]
    extra = len(ids) - (config.RPN_TRAIN_ANCHORS_PER_IMAGE
                        - np.sum(rpn_match == 1))
    if extra > 0:
        rpn_match[np.random.choice(ids, extra, replace=False)] = 0

    # deltas for positives, normalized by std (model.py:1522-1556)
    ids = np.where(rpn_match == 1)[0]
    for i in ids:
        gt = gt_boxes[anchor_iou_argmax[i]]
        a = anchors[i]
        ah, aw = a[2] - a[0], a[3] - a[1]
        acy, acx = a[0] + 0.5 * ah, a[1] + 0.5 * aw
        gh, gw = gt[2] - gt[0], gt[3] - gt[1]
        gcy, gcx = gt[0] + 0.5 * gh, gt[1] + 0.5 * gw
        rpn_bbox[i] = [(gcy - acy) / ah, (gcx - acx) / aw,
                       np.log(gh / ah), np.log(gw / aw)]
        rpn_bbox[i] /= config.RPN_BBOX_STD_DEV
    return rpn_match, rpn_bbox


def _match_np(anchors, gt_boxes, crowd_boxes):
    """The labels before the subsample and each anchor's best gt
    (model.py:1487-1504), in numpy."""
    if crowd_boxes.shape[0] > 0:
        no_crowd = _overlaps_np(anchors, crowd_boxes).max(axis=1) < 0.001
    else:
        no_crowd = np.ones(anchors.shape[0], bool)
    overlaps = _overlaps_np(anchors, gt_boxes)
    anchor_iou_argmax = overlaps.argmax(axis=1)
    anchor_iou_max = overlaps[np.arange(len(anchors)), anchor_iou_argmax]
    rpn_match = np.zeros(anchors.shape[0], np.int32)
    rpn_match[(anchor_iou_max < 0.3) & no_crowd] = -1
    # best anchor per gt is positive regardless of IoU (incl. ties,
    # model.py:1499-1502)
    gt_iou_argmax = np.argwhere(overlaps == overlaps.max(axis=0))[:, 0]
    rpn_match[gt_iou_argmax] = 1
    rpn_match[anchor_iou_max >= 0.7] = 1
    return rpn_match, anchor_iou_argmax


def match_anchors(anchors: torch.Tensor, gt_boxes: np.ndarray,
                  crowd_boxes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``_match_np`` on ``anchors``' device: anchors f32 [A, 4] there, the
    image's gt and crowd boxes f32 [G, 4], [C, 4] (G >= 1) on the host.
    Returns (labels i32 [A], best gt i32 [A]) on the host. On a card the
    boxes go up from pinned memory without a sync, and the two rows come
    back in one read-back."""
    boxes = torch.from_numpy(np.concatenate([gt_boxes, crowd_boxes]))
    G = gt_boxes.shape[0]
    if not anchors.is_cuda:
        out = rpn_match_plain(anchors, boxes, G)
    else:
        boxes = boxes.pin_memory().to(anchors.device, non_blocking=True)
        out = rpn_match_cuda(anchors, boxes, G)
        with sync("rpn.labels"):
            out = out.cpu()
    out = out.numpy()
    return out[0], out[1]


def rpn_match_plain(anchors: torch.Tensor, boxes: torch.Tensor,
                    G: int) -> torch.Tensor:
    """Plain PyTorch version of the RPN matching kernel (csrc/
    rpn_targets.cu) on any device: anchors f32 [A, 4], boxes f32 [G + C,
    4] (the gt, then the crowd boxes). Returns i32 [2, A]: the labels
    before the subsample, and each anchor's best gt (the first on ties)."""
    iou = compute_iou_matrix(anchors, boxes)        # [A, G + C]
    gt = iou[:, :G]
    arg = torch.argmax(gt, dim=1)
    best = torch.gather(gt, 1, arg[:, None])[:, 0]
    if boxes.shape[0] > G:
        no_crowd = iou[:, G:].max(dim=1).values < 0.001
    else:
        no_crowd = torch.ones_like(best, dtype=torch.bool)
    tie = (gt == gt.max(dim=0).values[None, :]).any(dim=1)
    label = torch.where((best >= 0.7) | tie, 1,
                        torch.where((best < 0.3) & no_crowd, -1, 0))
    return torch.stack([label, arg]).to(torch.int32)


def rpn_match_cuda(anchors: torch.Tensor, boxes: torch.Tensor,
                   G: int) -> torch.Tensor:
    """``rpn_match_plain`` as two launches of csrc/rpn_targets.cu on the
    anchors' card: no host sync, nothing read back."""
    A, n = anchors.shape[0], boxes.shape[0]
    dev = anchors.device
    if (not anchors.is_cuda or boxes.device != dev
            or anchors.dtype != torch.float32 or boxes.dtype != torch.float32
            or anchors.shape != (A, 4) or boxes.shape != (n, 4)
            or not 1 <= G <= n or A < 1):
        raise ValueError("RPN matching kernel takes anchors f32 [A, 4] and "
                         "boxes f32 [G + C, 4] (G >= 1) on one CUDA device")
    anchors, boxes = anchors.contiguous(), boxes.contiguous()
    out = torch.empty((2, A), dtype=torch.int32, device=dev)
    colmax = torch.empty(G, dtype=torch.int32, device=dev)
    fn = kernels.lib("rpn_targets").rpn_match_cuda
    kernels.launches.add("rpn_targets")
    err = fn(kernels.ptr(anchors), A, kernels.ptr(boxes), G, n - G,
             kernels.ptr(out), kernels.ptr(colmax), kernels.stream_ptr(dev))
    kernels.check(err, "RPN matching kernel")
    return out


def _overlaps_np(boxes1, boxes2):
    y1 = np.maximum(boxes1[:, None, 0], boxes2[None, :, 0])
    x1 = np.maximum(boxes1[:, None, 1], boxes2[None, :, 1])
    y2 = np.minimum(boxes1[:, None, 2], boxes2[None, :, 2])
    x2 = np.minimum(boxes1[:, None, 3], boxes2[None, :, 3])
    inter = np.maximum(y2 - y1, 0) * np.maximum(x2 - x1, 0)
    a1 = (boxes1[:, 2] - boxes1[:, 0]) * (boxes1[:, 3] - boxes1[:, 1])
    a2 = (boxes2[:, 2] - boxes2[:, 0]) * (boxes2[:, 3] - boxes2[:, 1])
    return inter / np.maximum(a1[:, None] + a2[None, :] - inter, 1e-10)


def draw_target_noise(batch: int, proposals: int, generator: torch.Generator,
                      device) -> tuple[torch.Tensor, torch.Tensor]:
    """The two uniform [0, 1) draws of ``detection_targets``, f32
    [batch, proposals] each, from ``generator`` (on ``device``)."""
    shape = (batch, proposals)
    return (torch.rand(shape, generator=generator, device=device),
            torch.rand(shape, generator=generator, device=device))


def _top(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest per row, the lower index first on ties
    (= lax.top_k)."""
    return torch.sort(score, dim=1, descending=True, stable=True)[1][:, :k]


def _rows(t: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """t [B, P, ...] at per-row indices ix [B, K] -> [B, K, ...]."""
    ix = ix.reshape(ix.shape + (1,) * (t.dim() - 2))
    return torch.gather(t, 1, ix.expand(ix.shape[:2] + t.shape[2:]))


def detection_targets(proposals: torch.Tensor, gt_class_ids: torch.Tensor,
                      gt_boxes: torch.Tensor, gt_masks: torch.Tensor,
                      pos_noise: torch.Tensor, neg_noise: torch.Tensor, *,
                      train_rois: int = 200, positive_ratio: float = 0.33,
                      mask_size: int = 28, bbox_std=(0.1, 0.1, 0.2, 0.2)):
    """A batch: proposals [B, P, 4] zero-padded; gt_class_ids [B, G] (0
    pad, < 0 crowd); gt_boxes [B, G, 4] normalized; gt_masks [B, G, h, w]
    (mini-masks, box-relative); pos_noise, neg_noise f32 [B, P] uniform in
    [0, 1). Returns (rois [B, T, 4], class_ids [B, T], deltas [B, T, 4],
    masks [B, T, m, m], valid [B, T]). No gradient flows (the inputs are
    proposals and ground truth)."""
    B, P = proposals.shape[:2]
    dev = proposals.device
    prop_valid = ((proposals[..., 2] - proposals[..., 0])
                  * (proposals[..., 3] - proposals[..., 1])) > 0
    gt_valid = gt_class_ids > 0
    crowd = gt_class_ids < 0

    iou = torch.stack([compute_iou_matrix(proposals[b], gt_boxes[b])
                       for b in range(B)])                  # [B, P, G]
    neg1 = torch.full_like(iou, -1.0)
    iou_gt = torch.where(gt_valid[:, None, :], iou, neg1)
    iou_crowd = torch.where(crowd[:, None, :], iou, neg1)
    roi_iou_max = iou_gt.max(dim=2).values
    crowd_iou_max = iou_crowd.max(dim=2).values

    positive = prop_valid & (roi_iou_max >= 0.5)
    negative = prop_valid & (roi_iou_max < 0.5) & (crowd_iou_max < 0.001)

    pos_count = int(round(train_rois * positive_ratio))
    neg_count = train_rois - pos_count

    # random subsample via noisy scores + top-k (static-size choice)
    minus = torch.full_like(pos_noise, -1.0)
    pos_score = torch.where(positive, pos_noise, minus)
    neg_score = torch.where(negative, neg_noise, minus)
    pos_ix = _top(pos_score, pos_count)
    neg_ix = _top(neg_score, neg_count)
    pos_ok = torch.gather(pos_score, 1, pos_ix) > 0
    neg_ok = torch.gather(neg_score, 1, neg_ix) > 0

    roi_pos = _rows(proposals, pos_ix)
    rois = torch.cat([roi_pos, _rows(proposals, neg_ix)], dim=1)
    valid = torch.cat([pos_ok, neg_ok], dim=1)
    no = torch.zeros(B, neg_count, dtype=torch.bool, device=dev)
    is_pos = torch.cat([pos_ok, no], dim=1)

    # per-positive best gt (the first on ties)
    best_gt = torch.argmax(_rows(iou_gt, pos_ix), dim=2)     # [B, pos]
    pos_class = torch.where(pos_ok, torch.gather(gt_class_ids, 1, best_gt),
                            torch.zeros_like(best_gt, dtype=gt_class_ids.dtype))
    class_ids = torch.cat([pos_class, torch.zeros(
        B, neg_count, dtype=pos_class.dtype, device=dev)], dim=1)

    gt_box_pos = _rows(gt_boxes, best_gt)
    with sync("targets.const"):
        std = torch.tensor(np.asarray(bbox_std, np.float32), device=dev)
    deltas_pos = box_refinement(roi_pos, gt_box_pos) / std
    deltas = torch.cat([deltas_pos, torch.zeros(B, neg_count, 4,
                                                device=dev)], dim=1)
    deltas = deltas * is_pos[..., None]

    # mask targets: crop the gt (mini) mask with the roi box expressed in
    # gt-box-relative coordinates (model.py:620-655, USE_MINI_MASK branch)
    gh = (gt_box_pos[..., 2] - gt_box_pos[..., 0]).clamp_min(1e-8)
    gw = (gt_box_pos[..., 3] - gt_box_pos[..., 1]).clamp_min(1e-8)
    rel = torch.stack([(roi_pos[..., 0] - gt_box_pos[..., 0]) / gh,
                       (roi_pos[..., 1] - gt_box_pos[..., 1]) / gw,
                       (roi_pos[..., 2] - gt_box_pos[..., 0]) / gh,
                       (roi_pos[..., 3] - gt_box_pos[..., 1]) / gw], dim=-1)
    G = gt_masks.shape[1]
    which = (torch.arange(B, device=dev)[:, None] * G + best_gt).reshape(-1)
    crops = crop_and_resize(gt_masks.reshape((B * G,) + gt_masks.shape[2:]
                                             + (1,)).float(),
                            rel.reshape(-1, 4), (mask_size, mask_size),
                            box_index=which)[..., 0]
    masks_pos = torch.round(crops).reshape(B, pos_count, mask_size,
                                           mask_size)
    masks = torch.cat([masks_pos, torch.zeros(B, neg_count, mask_size,
                                              mask_size, device=dev)], dim=1)
    masks = masks * is_pos[..., None, None]

    rois = rois * valid[..., None]
    return rois, class_ids, deltas, masks, valid
