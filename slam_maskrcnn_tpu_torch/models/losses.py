"""Mask R-CNN losses (5 heads).

Port of slam_maskrcnn_tpu/models/losses.py (the loss graphs of
``Mask_RCNN/mrcnn/model.py:1015-1183``, with masks in place of boolean
gathers, static shapes):

* rpn_class_loss: binary cross-entropy on fg/bg anchors, neutral (0)
  anchors excluded (model.py:1015-1042);
* rpn_bbox_loss: smooth-L1 on positive anchors, targets aligned per anchor
  (model.py:1045-1082);
* mrcnn_class_loss: softmax cross-entropy over the sampled rois, zero for
  predictions of classes not active in the image's dataset
  (model.py:1085-1119);
* mrcnn_bbox_loss: smooth-L1 on the target class's deltas, positive rois
  only (model.py:1122-1146);
* mrcnn_mask_loss: binary cross-entropy on the target class's 28x28 mask,
  positive rois only (model.py:1149-1183).

Each mean is ``_safe_mean``'s: 0 where its mask is empty (the reference's
K.switch on size). ``reduce``, where given, maps each mean's count to the
count over a data-parallel batch (train/trainer.py ``make_step``):
every rank then divides its own numerator by the global count, and the
ranks' losses and gradients add up to the global batch's.
"""

from __future__ import annotations

import torch


def smooth_l1(diff: torch.Tensor) -> torch.Tensor:
    """smooth-L1 (model.py:1048-1054)."""
    a = diff.abs()
    return torch.where(a < 1.0, 0.5 * a * a, a - 0.5)


def _masked_mean(total: torch.Tensor, count: torch.Tensor,
                 reduce=None) -> torch.Tensor:
    """total / max(count, 1), or 0 where count is 0; the count through
    ``reduce`` first, where given."""
    if reduce is not None:
        count = reduce(count)
    return torch.where(count > 0, total / count.clamp_min(1.0),
                       torch.zeros_like(total))


def _safe_mean(x: torch.Tensor, mask: torch.Tensor,
               reduce=None) -> torch.Tensor:
    """Mean over masked elements; 0 when the mask is empty."""
    return _masked_mean((x * mask).sum(), mask.sum(), reduce)


def rpn_class_loss(rpn_match: torch.Tensor, rpn_class_logits: torch.Tensor,
                   reduce=None):
    """rpn_match [B, A]: 1 positive, -1 negative, 0 neutral; logits
    [B, A, 2]."""
    anchor_class = (rpn_match == 1).long()
    use = (rpn_match != 0).float()
    logp = torch.log_softmax(rpn_class_logits, dim=-1)
    ce = -torch.gather(logp, -1, anchor_class[..., None])[..., 0]
    return _safe_mean(ce, use, reduce)


def rpn_bbox_loss(target_bbox: torch.Tensor, rpn_match: torch.Tensor,
                  rpn_bbox: torch.Tensor, reduce=None):
    """target_bbox [B, A, 4] aligned per anchor (zeros where not
    positive); the mean over positive anchors' coordinates."""
    pos = (rpn_match == 1).float()
    l1 = smooth_l1(target_bbox - rpn_bbox)
    return _masked_mean((l1 * pos[..., None]).sum(), pos.sum() * 4.0, reduce)


def mrcnn_class_loss(target_class_ids: torch.Tensor, logits: torch.Tensor,
                     active_class_ids: torch.Tensor,
                     roi_valid: torch.Tensor, reduce=None):
    """target_class_ids [B, T]; logits [B, T, C]; active_class_ids [B, C];
    roi_valid [B, T] (the padding mask)."""
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, target_class_ids.long()[..., None])[..., 0]
    # zero loss for predictions of classes not in the image's dataset
    pred_active = torch.gather(active_class_ids, -1,
                               torch.argmax(logits, dim=-1))
    w = pred_active.float() * roi_valid.float()
    return _safe_mean(ce, w, reduce)


def mrcnn_bbox_loss(target_bbox: torch.Tensor,
                    target_class_ids: torch.Tensor,
                    pred_bbox: torch.Tensor, reduce=None):
    """target_bbox [B, T, 4]; pred_bbox [B, T, C, 4]; positives are the
    rois of class > 0."""
    pos = (target_class_ids > 0).float()
    idx = target_class_ids.long()[..., None, None].expand(-1, -1, 1, 4)
    pred = torch.gather(pred_bbox, 2, idx)[:, :, 0]
    l1 = smooth_l1(target_bbox - pred)
    return _masked_mean((l1 * pos[..., None]).sum(), pos.sum() * 4.0, reduce)


def mrcnn_mask_loss(target_masks: torch.Tensor,
                    target_class_ids: torch.Tensor,
                    pred_masks: torch.Tensor, reduce=None):
    """target_masks [B, T, h, w] in {0, 1}; pred_masks [B, T, h, w, C]
    sigmoid."""
    pos = (target_class_ids > 0).float()
    C = pred_masks.shape[-1]
    cls = target_class_ids.long().clamp(0, C - 1)
    idx = cls[..., None, None, None].expand(*pred_masks.shape[:4], 1)
    pred = torch.gather(pred_masks, -1, idx)[..., 0]
    pred = pred.clamp(1e-7, 1.0 - 1e-7)
    bce = -(target_masks * torch.log(pred)
            + (1.0 - target_masks) * torch.log(1.0 - pred))
    return _safe_mean(bce.mean(dim=(-1, -2)), pos, reduce)


def total_loss(outputs: dict, targets: dict,
               loss_weights: dict | None = None, reduce=None):
    """Weighted sum of the 5 losses, and the losses by name. ``reduce``:
    see the module docstring."""
    lw = loss_weights or {}
    losses = {
        "rpn_class_loss": rpn_class_loss(
            targets["rpn_match"], outputs["rpn_class_logits"], reduce),
        "rpn_bbox_loss": rpn_bbox_loss(
            targets["rpn_bbox"], targets["rpn_match"], outputs["rpn_bbox"],
            reduce),
        "mrcnn_class_loss": mrcnn_class_loss(
            targets["target_class_ids"], outputs["mrcnn_class_logits"],
            targets["active_class_ids"], targets["roi_valid"], reduce),
        "mrcnn_bbox_loss": mrcnn_bbox_loss(
            targets["target_bbox"], targets["target_class_ids"],
            outputs["mrcnn_bbox"], reduce),
        "mrcnn_mask_loss": mrcnn_mask_loss(
            targets["target_mask"], targets["target_class_ids"],
            outputs["mrcnn_masks"], reduce),
    }
    total = sum(lw.get(k, 1.0) * v for k, v in losses.items())
    return total, losses
