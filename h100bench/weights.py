"""Seeded detector weights, drawn on the device.

Both sides get the same values: the harness draws them into the
reference's module (``reference/mask_rcnn.py``, whose parameter names are
the port's) and loads that state dict into the port's module with
``load_state_dict(strict=True)``; after the window it draws them again
from the same seed for the reference.

The draw (``draw``): every convolution, dense and transposed-convolution
weight LeCun-normal (standard normal over sqrt(fan in), as the port's
``init_params``), all of them from one ``randn`` call on the card's
generator; biases 0; BatchNorm the identity; the class logits' bias
``class_bias.background`` for the background. Then ``calibrate`` sets,
from four frames of the traffic, what a trained detector's output regime
needs and random weights give differently for every seed: the BatchNorm
statistics, then three biases from the configuration's ``weights``
section: the class logits' (one class, drawn from the seed, ahead by as
much as gives ``detections`` a frame, or every roi past the confidence
where that is the configuration's cap), the box head's log-size
refinements (the detections' median box ``box_area_share`` of the
frame) and the mask logits' (``mask_cover`` of the detections' mask
cells on). So every seed detects about as many instances of about the
same sizes.
"""

from __future__ import annotations

import math

import torch

from h100bench.reference.backbone import BatchNorm, Conv
from h100bench.reference.boxes import apply_box_deltas, clip_boxes
from h100bench.reference.heads import ConvTranspose, Dense
from h100bench.reference.mask_rcnn import MaskRCNNModule
from h100bench.reference.nms import NEG_INF, non_max_suppression


def reference_module(det: dict, dev) -> MaskRCNNModule:
    """The reference graph for a configuration's ``detector`` section."""
    return MaskRCNNModule(
        num_classes=det["NUM_CLASSES"], backbone=det["BACKBONE"],
        image_shape=tuple(det["IMAGE_SHAPE"][:2]),
        pool_size=det["POOL_SIZE"], mask_pool_size=det["MASK_POOL_SIZE"],
        fc_size=det["FPN_CLASSIF_FC_LAYERS_SIZE"],
        top_down=det["TOP_DOWN_PYRAMID_SIZE"],
        anchors_per_location=len(det["RPN_ANCHOR_RATIOS"]),
        anchor_stride=det["RPN_ANCHOR_STRIDE"],
        proposal_count=det["POST_NMS_ROIS_INFERENCE"],
        rpn_nms_threshold=det["RPN_NMS_THRESHOLD"],
        pre_nms_limit=det["PRE_NMS_LIMIT"],
        detection_max_instances=det["DETECTION_MAX_INSTANCES"],
        detection_min_confidence=det["DETECTION_MIN_CONFIDENCE"],
        detection_nms_threshold=det["DETECTION_NMS_THRESHOLD"],
        rpn_bbox_std=tuple(det["RPN_BBOX_STD_DEV"]),
        bbox_std=tuple(det["BBOX_STD_DEV"]),
        dtype=getattr(torch, det["COMPUTE_DTYPE"])).eval()


def _fan_in(m) -> int:
    w = m.weight
    if isinstance(m, ConvTranspose):            # [in, out, k, k]
        return w.shape[0] * w.shape[2] * w.shape[3]
    return math.prod(w.shape[1:])


@torch.no_grad()
def draw(module: MaskRCNNModule, seed: int, wcfg: dict) -> None:
    """Fill ``module`` (already on its device) in place from ``seed`` and
    a configuration's ``weights`` section; ``calibrate`` completes it."""
    dev = next(module.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    layers = [m for m in module.modules()
              if isinstance(m, (Conv, Dense, ConvTranspose))]
    flat = torch.randn(sum(m.weight.numel() for m in layers),
                       generator=gen, device=dev)
    at = 0
    for m in layers:
        n = m.weight.numel()
        m.weight.copy_(flat[at:at + n].view_as(m.weight)
                       / math.sqrt(_fan_in(m)))
        at += n
    head = module.fpn_classifier
    head.mrcnn_class_logits.bias[0] = wcfg["class_bias"]["background"]
    module.detected_class = int(torch.randint(
        1, head.num_classes, (1,), generator=gen, device=dev))


def _outputs(module: MaskRCNNModule, layer, images, anchors, windows):
    """The graph's outputs on ``images`` and what ``layer`` returned."""
    seen = []
    hook = layer.register_forward_hook(lambda m, i, o: seen.append(o))
    try:
        out = module(images, anchors, windows)
    finally:
        hook.remove()
    return out, seen[-1]


@torch.no_grad()
def calibrate(module: MaskRCNNModule, images, anchors, windows, wcfg: dict,
              bbox_std) -> None:
    """Complete ``draw``'s weights on ``images`` (molded, a few frames of
    the traffic, ``calibration_frames``).

    BatchNorm: the running mean and variance its input has on the frames
    (one pass in train mode, the running averages taking the batch's
    values). With the identity BatchNorm, LeCun weights grow the trunk's
    activations to hundreds and every class logit and box delta
    saturates; normalized, the graph proposes, classifies and masks at
    the scales a trained one does. Then the three biases, in the order
    each depends on the one before: every roi passing while the boxes
    are sized, then as many as give the detections a frame."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.momentum = 0.0
    module.train()
    module(images, anchors, windows)
    module.eval()
    for m in bns:
        del m.momentum
    _class_bias(module, images, anchors, windows, None, bbox_std)
    _box_bias(module, images, anchors, windows, wcfg["box_area_share"],
              bbox_std)
    if wcfg["detections"] < module.detection_max_instances:
        _class_bias(module, images, anchors, windows, wcfg["detections"],
                    bbox_std)
    _mask_bias(module, images, anchors, windows, wcfg["mask_cover"])


def calibration_frames(n: int) -> list:
    """The orbit's frames the weights are calibrated on: four, a quarter
    of the orbit apart, from frame 0."""
    return [k * n // 4 for k in range(4)]


def _class_bias(module, images, anchors, windows, per_frame, bbox_std):
    """The detected class's logit bias. With ``per_frame`` None, every roi
    passes the detection confidence. Otherwise the frames' detections
    average ``per_frame``: the rois that pass are those whose needed bias
    is below it, and the detection layer's greedy NMS over them keeps,
    of the frames' NMS survivors (in the order of that need, as the
    scores rank them), those below it; the bias sits halfway between the
    last survivor kept and the next."""
    k = module.detected_class
    head = module.fpn_classifier
    head.mrcnn_class_logits.bias[k] = 0.0
    out, (logits, _, deltas) = _outputs(module, head, images, anchors,
                                        windows)
    rois = out["proposals"]
    B, N = rois.shape[:2]
    logits = logits.float().view(B, N, -1)
    c = module.detection_min_confidence
    others = torch.cat([logits[..., :k], logits[..., k + 1:]], -1)
    # softmax(logits + b e_k)[k] >= c  <=>  b >= need
    need = (math.log(c / (1 - c)) + torch.logsumexp(others, -1)
            - logits[..., k])                              # [B, N]
    if per_frame is None:
        head.mrcnn_class_logits.bias[k] = float(need.max()) + 1.0
        return
    std = torch.as_tensor(bbox_std, dtype=torch.float32, device=rois.device)
    boxes = apply_box_deltas(rois, deltas.float().view(B, N, -1, 4)[:, :, k]
                             * std)
    boxes = torch.stack([clip_boxes(boxes[b], windows[b]) for b in range(B)])
    live = (rois[..., 2] - rois[..., 0]) * (rois[..., 3] - rois[..., 1]) > 0
    idx, ok = non_max_suppression(boxes, torch.where(live, -need, NEG_INF), N,
                                  module.detection_nms_threshold,
                                  score_threshold=NEG_INF / 2)
    kept = torch.gather(need, 1, idx)[ok].sort().values
    t = per_frame * B
    b = float(kept[-1]) + 1.0 if t >= kept.numel() else \
        float(kept[t - 1] + kept[t]) / 2
    head.mrcnn_class_logits.bias[k] = b


def _box_bias(module, images, anchors, windows, share: float,
              bbox_std, rounds: int = 2) -> None:
    """The box head's log-size refinements (the same for every class):
    scaled, in ``rounds`` passes, until the detections' median box covers
    ``share`` of the frame (the molded image's window)."""
    box = module.fpn_classifier.mrcnn_bbox_fc.bias.view(
        module.num_classes, 4)
    scale = 1.0
    wh = windows[:, 2:] - windows[:, :2]                # [B, 2]
    for _ in range(rounds):
        for j in (2, 3):                   # log(h), log(w)
            box[:, j] = math.log(scale) / bbox_std[j]
        out = module(images, anchors, windows)
        d = out["detections"][..., :4]
        hw = (d[..., 2:] - d[..., :2]) / wh[:, None]
        area = hw.prod(-1)[out["detection_valid"]]
        scale *= math.sqrt(share / float(area.median()))
    for j in (2, 3):
        box[:, j] = math.log(scale) / bbox_std[j]


def _mask_bias(module, images, anchors, windows, cover: float) -> None:
    """The mask logits' bias: ``cover`` of the 28 x 28 mask cells of the
    frame's detections (each in its class's plane) on."""
    conv = module.fpn_mask.mrcnn_mask
    conv.bias.zero_()
    out, logits = _outputs(module, conv, images, anchors, windows)
    logits = logits.float()                        # [B * D, C, 28, 28]
    cls = out["detections"][..., 4].long().flatten()
    valid = out["detection_valid"].flatten()
    picked = logits[torch.arange(cls.numel(), device=cls.device), cls]
    conv.bias.fill_(-float(torch.quantile(picked[valid].flatten(),
                                          1.0 - cover)))
