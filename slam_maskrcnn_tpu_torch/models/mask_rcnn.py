"""Mask R-CNN inference graph.

Port of slam_maskrcnn_tpu/models/mask_rcnn.py (``MaskRCNN``,
``Mask_RCNN/mrcnn/model.py:1812-2672``), inference mode only: backbone ->
FPN -> RPN -> proposals -> ROIAlign -> heads -> detections -> ROIAlign ->
mask head -> class-plane select -> uint8 quantisation, with static shapes.
Images are NHWC float32 (molded), as in the JAX package.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from slam_maskrcnn_tpu_torch.device import resolve_device
from slam_maskrcnn_tpu_torch.models.backbone import FPN, Conv, ResNet
from slam_maskrcnn_tpu_torch.models.config import Config
from slam_maskrcnn_tpu_torch.models.detection import detection_layer
from slam_maskrcnn_tpu_torch.models.heads import (ConvTranspose, Dense,
                                                  FPNClassifier, MaskHead)
from slam_maskrcnn_tpu_torch.models.proposal import generate_proposals
from slam_maskrcnn_tpu_torch.models.rpn import RPNHead
from slam_maskrcnn_tpu_torch.ops.roi_align import pyramid_roi_align


class MaskRCNNModule(nn.Module):
    """The inference graph. ``forward`` returns detections [B, D, 6] and
    class-selected masks [B, D, 28, 28] uint8, plus the proposals and RPN
    outputs."""

    def __init__(self, num_classes: int, backbone: str = "resnet101",
                 image_shape=(1024, 1024), pool_size: int = 7,
                 mask_pool_size: int = 14, fc_size: int = 1024,
                 top_down: int = 256, anchors_per_location: int = 3,
                 anchor_stride: int = 1, proposal_count: int = 1000,
                 rpn_nms_threshold: float = 0.7, pre_nms_limit: int = 6000,
                 detection_max_instances: int = 100,
                 detection_min_confidence: float = 0.7,
                 detection_nms_threshold: float = 0.3,
                 rpn_bbox_std=(0.1, 0.1, 0.2, 0.2),
                 bbox_std=(0.1, 0.1, 0.2, 0.2), dtype=torch.bfloat16):
        super().__init__()
        self.num_classes = num_classes
        self.image_shape = tuple(image_shape)
        self.pool_size, self.mask_pool_size = pool_size, mask_pool_size
        self.proposal_count = proposal_count
        self.rpn_nms_threshold = rpn_nms_threshold
        self.pre_nms_limit = pre_nms_limit
        self.detection_max_instances = detection_max_instances
        self.detection_min_confidence = detection_min_confidence
        self.detection_nms_threshold = detection_nms_threshold
        self.rpn_bbox_std, self.bbox_std = rpn_bbox_std, bbox_std
        self.resnet = ResNet(backbone, dtype)
        self.fpn = FPN(top_down, dtype)
        self.rpn_model = RPNHead(anchors_per_location, anchor_stride,
                                 top_down, dtype)
        self.fpn_classifier = FPNClassifier(num_classes, pool_size, fc_size,
                                            top_down, dtype)
        self.fpn_mask = MaskHead(num_classes, top_down, dtype)

    def features(self, images):
        """images [B, H, W, 3] -> (P2..P6), NCHW in channels-last memory."""
        x = images.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        return self.fpn(*self.resnet(x))

    def rpn_outputs(self, pyramid):
        outs = [self.rpn_model(p) for p in pyramid]
        return tuple(torch.cat([o[i] for o in outs], dim=1) for i in range(3))

    def _roi_align(self, feats, boxes, pool):
        """PyramidROIAlign of the whole batch (one kernel launch) on NHWC
        views of the NCHW levels, which are contiguous: the levels live in
        channels-last memory. Returns f32 [B, N, pool, pool, C]."""
        return pyramid_roi_align(tuple(f.permute(0, 2, 3, 1) for f in feats),
                                 boxes, pool, self.image_shape)

    @torch.no_grad()
    def forward(self, images, anchors, windows):
        """images [B, H, W, 3] molded f32; anchors [A, 4] normalized;
        windows [B, 4] normalized."""
        pyramid = self.features(images)
        feats = pyramid[:4]
        _, rpn_probs, rpn_bbox = self.rpn_outputs(pyramid)
        proposals, _ = generate_proposals(
            rpn_probs, rpn_bbox, anchors, self.proposal_count,
            self.rpn_nms_threshold, self.pre_nms_limit, self.rpn_bbox_std)
        B, N = proposals.shape[:2]
        pooled = self._roi_align(feats, proposals, self.pool_size)
        _, probs, bbox = self.fpn_classifier(pooled.flatten(0, 1))
        detections, det_valid = detection_layer(
            proposals, probs.reshape(B, N, -1),
            bbox.reshape(B, N, -1, 4), windows,
            max_instances=self.detection_max_instances,
            min_confidence=self.detection_min_confidence,
            nms_threshold=self.detection_nms_threshold,
            bbox_std=self.bbox_std)
        D = detections.shape[1]
        mpooled = self._roi_align(feats, detections[..., :4],
                                  self.mask_pool_size)
        masks = self.fpn_mask(mpooled.flatten(0, 1))      # [B*D, 28, 28, C]
        cls = detections[..., 4].long().reshape(B * D, 1, 1, 1)
        masks = torch.gather(masks, 3, cls.expand(-1, *masks.shape[1:3], 1))
        masks = torch.round(masks[..., 0] * 255.0).to(torch.uint8)
        return dict(detections=detections, detection_valid=det_valid,
                    masks=masks.reshape(B, D, *masks.shape[1:]),
                    proposals=proposals, rpn_probs=rpn_probs,
                    rpn_bbox=rpn_bbox)


def _init_(module: nn.Module, gen: torch.Generator) -> None:
    """Seeded LeCun-normal weights (fan-in scaled, as Flax's default
    initialiser), zero biases, identity BatchNorm."""
    for m in module.modules():
        if isinstance(m, (Conv, Dense)):
            fan_in = math.prod(m.weight.shape[1:])
            with torch.no_grad():
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               / math.sqrt(fan_in))
        elif isinstance(m, ConvTranspose):
            fan_in = m.weight.shape[0] * m.weight.shape[2] * m.weight.shape[3]
            with torch.no_grad():
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               / math.sqrt(fan_in))
    # BatchNorm keeps its construction: the identity (scale 1, bias 0,
    # mean 0, var 1)


class MaskRCNN:
    """User-facing wrapper: config -> module on ``device`` (default CUDA).
    ``init_params(seed)`` fills seeded random weights; models/weights.py
    ``load_jax_params`` carries the JAX package's variables instead."""

    def __init__(self, mode: str, config: Config, device="cuda"):
        if mode != "inference":
            raise NotImplementedError("the port implements inference only")
        self.mode = mode
        self.config = config
        self.device = resolve_device(device)
        shape = tuple(int(s) for s in config.IMAGE_SHAPE[:2])
        self.module = MaskRCNNModule(
            num_classes=config.NUM_CLASSES,
            backbone=config.BACKBONE,
            image_shape=shape,
            pool_size=config.POOL_SIZE,
            mask_pool_size=config.MASK_POOL_SIZE,
            fc_size=config.FPN_CLASSIF_FC_LAYERS_SIZE,
            top_down=config.TOP_DOWN_PYRAMID_SIZE,
            anchors_per_location=len(config.RPN_ANCHOR_RATIOS),
            anchor_stride=config.RPN_ANCHOR_STRIDE,
            proposal_count=config.POST_NMS_ROIS_INFERENCE,
            rpn_nms_threshold=config.RPN_NMS_THRESHOLD,
            pre_nms_limit=config.PRE_NMS_LIMIT,
            detection_max_instances=config.DETECTION_MAX_INSTANCES,
            detection_min_confidence=config.DETECTION_MIN_CONFIDENCE or 0.0,
            detection_nms_threshold=config.DETECTION_NMS_THRESHOLD,
            rpn_bbox_std=tuple(float(v) for v in config.RPN_BBOX_STD_DEV),
            bbox_std=tuple(float(v) for v in config.BBOX_STD_DEV),
            dtype=(torch.bfloat16 if config.COMPUTE_DTYPE == "bfloat16"
                   else torch.float32),
        ).eval()

    def init_params(self, seed: int = 0):
        """Seeded random weights (drawn on the CPU, so every device gets the
        same values), then moved to the device."""
        gen = torch.Generator().manual_seed(seed)
        _init_(self.module, gen)
        self.module.to(self.device)
        return self.module
