"""The Mask R-CNN inference graph, plain PyTorch: a frozen copy of the
port's ``models/mask_rcnn.py`` ``MaskRCNNModule`` (``Mask_RCNN/mrcnn/
model.py:1812-2672``): backbone -> FPN -> RPN -> proposals -> ROIAlign ->
heads -> detections -> ROIAlign -> mask head -> class-plane select ->
uint8 quantisation, with static shapes, and the plain NMS and ROIAlign in
place of the port's kernels. Parameter names are the port's, so one
state dict loads into both.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from h100bench.reference.backbone import FPN, ResNet
from h100bench.reference.detection import detection_layer
from h100bench.reference.heads import FPNClassifier, MaskHead
from h100bench.reference.proposal import generate_proposals
from h100bench.reference.roi_align import pyramid_roi_align
from h100bench.reference.rpn import RPNHead


@contextlib.contextmanager
def _exact_f32(enabled: bool):
    """TF32 off for cuDNN convolutions and CUDA matmuls inside the block
    (when ``enabled``), the caller's flags restored after."""
    if not enabled:
        yield
        return
    conv = torch.backends.cudnn.allow_tf32
    mm = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


class MaskRCNNModule(nn.Module):
    """The graph. ``forward`` (inference) returns detections [B, D, 6] and
    class-selected masks [B, D, 28, 28] uint8, plus the proposals and RPN
    outputs; ``train_forward`` the head outputs and sampled targets the
    losses take. BatchNorm uses batch statistics only while the module is
    in train mode (TRAIN_BN)."""

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
        self.dtype = dtype
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
        with _exact_f32(self.dtype == torch.float32):
            return self._forward(images, anchors, windows)

    def _forward(self, images, anchors, windows):
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
