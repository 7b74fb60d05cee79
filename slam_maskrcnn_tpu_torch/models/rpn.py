"""Region Proposal Network head.

Port of slam_maskrcnn_tpu/models/rpn.py (``rpn_graph``,
``Mask_RCNN/mrcnn/model.py:835-901``): one head with shared weights,
applied to every pyramid level.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from slam_maskrcnn_tpu_torch.models.backbone import Conv


class RPNHead(nn.Module):
    """Per-level RPN on an NCHW feature map. Returns (class_logits
    [B, N, 2], probs [B, N, 2], bbox deltas [B, N, 4]), all float32, with
    anchors ordered (y, x, anchor) as in the JAX package's NHWC reshape."""

    def __init__(self, anchors_per_location: int = 3, anchor_stride: int = 1,
                 depth: int = 256, dtype=torch.float32):
        super().__init__()
        a = anchors_per_location
        self.rpn_conv_shared = Conv(depth, 512, 3, anchor_stride, dtype=dtype)
        self.rpn_class_raw = Conv(512, 2 * a, 1, padding="VALID", dtype=dtype)
        self.rpn_bbox_pred = Conv(512, 4 * a, 1, padding="VALID", dtype=dtype)

    def forward(self, x):
        B = x.shape[0]
        shared = F.relu(self.rpn_conv_shared(x))
        cls = self.rpn_class_raw(shared).permute(0, 2, 3, 1)
        logits = cls.reshape(B, -1, 2).float()
        probs = torch.softmax(logits, dim=-1)
        bbox = self.rpn_bbox_pred(shared).permute(0, 2, 3, 1)
        return logits, probs, bbox.reshape(B, -1, 4).float()
