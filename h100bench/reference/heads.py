"""A frozen copy of the port's ``models/heads.py`` (plain PyTorch, no kernel):
the benchmark's reference.

FPN classifier + mask heads.

Port of slam_maskrcnn_tpu/models/heads.py (``fpn_classifier_graph`` /
``build_fpn_mask_graph``, ``Mask_RCNN/mrcnn/model.py:905-1008``). Rois fold
into the batch axis; both heads take pooled features [R, pool, pool, C]
(NHWC, as ROIAlign writes them).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from h100bench.reference.backbone import BatchNorm, Conv, quant


class Dense(nn.Module):
    """Linear layer in ``dtype`` with float32 parameters; weight [out, in]."""

    def __init__(self, cin: int, cout: int, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dtype = dtype

    def forward(self, x):
        return F.linear(quant(x.to(self.dtype)),
                        quant(self.weight.to(self.dtype)),
                        self.bias.to(self.dtype))


class ConvTranspose(nn.Module):
    """Transposed conv (kernel k, stride k); weight [in, out, k, k] in
    PyTorch's convention (models/weights.py flips Flax's kernel)."""

    def __init__(self, cin: int, cout: int, kernel: int = 2,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.kernel, self.dtype = kernel, dtype

    def forward(self, x):
        return F.conv_transpose2d(quant(x.to(self.dtype)),
                                  quant(self.weight.to(self.dtype)),
                                  self.bias.to(self.dtype),
                                  stride=self.kernel)


class FPNClassifier(nn.Module):
    """Classifier + box regressor. Returns (class_logits [R, num_classes]
    f32, probs, bbox deltas [R, num_classes, 4] f32)."""

    def __init__(self, num_classes: int, pool_size: int = 7,
                 fc_size: int = 1024, depth: int = 256, dtype=torch.float32):
        super().__init__()
        self.num_classes, self.fc_size = num_classes, fc_size
        self.mrcnn_class_conv1 = Conv(depth, fc_size, pool_size,
                                      padding="VALID", dtype=dtype)
        self.mrcnn_class_bn1 = BatchNorm(fc_size)
        self.mrcnn_class_conv2 = Conv(fc_size, fc_size, 1, padding="VALID",
                                      dtype=dtype)
        self.mrcnn_class_bn2 = BatchNorm(fc_size)
        self.mrcnn_class_logits = Dense(fc_size, num_classes, dtype)
        self.mrcnn_bbox_fc = Dense(fc_size, num_classes * 4, dtype)

    def forward(self, x):
        R = x.shape[0]
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.mrcnn_class_bn1(self.mrcnn_class_conv1(x)))
        x = F.relu(self.mrcnn_class_bn2(self.mrcnn_class_conv2(x)))
        shared = x.reshape(R, self.fc_size)
        logits = self.mrcnn_class_logits(shared).float()
        probs = torch.softmax(logits, dim=-1)
        bbox = self.mrcnn_bbox_fc(shared).float()
        return logits, probs, bbox.reshape(R, self.num_classes, 4)


class MaskHead(nn.Module):
    """4x conv256+BN+relu, 2x2/2 deconv, 1x1 sigmoid. Returns masks
    [R, 2*pool, 2*pool, num_classes] f32 in [0, 1]."""

    def __init__(self, num_classes: int, depth: int = 256,
                 dtype=torch.float32):
        super().__init__()
        for i in range(1, 5):
            self.add_module(f"mrcnn_mask_conv{i}",
                            Conv(depth if i == 1 else 256, 256, 3,
                                 dtype=dtype))
            self.add_module(f"mrcnn_mask_bn{i}", BatchNorm(256))
        self.mrcnn_mask_deconv = ConvTranspose(256, 256, 2, dtype)
        self.mrcnn_mask = Conv(256, num_classes, 1, dtype=dtype)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for i in range(1, 5):
            x = self._modules[f"mrcnn_mask_conv{i}"](x)
            x = F.relu(self._modules[f"mrcnn_mask_bn{i}"](x))
        x = F.relu(self.mrcnn_mask_deconv(x))
        x = self.mrcnn_mask(x)
        return torch.sigmoid(x.float()).permute(0, 2, 3, 1)
