"""A frozen copy of the port's ``models/backbone.py`` (plain PyTorch, no kernel):
the benchmark's reference.

ResNet-50/101 + FPN backbone.

Port of slam_maskrcnn_tpu/models/backbone.py (the reference's
``resnet_graph`` + FPN, ``Mask_RCNN/mrcnn/model.py:101-212, 1894-1911``):
ZeroPad(3) + 7x7/2 valid stem, bottleneck stages [3, 4, {6|23}, 3], FPN
lateral 1x1 + top-down nearest upsample-add + 3x3 smoothing, P6 = stride-2
subsample of P5.

Module names mirror the JAX package's Flax scopes (``conv1``,
``Bottleneck_<i>.res2a_branch2a``, ``fpn_c5p5``, ...) so models/weights.py
carries its variables over by name. Tensors are NCHW in the channels-last
memory format; convolutions run in ``dtype`` (bf16 on the GPU) with
float32 parameters, and BatchNorm runs in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# The precision control (tests/test_h100bench_control.py) sets a float8
# type here: every convolution and dense layer's input and weight are
# rounded through it before the layer runs in ``dtype``.
QUANT = None


def quant(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through ``QUANT`` (unchanged while it is None)."""
    return t if QUANT is None else t.to(QUANT).to(t.dtype)


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """TF/Flax "SAME" padding (before, after) along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """Conv2d with Flax's SAME/VALID padding; weight OIHW, bias [O]."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: str = "SAME", dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.kernel, self.stride, self.padding = kernel, stride, padding
        self.dtype = dtype

    def forward(self, x):
        x = quant(x.to(self.dtype))
        if self.padding == "SAME" and self.kernel > 1:
            pt, pb = same_padding(x.shape[2], self.kernel, self.stride)
            pl, pr = same_padding(x.shape[3], self.kernel, self.stride)
            if pt == pb and pl == pr:
                return F.conv2d(x, quant(self.weight.to(self.dtype)),
                                self.bias.to(self.dtype), self.stride,
                                (pt, pl))
            x = F.pad(x, (pl, pr, pt, pb))
        return F.conv2d(x, quant(self.weight.to(self.dtype)),
                        self.bias.to(self.dtype), self.stride)


class BatchNorm(nn.Module):
    """Keras-style BatchNorm (epsilon 1e-3) over channel dim 1, in
    float32: y = (x - mean) * (rsqrt(var + eps) * scale) + bias, as Flax
    computes it. Returns the input's dtype. In train mode (used only by
    ``h100bench/weights.calibrate``) the batch's statistics normalize, with
    Flax's fast variance E[x^2] - E[x]^2 (floored at 0), and the running
    averages move by ``momentum`` (ra = m ra + (1 - m) stat)."""

    eps = 1e-3
    momentum = 0.99

    def __init__(self, n: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("mean", torch.zeros(n))
        self.register_buffer("var", torch.ones(n))

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xf = x.float()
        if self.training:
            axes = (0,) + tuple(range(2, x.dim()))
            mean = xf.mean(axes)
            var = ((xf * xf).mean(axes) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class Bottleneck(nn.Module):
    """identity_block / conv_block (model.py:101-177)."""

    def __init__(self, cin: int, filters, stage: int, block: str,
                 stride: int = 1, conv_shortcut: bool = False,
                 dtype=torch.float32):
        super().__init__()
        f1, f2, f3 = filters
        c = f"res{stage}{block}_branch"
        b = f"bn{stage}{block}_branch"
        self.names = (c, b)
        self.add_module(c + "2a", Conv(cin, f1, 1, stride, dtype=dtype))
        self.add_module(b + "2a", BatchNorm(f1))
        self.add_module(c + "2b", Conv(f1, f2, 3, dtype=dtype))
        self.add_module(b + "2b", BatchNorm(f2))
        self.add_module(c + "2c", Conv(f2, f3, 1, dtype=dtype))
        self.add_module(b + "2c", BatchNorm(f3))
        self.conv_shortcut = conv_shortcut
        if conv_shortcut:
            self.add_module(c + "1", Conv(cin, f3, 1, stride, dtype=dtype))
            self.add_module(b + "1", BatchNorm(f3))

    def forward(self, x):
        c, b = self.names
        m = self._modules
        y = F.relu(m[b + "2a"](m[c + "2a"](x)))
        y = F.relu(m[b + "2b"](m[c + "2b"](y)))
        y = m[b + "2c"](m[c + "2c"](y))
        sc = m[b + "1"](m[c + "1"](x)) if self.conv_shortcut else x
        return F.relu(y + sc)


class ResNet(nn.Module):
    """resnet_graph (model.py:177-212). Returns (C2, C3, C4, C5)."""

    def __init__(self, architecture: str = "resnet101", dtype=torch.float32):
        super().__init__()
        if architecture not in ("resnet50", "resnet101"):
            raise ValueError(f"unknown backbone {architecture!r}")
        self.dtype = dtype
        self.conv1 = Conv(3, 64, 7, 2, padding="VALID", dtype=dtype)
        self.bn_conv1 = BatchNorm(64)
        n4 = {"resnet50": 5, "resnet101": 22}[architecture]
        # (cin, filters, stage, block, stride, conv_shortcut) in the order
        # Flax numbers its Bottleneck_<i> scopes
        spec = [(64, (64, 64, 256), 2, "a", 1, True),
                (256, (64, 64, 256), 2, "b", 1, False),
                (256, (64, 64, 256), 2, "c", 1, False),
                (256, (128, 128, 512), 3, "a", 2, True)]
        spec += [(512, (128, 128, 512), 3, b, 1, False) for b in "bcd"]
        spec += [(512, (256, 256, 1024), 4, "a", 2, True)]
        spec += [(1024, (256, 256, 1024), 4, chr(98 + i), 1, False)
                 for i in range(n4)]
        spec += [(1024, (512, 512, 2048), 5, "a", 2, True),
                 (2048, (512, 512, 2048), 5, "b", 1, False),
                 (2048, (512, 512, 2048), 5, "c", 1, False)]
        self.blocks = []
        for i, (cin, f, stage, block, s, cs) in enumerate(spec):
            self.add_module(f"Bottleneck_{i}",
                            Bottleneck(cin, f, stage, block, s, cs, dtype))
            self.blocks.append((f"Bottleneck_{i}", stage, block))

    def forward(self, x):
        x = x.to(self.dtype)
        # Stage 1: ZeroPadding2D(3) + 7x7/2 valid + BN + relu + 3x3/2 SAME
        # max-pool (Flax SAME pads 0 before / 1 after on even sizes, with
        # -inf)
        x = self.conv1(F.pad(x, (3, 3, 3, 3)))
        x = F.relu(self.bn_conv1(x))
        pt, pb = same_padding(x.shape[2], 3, 2)
        pl, pr = same_padding(x.shape[3], 3, 2)
        x = F.max_pool2d(F.pad(x, (pl, pr, pt, pb), value=-math.inf), 3, 2)
        outs = {}
        for name, stage, _block in self.blocks:
            x = self._modules[name](x)
            outs[stage] = x
        return outs[2], outs[3], outs[4], outs[5]


class FPN(nn.Module):
    """Top-down pyramid (model.py:1894-1911). Returns (P2, P3, P4, P5, P6)."""

    def __init__(self, size: int = 256, dtype=torch.float32):
        super().__init__()
        self.fpn_c5p5 = Conv(2048, size, 1, dtype=dtype)
        self.fpn_c4p4 = Conv(1024, size, 1, dtype=dtype)
        self.fpn_c3p3 = Conv(512, size, 1, dtype=dtype)
        self.fpn_c2p2 = Conv(256, size, 1, dtype=dtype)
        self.fpn_p2 = Conv(size, size, 3, dtype=dtype)
        self.fpn_p3 = Conv(size, size, 3, dtype=dtype)
        self.fpn_p4 = Conv(size, size, 3, dtype=dtype)
        self.fpn_p5 = Conv(size, size, 3, dtype=dtype)

    def forward(self, c2, c3, c4, c5):
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")
        p5 = self.fpn_c5p5(c5)
        p4 = up(p5) + self.fpn_c4p4(c4)
        p3 = up(p4) + self.fpn_c3p3(c3)
        p2 = up(p3) + self.fpn_c2p2(c2)
        p2 = self.fpn_p2(p2)
        p3 = self.fpn_p3(p3)
        p4 = self.fpn_p4(p4)
        p5 = self.fpn_p5(p5)
        # P6: MaxPooling2D(pool_size=1, strides=2) == stride-2 subsample
        p6 = p5[:, :, ::2, ::2]
        return p2, p3, p4, p5, p6
