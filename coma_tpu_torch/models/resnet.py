"""ResNet backbones (NCHW) for Hand4Whole's body, hand and face towers.

Counterpart of ``coma_tpu/models/resnet.py`` (reference:
``imports/hand4whole/common/nets/resnet.py``, torchvision's ResNet-18/50
without the classification head; output stride 32, 512 / 2048 features).
Submodules carry ``coma_tpu``'s Flax names (``conv1``, ``bn1``,
``layer{i}_{j}``, ``down_conv``, ``down_bn``), so ``models/flax_params.py``
carries its parameters across. Batch norm uses the running statistics with
Flax's eps of 1e-5; the max pool pads with −inf.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm(use_running_average=True)`` over NCHW (eps
    1e-5): ``weight``/``bias`` and the ``running_mean``/``running_var``
    buffers, nothing else in the state dict."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=self.eps)


def conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = conv(cin, filters, 3, stride, 1)
        self.bn1 = BatchNorm(filters)
        self.conv2 = conv(filters, filters, 3, 1, 1)
        self.bn2 = BatchNorm(filters)
        if cin != filters or stride != 1:
            self.down_conv = conv(cin, filters, 1, stride)
            self.down_bn = BatchNorm(filters)
        else:
            self.down_conv = None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.down_conv is None else self.down_bn(self.down_conv(x))
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = conv(cin, filters, 1)
        self.bn1 = BatchNorm(filters)
        self.conv2 = conv(filters, filters, 3, stride, 1)
        self.bn2 = BatchNorm(filters)
        self.conv3 = conv(filters, filters * 4, 1)
        self.bn3 = BatchNorm(filters * 4)
        if cin != filters * 4 or stride != 1:
            self.down_conv = conv(cin, filters * 4, 1, stride)
            self.down_bn = BatchNorm(filters * 4)
        else:
            self.down_conv = None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.down_conv is None else self.down_bn(self.down_conv(x))
        return F.relu(y + residual)


class ResNet(nn.Module):
    """Feature extractor: (B, 3, H, W) -> (B, feat_dim, H/32, W/32)."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), bottleneck: bool = True):
        super().__init__()
        block = Bottleneck if bottleneck else BasicBlock
        self.conv1 = conv(3, 64, 7, 2, 3)
        self.bn1 = BatchNorm(64)
        cin = 64
        self.blocks = []
        for i, (n_blocks, filters) in enumerate(zip(stage_sizes, (64, 128, 256, 512))):
            for j in range(n_blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                name = f"layer{i + 1}_{j}"
                self.add_module(name, block(cin, filters, stride))
                self.blocks.append(name)
                cin = filters * block.expansion
        self.feat_dim = cin

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return x


def resnet50() -> ResNet:
    """ResNet-50: bottleneck blocks (3, 4, 6, 3), 2048 features."""
    return ResNet(stage_sizes=(3, 4, 6, 3), bottleneck=True)


def resnet18() -> ResNet:
    """ResNet-18: basic blocks (2, 2, 2, 2), 512 features."""
    return ResNet(stage_sizes=(2, 2, 2, 2), bottleneck=False)
