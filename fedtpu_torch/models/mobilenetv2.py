"""MobileNetV2 for CIFAR: the port of ``fedtpu.models.mobilenetv2``.

A 3x3/32 stem, 17 inverted-residual blocks (``InvertedResidual_0..16``:
1x1 expand ``Conv_0``, 3x3 depthwise ``Conv_1``, linear 1x1 project
``Conv_2``) per fedtpu's CIFAR ``_CFG``, a 1x1/1280 head conv (the
module's ``Conv_1``/``BatchNorm_1``), global average pool and a dense
head. A stride-1 block adds its input, through a 1x1 projection
(``Conv_3``/``BatchNorm_3``, created last) when the channel count changes;
a stride-2 block adds nothing. At 10 classes: 2,296,922 params in 173
leaves, 35,088 statistics in 114. Inputs are NHWC at the public boundary;
train and eval mode follow :mod:`fedtpu_torch.models.common`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from fedtpu_torch.models.common import (
    BatchNorm,
    Stats,
    conv1x1,
    conv3x3,
    depthwise3x3,
    global_avg_pool,
    name_batch_norms,
)
from fedtpu_torch.models.registry import register

# (expansion, out_channels, num_blocks, stride)
_CFG: Sequence[Tuple[int, int, int, int]] = (
    (1, 16, 1, 1),
    (6, 24, 2, 1),  # stride 2 -> 1 for CIFAR
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


class InvertedResidual(nn.Module):
    def __init__(self, in_ch: int, features: int, expansion: int, stride: int = 1):
        super().__init__()
        mid = expansion * in_ch
        self.stride = stride
        self.Conv_0 = conv1x1(in_ch, mid)
        self.BatchNorm_0 = BatchNorm(mid)
        self.Conv_1 = depthwise3x3(mid, stride)
        self.BatchNorm_1 = BatchNorm(mid)
        self.Conv_2 = conv1x1(mid, features)
        self.BatchNorm_2 = BatchNorm(features)
        self.project = stride == 1 and in_ch != features
        if self.project:
            self.Conv_3 = conv1x1(in_ch, features)
            self.BatchNorm_3 = BatchNorm(features)

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), stats))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), stats))
        y = self.BatchNorm_2(self.Conv_2(y), stats)
        if self.stride != 1:
            return y
        return y + (self.BatchNorm_3(self.Conv_3(x), stats) if self.project else x)


class MobileNetV2(nn.Module):
    def __init__(self, num_classes: int = 10, image_size: Tuple[int, int, int] = (32, 32, 3)):
        super().__init__()
        self.Conv_0 = conv3x3(image_size[-1], 32)
        self.BatchNorm_0 = BatchNorm(32)
        self.blocks = []
        in_ch = 32
        for expansion, features, n, stride in _CFG:
            for i in range(n):
                self.blocks.append(f"InvertedResidual_{len(self.blocks)}")
                setattr(self, self.blocks[-1], InvertedResidual(in_ch, features, expansion, stride if i == 0 else 1))
                in_ch = features
        self.Conv_1 = conv1x1(in_ch, 1280)
        self.BatchNorm_1 = BatchNorm(1280)
        self.Dense_0 = nn.Linear(1280, num_classes)
        name_batch_norms(self)

    def forward(self, x: torch.Tensor, train: bool = False):
        """``x: [n, h, w, c]`` -> logits ``[n, num_classes]``, or
        ``(logits, new_stats)`` with ``train=True``."""
        stats: Optional[Stats] = {} if train else None
        x = F.relu(self.BatchNorm_0(self.Conv_0(x.permute(0, 3, 1, 2)), stats))
        for name in self.blocks:
            x = getattr(self, name)(x, stats)
        x = F.relu(self.BatchNorm_1(self.Conv_1(x), stats))
        logits = self.Dense_0(global_avg_pool(x))
        return (logits, stats) if train else logits


@register("mobilenetv2")
def make_mobilenetv2(num_classes: int = 10, image_size=(32, 32, 3)) -> MobileNetV2:
    return MobileNetV2(num_classes, image_size)
