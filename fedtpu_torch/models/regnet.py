"""RegNetX/Y for CIFAR: the port of ``fedtpu.models.regnet``.

A 3x3/64 stem with BatchNorm, four stages of ``RegNetBlock``\\ s
(``RegNetBlock_0..``, numbered across the stages), global average pool and
a dense head. A block is a 1x1 conv (``Conv_0``), a 3x3 conv in ``w_b //
group_width`` groups (``Conv_1``), for RegNetY a squeeze-and-excitation
gate (two biased 1x1 convs over the spatial mean, ``round(in_ch * 0.25)``
wide from the block's input channels, ReLU then sigmoid), a 1x1 conv and
BatchNorm, and a projecting shortcut (1x1 conv and BatchNorm, created last)
where the stride or the width changes: ``RegNetX_200MF`` (group width
8), ``RegNetX_400MF`` and ``RegNetY_400MF`` (group width 16). Under the
round's ``torch.func.vmap`` torch folds the clients into the group count.
Inputs are NHWC at the public boundary; train and eval mode follow
:mod:`fedtpu_torch.models.common`.
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
    global_avg_pool,
    name_batch_norms,
    spatial_mean,
)
from fedtpu_torch.models.registry import register


class RegNetBlock(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int, group_width: int,
                 bottleneck_ratio: float = 1.0, se_ratio: float = 0.0):
        super().__init__()
        w_b = int(round(features * bottleneck_ratio))
        convs = [
            conv1x1(in_ch, w_b),
            nn.Conv2d(w_b, w_b, 3, stride=stride, padding=1, groups=w_b // group_width, bias=False),
        ]
        self.se = se_ratio > 0
        if self.se:
            w_se = int(round(in_ch * se_ratio))
            convs += [nn.Conv2d(w_b, w_se, 1), nn.Conv2d(w_se, w_b, 1)]
        convs.append(conv1x1(w_b, features))
        norms = [BatchNorm(w_b), BatchNorm(w_b), BatchNorm(features)]
        self.project = stride != 1 or in_ch != features
        if self.project:
            convs.append(conv1x1(in_ch, features, stride))
            norms.append(BatchNorm(features))
        for i, conv in enumerate(convs):
            setattr(self, f"Conv_{i}", conv)
        for i, norm in enumerate(norms):
            setattr(self, f"BatchNorm_{i}", norm)

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), stats))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), stats))
        c = 2
        if self.se:
            w = F.relu(self.Conv_2(spatial_mean(y)))
            y = y * torch.sigmoid(self.Conv_3(w))
            c = 4
        y = self.BatchNorm_2(getattr(self, f"Conv_{c}")(y), stats)
        shortcut = self.BatchNorm_3(getattr(self, f"Conv_{c + 1}")(x), stats) if self.project else x
        return F.relu(y + shortcut)


class RegNet(nn.Module):
    def __init__(
        self,
        depths: Sequence[int],
        widths: Sequence[int],
        strides: Sequence[int],
        group_width: int,
        bottleneck_ratio: float = 1.0,
        se_ratio: float = 0.0,
        num_classes: int = 10,
        image_size: Tuple[int, int, int] = (32, 32, 3),
    ):
        super().__init__()
        self.Conv_0 = conv3x3(image_size[-1], 64)
        self.BatchNorm_0 = BatchNorm(64)
        self.blocks = []
        in_ch = 64
        for depth, width, stride in zip(depths, widths, strides):
            for i in range(depth):
                block = RegNetBlock(in_ch, width, stride if i == 0 else 1, group_width,
                                    bottleneck_ratio, se_ratio)
                self.blocks.append(f"RegNetBlock_{len(self.blocks)}")
                setattr(self, self.blocks[-1], block)
                in_ch = width
        self.Dense_0 = nn.Linear(in_ch, num_classes)
        name_batch_norms(self)

    def forward(self, x: torch.Tensor, train: bool = False):
        """``x: [n, h, w, c]`` -> logits ``[n, num_classes]``, or
        ``(logits, new_stats)`` with ``train=True``."""
        stats: Optional[Stats] = {} if train else None
        x = F.relu(self.BatchNorm_0(self.Conv_0(x.permute(0, 3, 1, 2)), stats))
        for name in self.blocks:
            x = getattr(self, name)(x, stats)
        logits = self.Dense_0(global_avg_pool(x))
        return (logits, stats) if train else logits


@register("regnetx_200mf")
def RegNetX_200MF(num_classes: int = 10, image_size=(32, 32, 3)) -> RegNet:
    return RegNet((1, 1, 4, 7), (24, 56, 152, 368), (1, 1, 2, 2), 8,
                  num_classes=num_classes, image_size=image_size)


@register("regnetx_400mf")
def RegNetX_400MF(num_classes: int = 10, image_size=(32, 32, 3)) -> RegNet:
    return RegNet((1, 2, 7, 12), (32, 64, 160, 384), (1, 1, 2, 2), 16,
                  num_classes=num_classes, image_size=image_size)


@register("regnety_400mf")
def RegNetY_400MF(num_classes: int = 10, image_size=(32, 32, 3)) -> RegNet:
    return RegNet((1, 2, 7, 12), (32, 64, 160, 384), (1, 1, 2, 2), 16, se_ratio=0.25,
                  num_classes=num_classes, image_size=image_size)
