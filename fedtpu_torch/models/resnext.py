"""ResNeXt-29 for CIFAR: the port of ``fedtpu.models.resnext``.

A 1x1/64 stem with BatchNorm, three stages of three ``ResNeXtBlock``\\ s
(``ResNeXtBlock_0..8``: 1x1 ``Conv_0``, 3x3 ``Conv_1`` in ``cardinality``
groups, 1x1 ``Conv_2`` to twice the group width; a projecting shortcut
``Conv_3``/``BatchNorm_3`` created last), the bottleneck width doubling
each stage, global average pool and a dense head:
``ResNeXt29_{2x64d,4x64d,8x64d,32x4d}``. Under the round's
``torch.func.vmap`` over clients, torch folds the clients into the group
count: 64 clients of ``ResNeXt29_2x64d`` run 128-group convolutions.
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
    global_avg_pool,
    name_batch_norms,
)
from fedtpu_torch.models.registry import register


class ResNeXtBlock(nn.Module):
    expansion = 2

    def __init__(self, in_ch: int, cardinality: int, bottleneck_width: int, stride: int = 1):
        super().__init__()
        group_width = cardinality * bottleneck_width
        self.out_ch = out_ch = self.expansion * group_width
        self.Conv_0 = conv1x1(in_ch, group_width)
        self.BatchNorm_0 = BatchNorm(group_width)
        self.Conv_1 = nn.Conv2d(
            group_width, group_width, 3, stride=stride, padding=1, groups=cardinality, bias=False
        )
        self.BatchNorm_1 = BatchNorm(group_width)
        self.Conv_2 = conv1x1(group_width, out_ch)
        self.BatchNorm_2 = BatchNorm(out_ch)
        self.project = stride != 1 or in_ch != out_ch
        if self.project:
            self.Conv_3 = conv1x1(in_ch, out_ch, stride)
            self.BatchNorm_3 = BatchNorm(out_ch)

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), stats))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), stats))
        y = self.BatchNorm_2(self.Conv_2(y), stats)
        shortcut = self.BatchNorm_3(self.Conv_3(x), stats) if self.project else x
        return F.relu(y + shortcut)


class ResNeXt(nn.Module):
    def __init__(
        self,
        num_blocks: Sequence[int],
        cardinality: int,
        bottleneck_width: int,
        num_classes: int = 10,
        image_size: Tuple[int, int, int] = (32, 32, 3),
    ):
        super().__init__()
        self.Conv_0 = conv1x1(image_size[-1], 64)
        self.BatchNorm_0 = BatchNorm(64)
        self.blocks = []
        in_ch, width = 64, bottleneck_width
        for stage, n in enumerate(num_blocks):
            for i in range(n):
                stride = (1 if stage == 0 else 2) if i == 0 else 1
                block = ResNeXtBlock(in_ch, cardinality, width, stride)
                self.blocks.append(f"ResNeXtBlock_{len(self.blocks)}")
                setattr(self, self.blocks[-1], block)
                in_ch = block.out_ch
            width *= 2  # the bottleneck width doubles after each stage
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


def ResNeXt29_2x64d(num_classes: int = 10, image_size=(32, 32, 3)) -> ResNeXt:
    return ResNeXt((3, 3, 3), 2, 64, num_classes, image_size)


def ResNeXt29_4x64d(num_classes: int = 10, image_size=(32, 32, 3)) -> ResNeXt:
    return ResNeXt((3, 3, 3), 4, 64, num_classes, image_size)


def ResNeXt29_8x64d(num_classes: int = 10, image_size=(32, 32, 3)) -> ResNeXt:
    return ResNeXt((3, 3, 3), 8, 64, num_classes, image_size)


def ResNeXt29_32x4d(num_classes: int = 10, image_size=(32, 32, 3)) -> ResNeXt:
    return ResNeXt((3, 3, 3), 32, 4, num_classes, image_size)


for _ctor in (ResNeXt29_2x64d, ResNeXt29_4x64d, ResNeXt29_8x64d, ResNeXt29_32x4d):
    register(_ctor.__name__)(_ctor)
