"""CIFAR ResNet family: the port of ``fedtpu.models.resnet``.

``BasicBlock`` (two 3x3 convs, expansion 1) and ``Bottleneck`` (1x1, 3x3,
1x1, expansion 4) stages over widths (64, 128, 256, 512) with strides (1,
2, 2, 2), a 3x3/64 stem with BatchNorm, global average pool and a dense
head: ``ResNet18`` ... ``ResNet152``. Submodules carry flax's auto-names:
``Conv_0``, ``BatchNorm_0``, the blocks ``BasicBlock_{count}`` (or
``Bottleneck_{count}``) numbered across the stages, ``Dense_0``; inside a
block the convs and BatchNorms in the order flax creates them, the
projection shortcut last (``Conv_2``/``BatchNorm_2`` in a BasicBlock,
``Conv_3``/``BatchNorm_3`` in a Bottleneck). ResNet-18 at 100 classes has
11,220,132 params in 62 leaves and 9,600 statistics in 40. Inputs are NHWC
at the public boundary; train and eval mode follow
:mod:`fedtpu_torch.models.common`. With ``remat=True`` each block's
train-mode forward keeps only its input and recomputes itself in the
backward (fedtpu's ``nn.remat`` per block); the names do not change.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Type

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
    run_block,
)
from fedtpu_torch.models.registry import register

WIDTHS = (64, 128, 256, 512)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        out_ch = features * self.expansion
        self.Conv_0 = conv3x3(in_ch, features, stride)
        self.BatchNorm_0 = BatchNorm(features)
        self.Conv_1 = conv3x3(features, features)
        self.BatchNorm_1 = BatchNorm(features)
        self.project = stride != 1 or in_ch != out_ch
        if self.project:
            self.Conv_2 = conv1x1(in_ch, out_ch, stride)
            self.BatchNorm_2 = BatchNorm(out_ch)

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), stats))
        y = self.BatchNorm_1(self.Conv_1(y), stats)
        residual = self.BatchNorm_2(self.Conv_2(x), stats) if self.project else x
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        out_ch = features * self.expansion
        self.Conv_0 = conv1x1(in_ch, features)
        self.BatchNorm_0 = BatchNorm(features)
        self.Conv_1 = conv3x3(features, features, stride)
        self.BatchNorm_1 = BatchNorm(features)
        self.Conv_2 = conv1x1(features, out_ch)
        self.BatchNorm_2 = BatchNorm(out_ch)
        self.project = stride != 1 or in_ch != out_ch
        if self.project:
            self.Conv_3 = conv1x1(in_ch, out_ch, stride)
            self.BatchNorm_3 = BatchNorm(out_ch)

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), stats))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), stats))
        y = self.BatchNorm_2(self.Conv_2(y), stats)
        residual = self.BatchNorm_3(self.Conv_3(x), stats) if self.project else x
        return F.relu(y + residual)


def stage_plan(num_blocks: Sequence[int]):
    """``(count, features, stride)`` of every block, in order: the first
    block of stages 2-4 halves the map."""
    count = 0
    for stage, (features, n) in enumerate(zip(WIDTHS, num_blocks)):
        for i in range(n):
            yield count, features, (1 if stage == 0 else 2) if i == 0 else 1
            count += 1


class ResNet(nn.Module):
    def __init__(
        self,
        block: Type[nn.Module],
        num_blocks: Sequence[int],
        num_classes: int = 10,
        image_size: Tuple[int, int, int] = (32, 32, 3),
        remat: bool = False,
    ):
        super().__init__()
        self.remat = remat
        self.Conv_0 = conv3x3(image_size[-1], 64)
        self.BatchNorm_0 = BatchNorm(64)
        self.blocks = []
        in_ch = 64
        for count, features, stride in stage_plan(num_blocks):
            name = f"{block.__name__}_{count}"
            setattr(self, name, block(in_ch, features, stride))
            self.blocks.append(name)
            in_ch = features * block.expansion
        self.Dense_0 = nn.Linear(in_ch, num_classes)
        name_batch_norms(self)

    def forward(self, x: torch.Tensor, train: bool = False):
        """``x: [n, h, w, c]`` -> logits ``[n, num_classes]``, or
        ``(logits, new_stats)`` with ``train=True``."""
        stats: Optional[Stats] = {} if train else None
        x = F.relu(self.BatchNorm_0(self.Conv_0(x.permute(0, 3, 1, 2)), stats))
        for name in self.blocks:
            x = run_block(getattr(self, name), x, stats, self.remat)
        logits = self.Dense_0(global_avg_pool(x))
        return (logits, stats) if train else logits


def ResNet18(num_classes: int = 10, remat: bool = False, image_size=(32, 32, 3)) -> ResNet:
    return ResNet(BasicBlock, (2, 2, 2, 2), num_classes, image_size, remat)


def ResNet34(num_classes: int = 10, remat: bool = False, image_size=(32, 32, 3)) -> ResNet:
    return ResNet(BasicBlock, (3, 4, 6, 3), num_classes, image_size, remat)


def ResNet50(num_classes: int = 10, remat: bool = False, image_size=(32, 32, 3)) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 6, 3), num_classes, image_size, remat)


def ResNet101(num_classes: int = 10, remat: bool = False, image_size=(32, 32, 3)) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 23, 3), num_classes, image_size, remat)


def ResNet152(num_classes: int = 10, remat: bool = False, image_size=(32, 32, 3)) -> ResNet:
    return ResNet(Bottleneck, (3, 8, 36, 3), num_classes, image_size, remat)


for _ctor in (ResNet18, ResNet34, ResNet50, ResNet101, ResNet152):
    register(_ctor.__name__)(_ctor)
