"""DLA for CIFAR: the port of ``fedtpu.models.dla``.

Deep layer aggregation: three 3x3 stems with BatchNorm (16, 16, 32
channels: ``Conv_0..2``, ``BatchNorm_0..2``), then trees of residual
``BasicBlock``\\ s at (64, level 1, stride 1), (128, 2, 2), (256, 2, 2),
(512, 1, 2) (``Tree_0..3``), global average pool and a dense head. A
``Root`` concatenates its inputs in list order, then a 1x1 conv,
BatchNorm and ReLU. A level-1 tree is two blocks (``BasicBlock_0`` at the
tree's stride, ``BasicBlock_1``) joined by a root; a deeper one feeds its
input to ``BasicBlock_0`` and to the lower trees (``Tree_*``, each at the
tree's stride on the previous one's output), then two blocks after them,
and joins all of them in one wide root. flax numbers each class's
submodules in the order it creates them, hence ``BasicBlock_0``,
``Tree_*``, ``BasicBlock_1``, ``BasicBlock_2``, ``Root_0``. At 10
classes: 16,291,386 params in 131 leaves, 17,792 statistics in 86.
:mod:`fedtpu_torch.models.dla_simple` reuses ``BasicBlock`` and ``Root``.
Inputs are NHWC at the public boundary; train and eval mode follow
:mod:`fedtpu_torch.models.common`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

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
)
from fedtpu_torch.models.registry import register

# The stems' widths, then the trees' (features, level, stride).
STEMS = (16, 16, 32)
TREES = ((64, 1, 1), (128, 2, 2), (256, 2, 2), (512, 1, 2))


class BasicBlock(nn.Module):
    """Two 3x3 convs with BatchNorm and a projecting shortcut (``Conv_2``,
    ``BatchNorm_2``, created last) on a change of stride or width."""

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = conv3x3(in_ch, features, stride)
        self.BatchNorm_0 = BatchNorm(features)
        self.Conv_1 = conv3x3(features, features)
        self.BatchNorm_1 = BatchNorm(features)
        self.project = stride != 1 or in_ch != features
        if self.project:
            self.Conv_2 = conv1x1(in_ch, features, stride)
            self.BatchNorm_2 = BatchNorm(features)

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), stats))
        y = self.BatchNorm_1(self.Conv_1(y), stats)
        shortcut = self.BatchNorm_2(self.Conv_2(x), stats) if self.project else x
        return F.relu(y + shortcut)


class Root(nn.Module):
    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.Conv_0 = conv1x1(in_ch, features)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, xs: List[torch.Tensor], stats: Optional[Stats] = None) -> torch.Tensor:
        return F.relu(self.BatchNorm_0(self.Conv_0(torch.cat(xs, dim=1)), stats))


class Tree(nn.Module):
    def __init__(self, in_ch: int, features: int, level: int = 1, stride: int = 1):
        super().__init__()
        self.level = level
        self.BasicBlock_0 = BasicBlock(in_ch, features, stride)
        self.trees = []
        for lvl in reversed(range(1, level)):
            self.trees.append(f"Tree_{len(self.trees)}")
            setattr(self, self.trees[-1], Tree(in_ch, features, lvl, stride))
            in_ch = features
        self.BasicBlock_1 = BasicBlock(features, features)
        if level > 1:
            self.BasicBlock_2 = BasicBlock(features, features)
        self.Root_0 = Root((level + 2 if level > 1 else 2) * features, features)

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None) -> torch.Tensor:
        if self.level == 1:
            x = self.BasicBlock_0(x, stats)
            xs = [x, self.BasicBlock_1(x, stats)]
            return self.Root_0(xs, stats)
        xs = [self.BasicBlock_0(x, stats)]
        for name in self.trees:
            x = getattr(self, name)(x, stats)
            xs.append(x)
        xs.append(self.BasicBlock_1(x, stats))
        xs.append(self.BasicBlock_2(xs[-1], stats))
        return self.Root_0(xs, stats)


def stems(model: nn.Module, in_ch: int) -> int:
    """Set DLA's three 3x3 stems with BatchNorm on ``model``; returns their
    output width."""
    for i, width in enumerate(STEMS):
        setattr(model, f"Conv_{i}", conv3x3(in_ch, width))
        setattr(model, f"BatchNorm_{i}", BatchNorm(width))
        in_ch = width
    return in_ch


def run_stems(model: nn.Module, x: torch.Tensor, stats: Optional[Stats]) -> torch.Tensor:
    """The stems on an NHWC input, -> NCHW."""
    x = x.permute(0, 3, 1, 2)
    for i in range(len(STEMS)):
        x = F.relu(getattr(model, f"BatchNorm_{i}")(getattr(model, f"Conv_{i}")(x), stats))
    return x


class DLA(nn.Module):
    def __init__(self, num_classes: int = 10, image_size: Tuple[int, int, int] = (32, 32, 3)):
        super().__init__()
        in_ch = stems(self, image_size[-1])
        for i, (features, level, stride) in enumerate(TREES):
            setattr(self, f"Tree_{i}", Tree(in_ch, features, level, stride))
            in_ch = features
        self.Dense_0 = nn.Linear(in_ch, num_classes)
        name_batch_norms(self)

    def forward(self, x: torch.Tensor, train: bool = False):
        """``x: [n, h, w, c]`` -> logits ``[n, num_classes]``, or
        ``(logits, new_stats)`` with ``train=True``."""
        stats: Optional[Stats] = {} if train else None
        x = run_stems(self, x, stats)
        for i in range(len(TREES)):
            x = getattr(self, f"Tree_{i}")(x, stats)
        logits = self.Dense_0(global_avg_pool(x))
        return (logits, stats) if train else logits


register("dla")(DLA)
