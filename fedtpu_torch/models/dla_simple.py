"""Simplified DLA for CIFAR: the port of ``fedtpu.models.dla_simple``.

Binary aggregation trees on DLA's stems and stage plan
(:mod:`fedtpu_torch.models.dla`, whose ``BasicBlock`` and ``Root`` it
reuses): a level-1 ``SimpleTree`` is ``BasicBlock_0`` at the tree's stride
and ``BasicBlock_1`` on its output; a deeper one is ``SimpleTree_0`` (one
level down, at the tree's stride) and ``SimpleTree_1`` (one level down,
stride 1) on its output; either joins its two halves in a two-input
``Root_0``. At 10 classes: 15,142,970 params in 119 leaves, 16,256
statistics in 78. Inputs are NHWC at the public boundary; train and eval
mode follow :mod:`fedtpu_torch.models.common`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from fedtpu_torch.models.common import Stats, global_avg_pool, name_batch_norms
from fedtpu_torch.models.dla import TREES, BasicBlock, Root, run_stems, stems
from fedtpu_torch.models.registry import register


class SimpleTree(nn.Module):
    def __init__(self, in_ch: int, features: int, level: int = 1, stride: int = 1):
        super().__init__()
        self.level = level
        if level == 1:
            self.BasicBlock_0 = BasicBlock(in_ch, features, stride)
            self.BasicBlock_1 = BasicBlock(features, features)
        else:
            self.SimpleTree_0 = SimpleTree(in_ch, features, level - 1, stride)
            self.SimpleTree_1 = SimpleTree(features, features, level - 1, 1)
        self.Root_0 = Root(2 * features, features)

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None) -> torch.Tensor:
        halves = (self.BasicBlock_0, self.BasicBlock_1) if self.level == 1 else (self.SimpleTree_0, self.SimpleTree_1)
        left = halves[0](x, stats)
        return self.Root_0([left, halves[1](left, stats)], stats)


class SimpleDLA(nn.Module):
    def __init__(self, num_classes: int = 10, image_size: Tuple[int, int, int] = (32, 32, 3)):
        super().__init__()
        in_ch = stems(self, image_size[-1])
        for i, (features, level, stride) in enumerate(TREES):
            setattr(self, f"SimpleTree_{i}", SimpleTree(in_ch, features, level, stride))
            in_ch = features
        self.Dense_0 = nn.Linear(in_ch, num_classes)
        name_batch_norms(self)

    def forward(self, x: torch.Tensor, train: bool = False):
        """``x: [n, h, w, c]`` -> logits ``[n, num_classes]``, or
        ``(logits, new_stats)`` with ``train=True``."""
        stats: Optional[Stats] = {} if train else None
        x = run_stems(self, x, stats)
        for i in range(len(TREES)):
            x = getattr(self, f"SimpleTree_{i}")(x, stats)
        logits = self.Dense_0(global_avg_pool(x))
        return (logits, stats) if train else logits


register("simpledla")(SimpleDLA)
