"""Dual Path Networks for CIFAR: the port of ``fedtpu.models.dpn``.

A 3x3/64 stem with BatchNorm, four stages of ``DualPathBlock``\\ s
numbered across the stages, global average pool and a dense head:
``DPN26`` and ``DPN92``. A block runs 1x1 ``Conv_0``, 3x3 ``Conv_1`` in 32
groups (the block's stride) and 1x1 ``Conv_2`` to ``d + dense_depth``
channels; the first block of a stage has a projecting shortcut
``Conv_3``/``BatchNorm_3`` to as many. Its output is ``relu(cat[s[:d] +
y[:d], s[d:], y[d:]])`` for the shortcut ``s``: the first ``d`` channels
a residual path, the rest a dense path that grows by ``dense_depth`` a
block, and by twice that at a stage's first block. flax infers each
block's input channels; this constructor counts them. Inputs are NHWC at
the public boundary; train and eval mode follow
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
)
from fedtpu_torch.models.registry import register


class DualPathBlock(nn.Module):
    def __init__(self, in_ch: int, in_planes: int, out_planes: int, dense_depth: int,
                 stride: int = 1, first_layer: bool = False):
        super().__init__()
        self.d = out_planes
        width = out_planes + dense_depth
        self.Conv_0 = conv1x1(in_ch, in_planes)
        self.BatchNorm_0 = BatchNorm(in_planes)
        self.Conv_1 = nn.Conv2d(in_planes, in_planes, 3, stride=stride, padding=1, groups=32, bias=False)
        self.BatchNorm_1 = BatchNorm(in_planes)
        self.Conv_2 = conv1x1(in_planes, width)
        self.BatchNorm_2 = BatchNorm(width)
        self.first_layer = first_layer
        if first_layer:
            self.Conv_3 = conv1x1(in_ch, width, stride)
            self.BatchNorm_3 = BatchNorm(width)
        # The shortcut's channels (the residual path and its dense part) and
        # this block's own dense part.
        self.out_ch = (width if first_layer else in_ch) + dense_depth

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None) -> torch.Tensor:
        d = self.d
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), stats))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), stats))
        y = self.BatchNorm_2(self.Conv_2(y), stats)
        shortcut = self.BatchNorm_3(self.Conv_3(x), stats) if self.first_layer else x
        return F.relu(torch.cat([shortcut[:, :d] + y[:, :d], shortcut[:, d:], y[:, d:]], dim=1))


class DPN(nn.Module):
    def __init__(
        self,
        in_planes: Sequence[int],
        out_planes: Sequence[int],
        num_blocks: Sequence[int],
        dense_depth: Sequence[int],
        num_classes: int = 10,
        image_size: Tuple[int, int, int] = (32, 32, 3),
    ):
        super().__init__()
        self.Conv_0 = conv3x3(image_size[-1], 64)
        self.BatchNorm_0 = BatchNorm(64)
        self.blocks = []
        in_ch = 64
        for stage in range(4):
            for i in range(num_blocks[stage]):
                block = DualPathBlock(
                    in_ch, in_planes[stage], out_planes[stage], dense_depth[stage],
                    stride=(1 if stage == 0 else 2) if i == 0 else 1, first_layer=i == 0,
                )
                self.blocks.append(f"DualPathBlock_{len(self.blocks)}")
                setattr(self, self.blocks[-1], block)
                in_ch = block.out_ch
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


@register("dpn26")
def DPN26(num_classes: int = 10, image_size=(32, 32, 3)) -> DPN:
    return DPN((96, 192, 384, 768), (256, 512, 1024, 2048), (2, 2, 2, 2), (16, 32, 24, 128),
               num_classes, image_size)


@register("dpn92")
def DPN92(num_classes: int = 10, image_size=(32, 32, 3)) -> DPN:
    return DPN((96, 192, 384, 768), (256, 512, 1024, 2048), (3, 4, 20, 3), (16, 32, 24, 128),
               num_classes, image_size)
