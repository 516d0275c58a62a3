"""PNASNet A/B for CIFAR: the port of ``fedtpu.models.pnasnet``.

A 3x3 stem of ``p`` channels with BatchNorm, three stages of six cells at
widths ``(p, 2p, 4p)`` with a stride-2 cell before the second and the
third (``CellA_0..19`` or ``CellB_0..19``, numbered across the stages),
global average pool and a dense head: ``PNASNetA`` (p = 44) and
``PNASNetB`` (p = 32).

- ``SepConv``: a ``k x k`` conv in as many groups as input channels, then
  BatchNorm. A stride-2 cell's has twice as many outputs as inputs (two a
  group); under the round's ``torch.func.vmap`` torch folds the clients
  into the group count.
- ``CellA``: ``relu(SepConv 7x7 + max pool)``, the 3x3 pool padded with
  -inf and, at stride 2, followed by a 1x1 conv and BatchNorm.
- ``CellB``: ``[relu(SepConv 7x7 + SepConv 3x3), relu(pool branch +
  SepConv 5x5)]`` concatenated, then a 1x1 conv and BatchNorm and ReLU;
  the pool branch's conv is created before the 5x5 (``SepConv_2``), as
  flax creates it.

Inputs are NHWC at the public boundary; train and eval mode follow
:mod:`fedtpu_torch.models.common`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from fedtpu_torch.models.common import (
    BatchNorm,
    Stats,
    conv1x1,
    conv3x3,
    global_avg_pool,
    max_pool,
    name_batch_norms,
)
from fedtpu_torch.models.registry import register


class SepConv(nn.Module):
    def __init__(self, in_ch: int, features: int, kernel_size: int, stride: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_ch, features, kernel_size, stride=stride,
                                padding=(kernel_size - 1) // 2, groups=in_ch, bias=False)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None) -> torch.Tensor:
        return self.BatchNorm_0(self.Conv_0(x), stats)


def _pool_branch(cell: nn.Module, x: torch.Tensor, stats: Optional[Stats]) -> torch.Tensor:
    """A cell's 3x3 max pool, padded with -inf; at stride 2 followed by the
    cell's ``Conv_0`` (1x1) and ``BatchNorm_0``."""
    y = max_pool(x, 3, cell.stride, padding=1)
    if cell.stride == 2:
        y = cell.BatchNorm_0(cell.Conv_0(y), stats)
    return y


class CellA(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.SepConv_0 = SepConv(in_ch, features, 7, stride)
        if stride == 2:
            self.Conv_0 = conv1x1(in_ch, features)
            self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None) -> torch.Tensor:
        return F.relu(self.SepConv_0(x, stats) + _pool_branch(self, x, stats))


class CellB(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.SepConv_0 = SepConv(in_ch, features, 7, stride)
        self.SepConv_1 = SepConv(in_ch, features, 3, stride)
        convs, norms = [], []
        if stride == 2:
            convs.append(conv1x1(in_ch, features))
            norms.append(BatchNorm(features))
        self.SepConv_2 = SepConv(in_ch, features, 5, stride)
        convs.append(conv1x1(2 * features, features))
        norms.append(BatchNorm(features))
        for i, (conv, norm) in enumerate(zip(convs, norms)):
            setattr(self, f"Conv_{i}", conv)
            setattr(self, f"BatchNorm_{i}", norm)
        self.last = len(convs) - 1

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None) -> torch.Tensor:
        y1 = self.SepConv_0(x, stats)
        y2 = self.SepConv_1(x, stats)
        y3 = _pool_branch(self, x, stats)
        y4 = self.SepConv_2(x, stats)
        b = torch.cat([F.relu(y1 + y2), F.relu(y3 + y4)], dim=1)
        conv, norm = getattr(self, f"Conv_{self.last}"), getattr(self, f"BatchNorm_{self.last}")
        return F.relu(norm(conv(b), stats))


class PNASNet(nn.Module):
    def __init__(
        self,
        cell: type,
        num_cells: int,
        num_planes: int,
        num_classes: int = 10,
        image_size: Tuple[int, int, int] = (32, 32, 3),
    ):
        super().__init__()
        p = num_planes
        self.Conv_0 = conv3x3(image_size[-1], p)
        self.BatchNorm_0 = BatchNorm(p)
        self.cells = []
        in_ch = p
        for width, downsample in ((p, False), (2 * p, True), (4 * p, True)):
            for stride in ([2] if downsample else []) + [1] * num_cells:
                self.cells.append(f"{cell.__name__}_{len(self.cells)}")
                setattr(self, self.cells[-1], cell(in_ch, width, stride))
                in_ch = width
        self.Dense_0 = nn.Linear(in_ch, num_classes)
        name_batch_norms(self)

    def forward(self, x: torch.Tensor, train: bool = False):
        """``x: [n, h, w, c]`` -> logits ``[n, num_classes]``, or
        ``(logits, new_stats)`` with ``train=True``."""
        stats: Optional[Stats] = {} if train else None
        x = F.relu(self.BatchNorm_0(self.Conv_0(x.permute(0, 3, 1, 2)), stats))
        for name in self.cells:
            x = getattr(self, name)(x, stats)
        logits = self.Dense_0(global_avg_pool(x))
        return (logits, stats) if train else logits


@register("pnasneta")
def PNASNetA(num_classes: int = 10, image_size=(32, 32, 3)) -> PNASNet:
    return PNASNet(CellA, 6, 44, num_classes, image_size)


@register("pnasnetb")
def PNASNetB(num_classes: int = 10, image_size=(32, 32, 3)) -> PNASNet:
    return PNASNet(CellB, 6, 32, num_classes, image_size)
