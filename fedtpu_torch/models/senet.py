"""SENet-18 for CIFAR: the port of ``fedtpu.models.senet``.

A 3x3/64 stem with BatchNorm, then the ResNet-18 stage plan of
pre-activation basic blocks (``SEPreActBlock_0..7``, named explicitly as
fedtpu names them), global average pool (no BatchNorm before it) and a
dense head. A block normalizes its input (``BatchNorm_0``), taps the
pre-activation for a projecting shortcut (``Conv_0``, so its 3x3s are
``Conv_1``/``Conv_2``; ``Conv_0``/``Conv_1`` in a block without one),
and gates its output with ``SEGate_0``: the spatial mean, two biased 1x1
convs (``Conv_0`` to a sixteenth of the channels, ReLU, ``Conv_1`` back,
sigmoid), the block's output times the gate. At 10 classes: 11,260,354
params in 88 leaves, 6,912 statistics in 34. ``remat=True`` recomputes
each block in the backward (fedtpu's ``nn.remat`` per block); the names
do not change. Inputs are NHWC at the public boundary; train and eval
mode follow :mod:`fedtpu_torch.models.common`.
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
    run_block,
    spatial_mean,
)
from fedtpu_torch.models.registry import register
from fedtpu_torch.models.resnet import stage_plan


class SEGate(nn.Module):
    """Squeeze and excitation: a per-channel sigmoid gate from the
    spatial mean (``common.spatial_mean``)."""

    def __init__(self, ch: int, reduction: int = 16):
        super().__init__()
        self.Conv_0 = nn.Conv2d(ch, ch // reduction, 1)
        self.Conv_1 = nn.Conv2d(ch // reduction, ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = F.relu(self.Conv_0(spatial_mean(x)))
        return x * torch.sigmoid(self.Conv_1(w))


class SEPreActBlock(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.project = stride != 1 or in_ch != features
        convs = [conv3x3(in_ch, features, stride), conv3x3(features, features)]
        if self.project:
            convs.insert(0, conv1x1(in_ch, features, stride))
        for i, conv in enumerate(convs):
            setattr(self, f"Conv_{i}", conv)
        self.BatchNorm_0 = BatchNorm(in_ch)
        self.BatchNorm_1 = BatchNorm(features)
        self.SEGate_0 = SEGate(features)

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None) -> torch.Tensor:
        pre = F.relu(self.BatchNorm_0(x, stats))
        first = int(self.project)
        shortcut = self.Conv_0(pre) if self.project else x
        y = F.relu(self.BatchNorm_1(getattr(self, f"Conv_{first}")(pre), stats))
        y = getattr(self, f"Conv_{first + 1}")(y)
        return self.SEGate_0(y) + shortcut


class SENet(nn.Module):
    def __init__(
        self,
        num_blocks: Sequence[int] = (2, 2, 2, 2),
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
            self.blocks.append(f"SEPreActBlock_{count}")
            setattr(self, self.blocks[-1], SEPreActBlock(in_ch, features, stride))
            in_ch = features
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


@register("senet18")
def SENet18(num_classes: int = 10, remat: bool = False, image_size=(32, 32, 3)) -> SENet:
    return SENet((2, 2, 2, 2), num_classes, image_size, remat)
