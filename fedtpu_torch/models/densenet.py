"""DenseNet family for CIFAR: the port of ``fedtpu.models.densenet``.

Dense bottleneck layers (BatchNorm, ReLU, 1x1 conv to 4k, BatchNorm, ReLU,
3x3 conv to k) whose output is concatenated before their input along the
channels, and transitions (BatchNorm, ReLU, 1x1 conv halving the channels,
2x2 average pool) between the four dense stages; a final BatchNorm and
ReLU before the pool: ``DenseNet121``, ``DenseNet161``, ``DenseNet169``,
``DenseNet201`` and ``densenet_cifar``. Submodules carry flax's
auto-names: ``Conv_0`` (the stem), ``DenseLayer_i`` numbered across the
stages, ``Transition_0..2``, ``BatchNorm_0`` (the final one), ``Dense_0``.
``densenet_cifar`` has 1,000,618 params in 362 leaves at 10 classes and
31,320 statistics in 240. fedtpu's DenseNet has no remat.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from fedtpu_torch.models.common import (
    BatchNorm,
    Stats,
    avg_pool,
    conv1x1,
    conv3x3,
    global_avg_pool,
    name_batch_norms,
)
from fedtpu_torch.models.registry import register


class DenseLayer(nn.Module):
    def __init__(self, in_ch: int, growth_rate: int):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(in_ch)
        self.Conv_0 = conv1x1(in_ch, 4 * growth_rate)
        self.BatchNorm_1 = BatchNorm(4 * growth_rate)
        self.Conv_1 = conv3x3(4 * growth_rate, growth_rate)

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None) -> torch.Tensor:
        y = self.Conv_0(F.relu(self.BatchNorm_0(x, stats)))
        y = self.Conv_1(F.relu(self.BatchNorm_1(y, stats)))
        return torch.cat([y, x], dim=1)


class Transition(nn.Module):
    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(in_ch)
        self.Conv_0 = conv1x1(in_ch, features)

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None) -> torch.Tensor:
        return avg_pool(self.Conv_0(F.relu(self.BatchNorm_0(x, stats))), 2)


class DenseNet(nn.Module):
    def __init__(
        self,
        num_blocks: Sequence[int],
        growth_rate: int = 12,
        reduction: float = 0.5,
        num_classes: int = 10,
        image_size: Tuple[int, int, int] = (32, 32, 3),
    ):
        super().__init__()
        k = growth_rate
        planes = 2 * k
        self.Conv_0 = conv3x3(image_size[-1], planes)
        self.layers = []  # submodule names in forward order
        count = 0
        for stage, n in enumerate(num_blocks):
            for _ in range(n):
                setattr(self, f"DenseLayer_{count}", DenseLayer(planes, k))
                self.layers.append(f"DenseLayer_{count}")
                planes, count = planes + k, count + 1
            if stage < len(num_blocks) - 1:
                out = int(math.floor(planes * reduction))
                setattr(self, f"Transition_{stage}", Transition(planes, out))
                self.layers.append(f"Transition_{stage}")
                planes = out
        self.BatchNorm_0 = BatchNorm(planes)
        self.Dense_0 = nn.Linear(planes, num_classes)
        name_batch_norms(self)

    def forward(self, x: torch.Tensor, train: bool = False):
        """``x: [n, h, w, c]`` -> logits ``[n, num_classes]``, or
        ``(logits, new_stats)`` with ``train=True``."""
        stats: Optional[Stats] = {} if train else None
        x = self.Conv_0(x.permute(0, 3, 1, 2))
        for name in self.layers:
            x = getattr(self, name)(x, stats)
        x = F.relu(self.BatchNorm_0(x, stats))
        logits = self.Dense_0(global_avg_pool(x))
        return (logits, stats) if train else logits


def DenseNet121(num_classes: int = 10, image_size=(32, 32, 3)) -> DenseNet:
    return DenseNet((6, 12, 24, 16), growth_rate=32, num_classes=num_classes, image_size=image_size)


def DenseNet169(num_classes: int = 10, image_size=(32, 32, 3)) -> DenseNet:
    return DenseNet((6, 12, 32, 32), growth_rate=32, num_classes=num_classes, image_size=image_size)


def DenseNet201(num_classes: int = 10, image_size=(32, 32, 3)) -> DenseNet:
    return DenseNet((6, 12, 48, 32), growth_rate=32, num_classes=num_classes, image_size=image_size)


def DenseNet161(num_classes: int = 10, image_size=(32, 32, 3)) -> DenseNet:
    return DenseNet((6, 12, 36, 24), growth_rate=48, num_classes=num_classes, image_size=image_size)


def densenet_cifar(num_classes: int = 10, image_size=(32, 32, 3)) -> DenseNet:
    return DenseNet((6, 12, 24, 16), growth_rate=12, num_classes=num_classes, image_size=image_size)


for _ctor in (DenseNet121, DenseNet169, DenseNet201, DenseNet161, densenet_cifar):
    register(_ctor.__name__)(_ctor)
