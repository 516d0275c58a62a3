"""Pre-activation ResNet family: the port of ``fedtpu.models.preact_resnet``.

BatchNorm, ReLU, then conv (He et al., identity mappings); a projecting
shortcut taps the pre-activated input. The stage plan of
:mod:`fedtpu_torch.models.resnet`, a 3x3/64 stem with no BatchNorm, no
BatchNorm before the pool: ``PreActResNet18`` ... ``PreActResNet152``.
Submodules carry flax's auto-names in the order flax creates them: in a
block, ``BatchNorm_0`` on the input, then the shortcut conv where there is
one, then the main convs, so a downsampling block's shortcut is ``Conv_0``
and its convs ``Conv_1``, ``Conv_2`` (``Conv_0``, ``Conv_1`` in a block
without one). ``remat=True`` as in ResNet.
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
from fedtpu_torch.models.resnet import stage_plan


class PreActBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        out_ch = features * self.expansion
        self.project = stride != 1 or in_ch != out_ch
        convs = [conv3x3(in_ch, features, stride), conv3x3(features, features)]
        if self.project:
            convs.insert(0, conv1x1(in_ch, out_ch, stride))
        for i, conv in enumerate(convs):
            setattr(self, f"Conv_{i}", conv)
        self.BatchNorm_0 = BatchNorm(in_ch)
        self.BatchNorm_1 = BatchNorm(features)

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None) -> torch.Tensor:
        pre = F.relu(self.BatchNorm_0(x, stats))
        first = int(self.project)
        shortcut = self.Conv_0(pre) if self.project else x
        y = getattr(self, f"Conv_{first}")(pre)
        y = F.relu(self.BatchNorm_1(y, stats))
        return getattr(self, f"Conv_{first + 1}")(y) + shortcut


class PreActBottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        out_ch = features * self.expansion
        self.project = stride != 1 or in_ch != out_ch
        convs = [conv1x1(in_ch, features), conv3x3(features, features, stride), conv1x1(features, out_ch)]
        if self.project:
            convs.insert(0, conv1x1(in_ch, out_ch, stride))
        for i, conv in enumerate(convs):
            setattr(self, f"Conv_{i}", conv)
        self.BatchNorm_0 = BatchNorm(in_ch)
        self.BatchNorm_1 = BatchNorm(features)
        self.BatchNorm_2 = BatchNorm(features)

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None) -> torch.Tensor:
        pre = F.relu(self.BatchNorm_0(x, stats))
        first = int(self.project)
        shortcut = self.Conv_0(pre) if self.project else x
        y = F.relu(self.BatchNorm_1(getattr(self, f"Conv_{first}")(pre), stats))
        y = F.relu(self.BatchNorm_2(getattr(self, f"Conv_{first + 1}")(y), stats))
        return getattr(self, f"Conv_{first + 2}")(y) + shortcut


class PreActResNet(nn.Module):
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
        x = self.Conv_0(x.permute(0, 3, 1, 2))
        for name in self.blocks:
            x = run_block(getattr(self, name), x, stats, self.remat)
        logits = self.Dense_0(global_avg_pool(x))
        return (logits, stats) if train else logits


def PreActResNet18(num_classes: int = 10, remat: bool = False, image_size=(32, 32, 3)) -> PreActResNet:
    return PreActResNet(PreActBlock, (2, 2, 2, 2), num_classes, image_size, remat)


def PreActResNet34(num_classes: int = 10, remat: bool = False, image_size=(32, 32, 3)) -> PreActResNet:
    return PreActResNet(PreActBlock, (3, 4, 6, 3), num_classes, image_size, remat)


def PreActResNet50(num_classes: int = 10, remat: bool = False, image_size=(32, 32, 3)) -> PreActResNet:
    return PreActResNet(PreActBottleneck, (3, 4, 6, 3), num_classes, image_size, remat)


def PreActResNet101(num_classes: int = 10, remat: bool = False, image_size=(32, 32, 3)) -> PreActResNet:
    return PreActResNet(PreActBottleneck, (3, 4, 23, 3), num_classes, image_size, remat)


def PreActResNet152(num_classes: int = 10, remat: bool = False, image_size=(32, 32, 3)) -> PreActResNet:
    return PreActResNet(PreActBottleneck, (3, 8, 36, 3), num_classes, image_size, remat)


for _ctor in (PreActResNet18, PreActResNet34, PreActResNet50, PreActResNet101, PreActResNet152):
    register(_ctor.__name__)(_ctor)
