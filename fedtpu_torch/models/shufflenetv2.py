"""ShuffleNetV2 for CIFAR: the port of ``fedtpu.models.shufflenetv2``.

A 3x3/24 stem, then three stages, each a ``DownBlock`` and 3, 7 and 3
``SplitBlock``\\ s, a 1x1 head conv, global average pool and a dense head;
widths from ``_CONFIGS`` by ``net_size`` (0.5, 1, 1.5, 2). A split block
keeps the first half of its channels, runs the second through 1x1,
depthwise 3x3 (no ReLU after its BatchNorm) and 1x1, concatenates
``[kept, transformed]`` and shuffles with 2 groups; a down block runs the
whole input through two stride-2 branches, left (depthwise ``Conv_0``,
``Conv_1``) and right (``Conv_2``, depthwise ``Conv_3``, ``Conv_4``), and
concatenates them. Submodules carry flax's auto-names: ``DownBlock_0..2``
and ``SplitBlock_0..12`` numbered across the stages, the head
``Conv_1``/``BatchNorm_1``. At ``net_size=1`` and 10 classes: 1,263,854
params in 170 leaves, 16,180 statistics in 112. Inputs are NHWC at the
public boundary; train and eval mode follow
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
    channel_shuffle,
    conv1x1,
    conv3x3,
    depthwise3x3,
    global_avg_pool,
    name_batch_norms,
)
from fedtpu_torch.models.registry import register

_CONFIGS = {
    0.5: {"out_channels": (48, 96, 192, 1024), "num_blocks": (3, 7, 3)},
    1: {"out_channels": (116, 232, 464, 1024), "num_blocks": (3, 7, 3)},
    1.5: {"out_channels": (176, 352, 704, 1024), "num_blocks": (3, 7, 3)},
    2: {"out_channels": (224, 488, 976, 2048), "num_blocks": (3, 7, 3)},
}


class SplitBlock(nn.Module):
    def __init__(self, in_ch: int, split_ratio: float = 0.5):
        super().__init__()
        self.c = int(in_ch * split_ratio)
        c = self.c
        self.Conv_0 = conv1x1(in_ch - c, c)
        self.BatchNorm_0 = BatchNorm(c)
        self.Conv_1 = depthwise3x3(c, 1)
        self.BatchNorm_1 = BatchNorm(c)
        self.Conv_2 = conv1x1(c, c)
        self.BatchNorm_2 = BatchNorm(c)

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None) -> torch.Tensor:
        x1, x2 = x[:, : self.c], x[:, self.c :]
        y = F.relu(self.BatchNorm_0(self.Conv_0(x2), stats))
        y = self.BatchNorm_1(self.Conv_1(y), stats)
        y = F.relu(self.BatchNorm_2(self.Conv_2(y), stats))
        return channel_shuffle(torch.cat([x1, y], dim=1), 2)


class DownBlock(nn.Module):
    def __init__(self, in_ch: int, features: int):
        super().__init__()
        mid = features // 2
        self.Conv_0 = depthwise3x3(in_ch, 2)
        self.BatchNorm_0 = BatchNorm(in_ch)
        self.Conv_1 = conv1x1(in_ch, mid)
        self.BatchNorm_1 = BatchNorm(mid)
        self.Conv_2 = conv1x1(in_ch, mid)
        self.BatchNorm_2 = BatchNorm(mid)
        self.Conv_3 = depthwise3x3(mid, 2)
        self.BatchNorm_3 = BatchNorm(mid)
        self.Conv_4 = conv1x1(mid, mid)
        self.BatchNorm_4 = BatchNorm(mid)

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None) -> torch.Tensor:
        left = self.BatchNorm_0(self.Conv_0(x), stats)
        left = F.relu(self.BatchNorm_1(self.Conv_1(left), stats))
        right = F.relu(self.BatchNorm_2(self.Conv_2(x), stats))
        right = self.BatchNorm_3(self.Conv_3(right), stats)
        right = F.relu(self.BatchNorm_4(self.Conv_4(right), stats))
        return channel_shuffle(torch.cat([left, right], dim=1), 2)


class ShuffleNetV2Module(nn.Module):
    def __init__(
        self,
        out_channels: Sequence[int],
        num_blocks: Sequence[int],
        num_classes: int = 10,
        image_size: Tuple[int, int, int] = (32, 32, 3),
    ):
        super().__init__()
        self.Conv_0 = conv3x3(image_size[-1], 24)
        self.BatchNorm_0 = BatchNorm(24)
        self.blocks = []
        in_ch, split = 24, 0
        for stage, (out, n) in enumerate(zip(out_channels[:3], num_blocks)):
            self.blocks.append(f"DownBlock_{stage}")
            setattr(self, self.blocks[-1], DownBlock(in_ch, out))
            in_ch = 2 * (out // 2)
            for _ in range(n):
                self.blocks.append(f"SplitBlock_{split}")
                setattr(self, self.blocks[-1], SplitBlock(in_ch))
                in_ch, split = 2 * int(in_ch * 0.5), split + 1
        self.Conv_1 = conv1x1(in_ch, out_channels[3])
        self.BatchNorm_1 = BatchNorm(out_channels[3])
        self.Dense_0 = nn.Linear(out_channels[3], num_classes)
        name_batch_norms(self)

    def forward(self, x: torch.Tensor, train: bool = False):
        """``x: [n, h, w, c]`` -> logits ``[n, num_classes]``, or
        ``(logits, new_stats)`` with ``train=True``."""
        stats: Optional[Stats] = {} if train else None
        x = F.relu(self.BatchNorm_0(self.Conv_0(x.permute(0, 3, 1, 2)), stats))
        for name in self.blocks:
            x = getattr(self, name)(x, stats)
        x = F.relu(self.BatchNorm_1(self.Conv_1(x), stats))
        logits = self.Dense_0(global_avg_pool(x))
        return (logits, stats) if train else logits


@register("shufflenetv2")
def ShuffleNetV2(net_size: float = 1, num_classes: int = 10, image_size=(32, 32, 3)) -> ShuffleNetV2Module:
    cfg = _CONFIGS[net_size]
    return ShuffleNetV2Module(cfg["out_channels"], cfg["num_blocks"], num_classes, image_size)
