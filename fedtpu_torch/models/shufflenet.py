"""ShuffleNet (v1) for CIFAR: the port of ``fedtpu.models.shufflenet``.

A 1x1/24 stem, then three stages of 4, 8 and 4 ``ShuffleBottleneck``\\ s
numbered across the stages (``ShuffleBottleneck_0..15``), global average
pool and a dense head. A bottleneck runs a grouped 1x1 (``Conv_0``, with
``first_groups`` groups: 1 only for the first block of stage 1, which the
24-channel stem feeds), a channel shuffle over those groups, a 3x3
depthwise conv (``Conv_1``, the block's stride) and a grouped 1x1
(``Conv_2``); the first block of a stage strides 2 and concatenates ``[y,
avg_pool(x, 3, 2, pad 1)]`` (its conv path emits ``out - in`` channels),
the others add the identity. ``ShuffleNetG2`` (widths 200, 400, 800) and
``ShuffleNetG3`` (240, 480, 960). Inputs are NHWC at the public boundary;
train and eval mode follow :mod:`fedtpu_torch.models.common`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from fedtpu_torch.models.common import (
    BatchNorm,
    Stats,
    avg_pool,
    channel_shuffle,
    conv1x1,
    depthwise3x3,
    global_avg_pool,
    name_batch_norms,
)
from fedtpu_torch.models.registry import register


def grouped_conv1x1(in_ch: int, out_ch: int, groups: int) -> nn.Conv2d:
    return nn.Conv2d(in_ch, out_ch, 1, groups=groups, bias=False)


class ShuffleBottleneck(nn.Module):
    def __init__(self, in_ch: int, out_planes: int, stride: int, groups: int, first_groups: int):
        super().__init__()
        mid = out_planes // 4
        self.stride, self.first_groups = stride, first_groups
        self.Conv_0 = grouped_conv1x1(in_ch, mid, first_groups)
        self.BatchNorm_0 = BatchNorm(mid)
        self.Conv_1 = depthwise3x3(mid, stride)
        self.BatchNorm_1 = BatchNorm(mid)
        self.Conv_2 = grouped_conv1x1(mid, out_planes, groups)
        self.BatchNorm_2 = BatchNorm(out_planes)

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), stats))
        y = channel_shuffle(y, self.first_groups)
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), stats))
        y = self.BatchNorm_2(self.Conv_2(y), stats)
        if self.stride == 2:
            return F.relu(torch.cat([y, avg_pool(x, 3, 2, padding=1)], dim=1))
        return F.relu(y + x)


class ShuffleNetModule(nn.Module):
    def __init__(
        self,
        out_planes: Sequence[int],
        num_blocks: Sequence[int],
        groups: int,
        num_classes: int = 10,
        image_size: Tuple[int, int, int] = (32, 32, 3),
    ):
        super().__init__()
        self.Conv_0 = conv1x1(image_size[-1], 24)
        self.BatchNorm_0 = BatchNorm(24)
        self.blocks = []
        in_planes = 24
        for out, n in zip(out_planes, num_blocks):
            for i in range(n):
                cat_planes = in_planes if i == 0 else 0
                self.blocks.append(f"ShuffleBottleneck_{len(self.blocks)}")
                setattr(self, self.blocks[-1], ShuffleBottleneck(
                    in_planes, out - cat_planes, stride=2 if i == 0 else 1, groups=groups,
                    first_groups=1 if in_planes == 24 else groups,
                ))
                in_planes = out
        self.Dense_0 = nn.Linear(in_planes, num_classes)
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


@register("shufflenetg2")
def ShuffleNetG2(num_classes: int = 10, image_size=(32, 32, 3)) -> ShuffleNetModule:
    return ShuffleNetModule((200, 400, 800), (4, 8, 4), 2, num_classes, image_size)


@register("shufflenetg3")
def ShuffleNetG3(num_classes: int = 10, image_size=(32, 32, 3)) -> ShuffleNetModule:
    return ShuffleNetModule((240, 480, 960), (4, 8, 4), 3, num_classes, image_size)
