"""GoogLeNet (Inception) for CIFAR: the port of ``fedtpu.models.googlenet``.

A 3x3/192 stem, nine ``Inception`` modules (``Inception_0..8``) with a
3x3 stride-2 max pool (padding 1) after the second and the seventh,
global average pool and a dense head. Every conv is biased (flax's
default) and followed by BatchNorm and ReLU. fedtpu builds them with a
function, so an Inception's convs are ``Conv_0..6`` in branch order: the
1x1 branch (``Conv_0``), 1x1 then 3x3 (``Conv_1``, ``Conv_2``), 1x1 then
two 3x3s (``Conv_3``..``Conv_5``), and a 3x3 stride-1 max pool (padding
1) then 1x1 (``Conv_6``); the four branches are concatenated in that
order. At 10 classes: 6,166,250 params in 258 leaves, 15,808 statistics
in 128. Inputs are NHWC at the public boundary; train and eval mode
follow :mod:`fedtpu_torch.models.common`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from fedtpu_torch.models.common import (
    BatchNorm,
    Stats,
    global_avg_pool,
    max_pool,
    name_batch_norms,
)
from fedtpu_torch.models.registry import register

# (n1x1, n3x3red, n3x3, n5x5red, n5x5, pool_planes) per module; None = max pool.
_PLAN: Sequence = (
    (64, 96, 128, 16, 32, 32),      # a3 (in 192)
    (128, 128, 192, 32, 96, 64),    # b3 (in 256)
    None,
    (192, 96, 208, 16, 48, 64),     # a4 (in 480)
    (160, 112, 224, 24, 64, 64),    # b4
    (128, 128, 256, 24, 64, 64),    # c4
    (112, 144, 288, 32, 64, 64),    # d4
    (256, 160, 320, 32, 128, 128),  # e4
    None,
    (256, 160, 320, 32, 128, 128),  # a5
    (384, 192, 384, 48, 128, 128),  # b5 (out 1024)
)


class Inception(nn.Module):
    def __init__(self, in_ch: int, n1x1: int, n3x3red: int, n3x3: int, n5x5red: int, n5x5: int,
                 pool_planes: int):
        super().__init__()
        # (in, out, kernel) of Conv_0..6, in the order fedtpu creates them.
        specs = (
            (in_ch, n1x1, 1),
            (in_ch, n3x3red, 1), (n3x3red, n3x3, 3),
            (in_ch, n5x5red, 1), (n5x5red, n5x5, 3), (n5x5, n5x5, 3),
            (in_ch, pool_planes, 1),
        )
        for i, (cin, cout, k) in enumerate(specs):
            setattr(self, f"Conv_{i}", nn.Conv2d(cin, cout, k, padding=(k - 1) // 2))
            setattr(self, f"BatchNorm_{i}", BatchNorm(cout))
        self.out_ch = n1x1 + n3x3 + n5x5 + pool_planes

    def _conv_bn_relu(self, i: int, x: torch.Tensor, stats: Optional[Stats]) -> torch.Tensor:
        return F.relu(getattr(self, f"BatchNorm_{i}")(getattr(self, f"Conv_{i}")(x), stats))

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None) -> torch.Tensor:
        b1 = self._conv_bn_relu(0, x, stats)
        b2 = self._conv_bn_relu(2, self._conv_bn_relu(1, x, stats), stats)
        b3 = self._conv_bn_relu(3, x, stats)
        b3 = self._conv_bn_relu(5, self._conv_bn_relu(4, b3, stats), stats)
        b4 = self._conv_bn_relu(6, max_pool(x, 3, 1, padding=1), stats)
        return torch.cat([b1, b2, b3, b4], dim=1)


class GoogLeNet(nn.Module):
    def __init__(self, num_classes: int = 10, image_size: Tuple[int, int, int] = (32, 32, 3)):
        super().__init__()
        self.Conv_0 = nn.Conv2d(image_size[-1], 192, 3, padding=1)
        self.BatchNorm_0 = BatchNorm(192)
        in_ch, count = 192, 0
        for spec in _PLAN:
            if spec is not None:
                setattr(self, f"Inception_{count}", Inception(in_ch, *spec))
                in_ch, count = getattr(self, f"Inception_{count}").out_ch, count + 1
        self.Dense_0 = nn.Linear(in_ch, num_classes)
        name_batch_norms(self)

    def forward(self, x: torch.Tensor, train: bool = False):
        """``x: [n, h, w, c]`` -> logits ``[n, num_classes]``, or
        ``(logits, new_stats)`` with ``train=True``."""
        stats: Optional[Stats] = {} if train else None
        x = F.relu(self.BatchNorm_0(self.Conv_0(x.permute(0, 3, 1, 2)), stats))
        count = 0
        for spec in _PLAN:
            if spec is None:
                x = max_pool(x, 3, 2, padding=1)
            else:
                x = getattr(self, f"Inception_{count}")(x, stats)
                count += 1
        logits = self.Dense_0(global_avg_pool(x))
        return (logits, stats) if train else logits


@register("googlenet")
def make_googlenet(num_classes: int = 10, image_size=(32, 32, 3)) -> GoogLeNet:
    return GoogLeNet(num_classes, image_size)
