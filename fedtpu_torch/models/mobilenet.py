"""MobileNet (v1) for CIFAR: the port of ``fedtpu.models.mobilenet``.

A 3x3/32 stem, then 13 depthwise-separable blocks (3x3 depthwise conv + BN
+ ReLU, 1x1 pointwise conv + BN + ReLU) with fedtpu's ``_CFG`` widths and
strides, global average pool and a dense head: P = 3,217,226 at 10
classes, in 83 parameter leaves. Submodules carry flax's auto-names
(``Conv_0``, ``BatchNorm_0``, ``DepthwiseSeparable_{0..12}.{Conv_0,
BatchNorm_0, Conv_1, BatchNorm_1}``, ``Dense_0``), so a leaf's torch name
is its flax path joined by dots. The depthwise conv is ``groups=in_ch``:
flax's ``[3, 3, 1, C]`` kernel is torch's ``[C, 1, 3, 3]`` through the
same HWIO -> OIHW permutation as every conv (:mod:`fedtpu_torch.convert`).
Inputs are NHWC at the public boundary. Train and eval mode follow
:mod:`fedtpu_torch.models.common`. With ``remat=True`` (fedtpu's
``RoundConfig.remat``) each block's train-mode forward keeps only its
input and recomputes itself in the backward
(:func:`fedtpu_torch.models.common.recompute_block`); the parameter names
do not change.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn
import torch.nn.functional as F

from fedtpu_torch.models.common import (
    BatchNorm,
    Stats,
    global_avg_pool,
    name_batch_norms,
    run_block,
)
from fedtpu_torch.models.registry import register

_CFG: Sequence[Union[int, Tuple[int, int]]] = (
    64,
    (128, 2),
    128,
    (256, 2),
    256,
    (512, 2),
    512,
    512,
    512,
    512,
    512,
    (1024, 2),
    1024,
)


class DepthwiseSeparable(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv2d(
            in_ch, in_ch, 3, stride=stride, padding=1, groups=in_ch, bias=False
        )
        self.BatchNorm_0 = BatchNorm(in_ch)
        self.Conv_1 = nn.Conv2d(in_ch, features, 1, bias=False)
        self.BatchNorm_1 = BatchNorm(features)

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None) -> torch.Tensor:
        x = F.relu(self.BatchNorm_0(self.Conv_0(x), stats))
        return F.relu(self.BatchNorm_1(self.Conv_1(x), stats))


class MobileNet(nn.Module):
    def __init__(
        self,
        num_classes: int = 10,
        image_size: Tuple[int, int, int] = (32, 32, 3),
        remat: bool = False,
    ):
        super().__init__()
        self.remat = remat
        self.Conv_0 = nn.Conv2d(image_size[-1], 32, 3, padding=1, bias=False)
        self.BatchNorm_0 = BatchNorm(32)
        in_ch = 32
        for count, entry in enumerate(_CFG):
            features, stride = (entry, 1) if isinstance(entry, int) else entry
            setattr(
                self, f"DepthwiseSeparable_{count}",
                DepthwiseSeparable(in_ch, features, stride),
            )
            in_ch = features
        self.Dense_0 = nn.Linear(in_ch, num_classes)
        name_batch_norms(self)

    def forward(self, x: torch.Tensor, train: bool = False):
        """``x: [n, h, w, c]`` -> logits ``[n, num_classes]``, or
        ``(logits, new_stats)`` with ``train=True``."""
        stats: Optional[Stats] = {} if train else None
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.BatchNorm_0(self.Conv_0(x), stats))
        for count in range(len(_CFG)):
            x = run_block(getattr(self, f"DepthwiseSeparable_{count}"), x, stats, self.remat)
        logits = self.Dense_0(global_avg_pool(x))
        return (logits, stats) if train else logits


@register("mobilenet")
def make_mobilenet(num_classes: int = 10, image_size=(32, 32, 3), remat: bool = False) -> nn.Module:
    return MobileNet(num_classes, image_size, remat)
