"""LeNet-5 for 32x32 inputs: the port of ``fedtpu.models.lenet``.

Two 5x5 VALID convolutions (``Conv_0`` 6, ``Conv_1`` 16 channels, with
bias), each followed by ReLU and a 2x2 max-pool, then ``Dense_0`` (120),
``Dense_1`` (84) and ``Dense_2``. flax flattens the last feature map in
(H, W, C) order; this model moves channels last again before it flattens
(400 features at 32x32, 256 at 28x28), so ``Dense_0``'s weight is the
flax kernel transposed and nothing else. No batch statistics.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
import torch.nn.functional as F

from fedtpu_torch.models.common import max_pool
from fedtpu_torch.models.registry import register


class LeNet(nn.Module):
    def __init__(self, num_classes: int = 10, image_size: Tuple[int, int, int] = (32, 32, 3)):
        super().__init__()
        h, w, c = image_size
        self.Conv_0 = nn.Conv2d(c, 6, 5)
        self.Conv_1 = nn.Conv2d(6, 16, 5)
        fh, fw = ((h - 4) // 2 - 4) // 2, ((w - 4) // 2 - 4) // 2
        self.Dense_0 = nn.Linear(16 * fh * fw, 120)
        self.Dense_1 = nn.Linear(120, 84)
        self.Dense_2 = nn.Linear(84, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False):
        """``x: [n, h, w, c]`` -> logits ``[n, num_classes]``, or
        ``(logits, {})`` with ``train=True``."""
        x = x.permute(0, 3, 1, 2)
        x = max_pool(F.relu(self.Conv_0(x)), 2)
        x = max_pool(F.relu(self.Conv_1(x)), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(self.Dense_1(F.relu(self.Dense_0(x))))
        logits = self.Dense_2(x)
        return (logits, {}) if train else logits


@register("lenet")
def make_lenet(num_classes: int = 10, image_size=(32, 32, 3)) -> nn.Module:
    return LeNet(num_classes, image_size)
