"""Small CNN: two conv+pool stages and a two-layer dense head, no BN.

The port of ``fedtpu.models.smallcnn``. Inputs stay NHWC at the public
boundary, as in fedtpu. Submodules carry flax's names (``Conv_0`` ...
``Dense_1``), so a parameter's torch name is its flax path joined by dots.
flax flattens the last feature map in (H, W, C) order before ``Dense_0``;
this model moves channels last again before it flattens, so ``Dense_0``'s
weight is the flax kernel transposed and nothing else
(``tests/test_torch_models.py`` pins the order). It has no batch
statistics: in train mode it returns ``(logits, {})``, the calling
convention of :mod:`fedtpu_torch.models.common`.

``smallcnn_avgpool`` is fedtpu's perf-ablation variant: the same
parameters, both max-pools replaced by average pools.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
import torch.nn.functional as F

from fedtpu_torch.models.common import avg_pool, max_pool
from fedtpu_torch.models.registry import register


class SmallCNN(nn.Module):
    def __init__(
        self, num_classes: int = 10, image_size: Tuple[int, int, int] = (32, 32, 3), pool: str = "max"
    ):
        super().__init__()
        h, w, c = image_size
        self.pool = max_pool if pool == "max" else avg_pool
        self.Conv_0 = nn.Conv2d(c, 32, 3, padding=1)
        self.Conv_1 = nn.Conv2d(32, 64, 3, padding=1)
        self.Dense_0 = nn.Linear(64 * (h // 4) * (w // 4), 128)
        self.Dense_1 = nn.Linear(128, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False):
        """``x: [n, h, w, c]`` -> logits ``[n, num_classes]``, or
        ``(logits, {})`` with ``train=True``."""
        x = x.permute(0, 3, 1, 2)
        x = self.pool(F.relu(self.Conv_0(x)), 2)
        x = self.pool(F.relu(self.Conv_1(x)), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        logits = self.Dense_1(F.relu(self.Dense_0(x)))
        return (logits, {}) if train else logits


@register("smallcnn")
def make_smallcnn(num_classes: int = 10, image_size=(32, 32, 3)) -> nn.Module:
    return SmallCNN(num_classes, image_size)


@register("smallcnn_avgpool")
def make_smallcnn_avgpool(num_classes: int = 10, image_size=(32, 32, 3)) -> nn.Module:
    return SmallCNN(num_classes, image_size, pool="avg")
