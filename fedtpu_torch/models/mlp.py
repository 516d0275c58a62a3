"""Two-layer MLP: the port of ``fedtpu.models.mlp`` (BASELINE config 1's
model, MNIST).

``Dense_0`` (hidden 256, or 32 for ``mlp_tiny``), ReLU, ``Dense_1``. It
flattens the NHWC input as given, in flax's order, so ``Dense_0``'s weight
is the flax kernel transposed and nothing else. No batch statistics: in
train mode it returns ``(logits, {})``, the calling convention of
:mod:`fedtpu_torch.models.common`.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn
import torch.nn.functional as F

from fedtpu_torch.models.registry import register


class MLP(nn.Module):
    def __init__(
        self, num_classes: int = 10, hidden: int = 256, image_size: Tuple[int, int, int] = (28, 28, 1)
    ):
        super().__init__()
        self.Dense_0 = nn.Linear(math.prod(image_size), hidden)
        self.Dense_1 = nn.Linear(hidden, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False):
        """``x: [n, h, w, c]`` -> logits ``[n, num_classes]``, or
        ``(logits, {})`` with ``train=True``."""
        logits = self.Dense_1(F.relu(self.Dense_0(x.reshape(x.shape[0], -1))))
        return (logits, {}) if train else logits


@register("mlp")
def make_mlp(num_classes: int = 10, image_size=(28, 28, 1)) -> nn.Module:
    return MLP(num_classes, image_size=image_size)


@register("mlp_tiny")
def make_mlp_tiny(num_classes: int = 10, image_size=(28, 28, 1)) -> nn.Module:
    """fedtpu's deliberately small MLP (hidden 32), for population-scale
    simulations."""
    return MLP(num_classes, hidden=32, image_size=image_size)
