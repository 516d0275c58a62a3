"""VGG for CIFAR: the port of ``fedtpu.models.vgg``.

3x3 convs with bias, each followed by BatchNorm and ReLU, per fedtpu's
VGG11/13/16/19 configs, with 2x2 max-pools (``"M"``), then one dense head
(the CIFAR variant has no 4096-wide layers). Submodules ``Conv_i`` and
``BatchNorm_i`` numbered across the model, ``Dense_0``. flax flattens the
last feature map in (H, W, C) order: this model moves channels last before
it flattens, so ``Dense_0``'s weight is the flax kernel transposed. The
map is 1x1 at 32x32, where the order cannot show; at other sizes it does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from fedtpu_torch.models.common import BatchNorm, Stats, max_pool, name_batch_norms
from fedtpu_torch.models.registry import register

CFGS = {
    "VGG11": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "VGG13": (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "VGG16": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"),
    "VGG19": (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"),
}


class VGG(nn.Module):
    def __init__(self, name: str = "VGG19", num_classes: int = 10, image_size: Tuple[int, int, int] = (32, 32, 3)):
        super().__init__()
        self.cfg = CFGS[name]
        h, w, in_ch = image_size
        count = 0
        for entry in self.cfg:
            if entry == "M":
                h, w = h // 2, w // 2
                continue
            setattr(self, f"Conv_{count}", nn.Conv2d(in_ch, entry, 3, padding=1))
            setattr(self, f"BatchNorm_{count}", BatchNorm(entry))
            in_ch, count = entry, count + 1
        self.Dense_0 = nn.Linear(h * w * in_ch, num_classes)
        name_batch_norms(self)

    def forward(self, x: torch.Tensor, train: bool = False):
        """``x: [n, h, w, c]`` -> logits ``[n, num_classes]``, or
        ``(logits, new_stats)`` with ``train=True``."""
        stats: Optional[Stats] = {} if train else None
        x = x.permute(0, 3, 1, 2)
        count = 0
        for entry in self.cfg:
            if entry == "M":
                x = max_pool(x, 2)
                continue
            x = getattr(self, f"Conv_{count}")(x)
            x = F.relu(getattr(self, f"BatchNorm_{count}")(x, stats))
            count += 1
        logits = self.Dense_0(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))
        return (logits, stats) if train else logits


for _name in CFGS:
    register(_name)(
        lambda num_classes=10, image_size=(32, 32, 3), _n=_name: VGG(_n, num_classes, image_size)
    )
register("vgg")(lambda num_classes=10, image_size=(32, 32, 3): VGG("VGG19", num_classes, image_size))
