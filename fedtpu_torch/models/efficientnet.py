"""EfficientNet-B0 for CIFAR: the port of ``fedtpu.models.efficientnet``.

A 3x3/32 stem with BatchNorm and swish (``x * sigmoid(x)``), 16 MBConv
blocks (``MBConv_0..15``) per fedtpu's B0 table, global average pool,
dropout 0.2 and a dense head. A block is a 1x1 expand (``Conv_0``, absent
at expansion 1, where the depthwise conv is ``Conv_0``), a ``k x k``
depthwise conv (padding ``(k - 1) // 2``), a squeeze-and-excitation gate
(two biased 1x1 convs over the spatial mean, ``int(in_ch * 0.25)`` wide
from the block's *input* channels, swish then sigmoid) and a linear 1x1
projection with BatchNorm. A block of stride 1 whose width does not change
adds its input, its branch under drop-connect at the rate ``0.2 * b / 16``
of its index ``b``: whole examples' branches zeroed, the kept ones divided
by the keep probability. At 10 classes: 3,598,598 params in 210 leaves,
39,456 statistics in 96.

Train mode draws random numbers: the keep masks come in as
``model(x, train=True, masks=...)``, keyed ``MBConv_<b>`` (one per example,
``[n, 1, 1, 1]``) for the nine blocks with a residual and a rate above 0,
and ``Dropout_0`` (``[n, 320]``) for the head, as :meth:`mask_specs` lists
them (:mod:`fedtpu_torch.models.common`). Inputs are NHWC at the public
boundary; train and eval mode otherwise follow
:mod:`fedtpu_torch.models.common`.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from fedtpu_torch.models.common import (
    BatchNorm,
    Masks,
    MaskSpec,
    Stats,
    conv1x1,
    conv3x3,
    drop,
    global_avg_pool,
    name_batch_norms,
    spatial_mean,
)
from fedtpu_torch.models.registry import register

# B0: (expansion, out_channels, num_blocks, kernel_size, stride), fedtpu's table.
_B0: Sequence[Tuple[int, int, int, int, int]] = (
    (1, 16, 1, 3, 1),
    (6, 24, 2, 3, 2),
    (6, 40, 2, 5, 2),
    (6, 80, 3, 3, 2),
    (6, 112, 3, 5, 1),
    (6, 192, 4, 5, 2),
    (6, 320, 1, 3, 1),
)


def swish(x: torch.Tensor) -> torch.Tensor:
    """fedtpu's ``x * sigmoid(x)``, two ops as fedtpu writes it."""
    return x * torch.sigmoid(x)


class MBConv(nn.Module):
    def __init__(self, in_ch: int, features: int, kernel_size: int, stride: int, expansion: int,
                 se_ratio: float = 0.25, drop_rate: float = 0.0):
        super().__init__()
        mid = expansion * in_ch
        convs = [] if expansion == 1 else [conv1x1(in_ch, mid)]
        convs.append(nn.Conv2d(mid, mid, kernel_size, stride=stride, padding=(kernel_size - 1) // 2,
                               groups=mid, bias=False))
        se_ch = int(in_ch * se_ratio)
        convs += [nn.Conv2d(mid, se_ch, 1), nn.Conv2d(se_ch, mid, 1), conv1x1(mid, features)]
        self.convs = [f"Conv_{i}" for i in range(len(convs))]
        for name, conv in zip(self.convs, convs):
            setattr(self, name, conv)
        self.norms = [f"BatchNorm_{i}" for i in range(len(convs) - 2)]
        for name, ch in zip(self.norms, [mid] * (len(self.norms) - 1) + [features]):
            setattr(self, name, BatchNorm(ch))
        self.residual = stride == 1 and in_ch == features
        self.keep = 1.0 - drop_rate

    @property
    def drops(self) -> bool:
        """Whether the block's train mode draws a drop-connect mask."""
        return self.residual and self.keep < 1.0

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        convs = [getattr(self, n) for n in self.convs]
        norms = [getattr(self, n) for n in self.norms]
        y = x
        if len(convs) == 5:  # the expand conv
            y = swish(norms.pop(0)(convs.pop(0)(y), stats))
        y = swish(norms[0](convs[0](y), stats))
        w = swish(convs[1](spatial_mean(y)))
        y = y * torch.sigmoid(convs[2](w))
        y = norms[1](convs[3](y), stats)
        if not self.residual:
            return y
        if mask is not None:  # train mode, drop-connect
            y = drop(y, mask, self.keep)
        return y + x


class EfficientNet(nn.Module):
    def __init__(
        self,
        blocks: Sequence[Tuple[int, int, int, int, int]] = _B0,
        dropout_rate: float = 0.2,
        drop_connect_rate: float = 0.2,
        num_classes: int = 10,
        image_size: Tuple[int, int, int] = (32, 32, 3),
    ):
        super().__init__()
        self.Conv_0 = conv3x3(image_size[-1], 32)
        self.BatchNorm_0 = BatchNorm(32)
        self.blocks = []
        in_ch, b, total = 32, 0, sum(n for _, _, n, _, _ in blocks)
        for expansion, features, n, k, stride in blocks:
            for i in range(n):
                # fedtpu's rate, in its order of operations.
                rate = drop_connect_rate * b / total
                block = MBConv(in_ch, features, k, stride if i == 0 else 1, expansion, drop_rate=rate)
                self.blocks.append(f"MBConv_{b}")
                setattr(self, self.blocks[-1], block)
                in_ch, b = features, b + 1
        self.width = in_ch
        self.keep = 1.0 - dropout_rate
        self.Dense_0 = nn.Linear(in_ch, num_classes)
        name_batch_norms(self)

    def mask_specs(self) -> Dict[str, MaskSpec]:
        """The keep masks train mode takes, by module path in the order the
        forward runs them: each drop-connect block's, then the head's."""
        specs = {n: MaskSpec((1, 1, 1), getattr(self, n).keep) for n in self.blocks if getattr(self, n).drops}
        if self.keep < 1.0:
            specs["Dropout_0"] = MaskSpec((self.width,), self.keep)
        return specs

    def forward(self, x: torch.Tensor, train: bool = False, masks: Optional[Masks] = None):
        """``x: [n, h, w, c]`` -> logits ``[n, num_classes]``, or
        ``(logits, new_stats)`` with ``train=True``, which needs the keep
        masks of every module :meth:`mask_specs` names."""
        stats: Optional[Stats] = {} if train else None
        masks = (masks or {}) if train else {}
        if train and masks.keys() != self.mask_specs().keys():
            raise ValueError(
                f"EfficientNet's train mode needs its keep masks {list(self.mask_specs())} "
                f"(fedtpu_torch.models.common.draw_masks); got {list(masks)}"
            )
        x = swish(self.BatchNorm_0(self.Conv_0(x.permute(0, 3, 1, 2)), stats))
        for name in self.blocks:
            x = getattr(self, name)(x, stats, masks.get(name))
        x = global_avg_pool(x)
        if "Dropout_0" in masks:
            x = drop(x, masks["Dropout_0"], self.keep)
        logits = self.Dense_0(x)
        return (logits, stats) if train else logits


@register("efficientnetb0")
def EfficientNetB0(num_classes: int = 10, image_size=(32, 32, 3)) -> EfficientNet:
    return EfficientNet(_B0, num_classes=num_classes, image_size=image_size)
