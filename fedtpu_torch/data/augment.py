"""Random crop and horizontal flip of an NHWC batch, on the batch's device.

The port of ``fedtpu.data.augment.augment_batch``: pad by ``pad`` with 0 in
normalised space, take an ``h x w`` window at a per-example offset, then
mirror the width axis for the examples whose flip bit is set. fedtpu writes
the crop as a shift-accumulate that is bit-identical to slicing; here it is
one gather of the padded batch, with the flip folded into the column index.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def augment_batch(
    x: torch.Tensor,
    pad: int = 4,
    crop: bool = True,
    offsets: Optional[torch.Tensor] = None,
    flips: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """``x: [n, h, w, c]``. ``offsets: [n, 2]`` int crop offsets in
    ``[0, 2*pad]`` (rows, cols) and ``flips: [n]`` bool are drawn from
    ``generator`` when not given; tests pass fedtpu's draws instead."""
    n, h, w, c = x.shape
    dev = x.device
    if flips is None:
        flips = torch.randint(0, 2, (n,), generator=generator, device=dev) == 1
    ar_h = torch.arange(h, device=dev)
    ar_w = torch.arange(w, device=dev)
    if crop:
        if offsets is None:
            offsets = torch.randint(
                0, 2 * pad + 1, (n, 2), generator=generator, device=dev
            )
        offsets = offsets.to(dev)
        x = F.pad(x, (0, 0, pad, pad, pad, pad))
        rows = offsets[:, 0:1] + ar_h  # [n, h]
        cols = offsets[:, 1:2] + ar_w  # [n, w]
    else:
        rows = ar_h.expand(n, h)
        cols = ar_w.expand(n, w)
    cols = torch.where(flips.to(dev)[:, None], cols.flip(1), cols)
    batch = torch.arange(n, device=dev)[:, None, None]
    return x[batch, rows[:, :, None], cols[:, None, :]]
