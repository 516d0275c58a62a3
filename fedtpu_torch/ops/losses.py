"""Loss primitives."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def softmax_ce_int_labels(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example softmax cross-entropy with integer labels, ``[...]`` from
    ``logits [..., C]``: the one-hot contraction against the log-softmax
    that ``fedtpu.ops.losses.softmax_ce_int_labels`` computes."""
    # Compared against a class range rather than F.one_hot, which reads the
    # labels' range back to the host (a device sync, and no vmap).
    classes = torch.arange(logits.shape[-1], device=logits.device)
    onehot = (labels.long()[..., None] == classes).to(logits.dtype)
    return -(onehot * F.log_softmax(logits, dim=-1)).sum(-1)
