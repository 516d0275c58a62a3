"""Local SGD with torch semantics, over per-client stacked buffers.

The port of ``fedtpu.core.optim``: weight decay is added to the gradient
before the momentum update (coupled), then Nesterov optionally looks ahead.
The momentum is a plain dict of ``[clients, ...]`` buffers carried in the
federated state across rounds, not ``torch.optim`` state, so one call steps
every client at once. With ``momentum_dtype='bfloat16'`` the buffers are
stored in bf16, but each update upcasts the buffer and computes in f32:
only the stored buffer is rounded, as in fedtpu.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from fedtpu_torch.config import OptimizerConfig

Params = Dict[str, torch.Tensor]


def init(params: Params, num_clients: int, cfg: Optional[OptimizerConfig] = None) -> Params:
    """Zero momentum buffers ``[num_clients, ...]`` for every leaf, in
    ``cfg.momentum_dtype`` (f32 without a ``cfg``)."""
    dtype = getattr(torch, "float32" if cfg is None else cfg.momentum_dtype)
    return {
        k: torch.zeros((num_clients,) + tuple(p.shape), dtype=dtype, device=p.device)
        for k, p in params.items()
    }


def apply(
    params: Params, grads: Params, momentum: Params, lr: float, cfg: OptimizerConfig
) -> Tuple[Params, Params]:
    """One SGD step: ``(new_params, new_momentum)``."""
    new_params, new_mom = {}, {}
    for k, p in params.items():
        decayed = grads[k] + cfg.weight_decay * p
        buf = cfg.momentum * momentum[k].float() + decayed
        direction = decayed + cfg.momentum * buf if cfg.nesterov else buf
        new_params[k] = p - lr * direction
        new_mom[k] = buf.to(momentum[k].dtype)  # the stored dtype, as fedtpu stores it
    return new_params, new_mom
