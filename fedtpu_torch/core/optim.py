"""Local SGD with torch semantics, over per-client stacked buffers.

The port of ``fedtpu.core.optim``: weight decay is added to the gradient
before the momentum update (coupled), then Nesterov optionally looks ahead.
The momentum is a plain dict of ``[clients, ...]`` buffers carried in the
federated state across rounds, not ``torch.optim`` state, so one call steps
every client at once.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from fedtpu_torch.config import OptimizerConfig

Params = Dict[str, torch.Tensor]


def init(params: Params, num_clients: int) -> Params:
    """Zero f32 momentum buffers ``[num_clients, ...]`` for every leaf."""
    return {
        k: torch.zeros((num_clients,) + tuple(p.shape), dtype=torch.float32, device=p.device)
        for k, p in params.items()
    }


def apply(
    params: Params, grads: Params, momentum: Params, lr: float, cfg: OptimizerConfig
) -> Tuple[Params, Params]:
    """One SGD step: ``(new_params, new_momentum)``."""
    new_params, new_mom = {}, {}
    for k, p in params.items():
        decayed = grads[k] + cfg.weight_decay * p
        buf = cfg.momentum * momentum[k] + decayed
        direction = decayed + cfg.momentum * buf if cfg.nesterov else buf
        new_params[k] = p - lr * direction
        new_mom[k] = buf
    return new_params, new_mom
