"""The federated round: local training of every client, compression of
the deltas, the weighted mean, the new global model.

The port of ``fedtpu.core.round`` for the mean aggregator, the per-leaf
delta layout and ``server_optimizer='none'`` (FedAvg applies the mean delta
directly). Everything stays on the state's device; the host supplies only
the round's batch and learning rate.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from fedtpu_torch.config import RoundConfig, validate
from fedtpu_torch.core import optim
from fedtpu_torch.core.client import ClientOutput, make_local_update

Tree = Dict[str, torch.Tensor]


class FederatedState(NamedTuple):
    """Cross-round state.

    - ``params``: the global model, f32.
    - ``opt_state``: per-client momentum, ``[clients, ...]`` per leaf, kept
      across rounds as each reference client keeps its optimizer.
    - ``round_idx``: rounds completed (a host int: it drives the learning
      rate schedule and the data rotation without a device read).
    - ``comp_state``: per-client residuals of the codec (error feedback),
      ``()`` when compression or error feedback is off.
    """

    params: Tree
    opt_state: Tree
    round_idx: int
    comp_state: object = ()


class RoundMetrics(NamedTuple):
    """``loss``/``accuracy`` average over alive clients; ``per_client_loss``
    is the ``[clients]`` vector, 0 for dead clients."""

    loss: torch.Tensor
    accuracy: torch.Tensor
    num_active: torch.Tensor
    update_norm: torch.Tensor
    per_client_loss: torch.Tensor


class RoundBatch(NamedTuple):
    """One round of input for all clients: ``x [clients, steps, batch, h,
    w, c]``, ``y [clients, steps, batch]``, ``step_mask [clients, steps]``
    bool, ``weights [clients]`` example counts, ``alive [clients]`` bool."""

    x: torch.Tensor
    y: torch.Tensor
    step_mask: torch.Tensor
    weights: torch.Tensor
    alive: torch.Tensor


def init_state(
    model: nn.Module,
    cfg: RoundConfig,
    compressor=None,
    params: Optional[Tree] = None,
) -> FederatedState:
    """Initial state on the model's device. ``params`` (for example from
    :func:`fedtpu_torch.convert.from_flax`) replaces the model's own
    initial weights."""
    if params is None:
        params = {k: v.detach().clone() for k, v in model.named_parameters()}
    device = next(model.parameters()).device
    params = {k: v.to(device=device, dtype=torch.float32).contiguous() for k, v in params.items()}
    n = cfg.fed.num_clients
    return FederatedState(
        params=params,
        opt_state=optim.init(params, n),
        round_idx=0,
        comp_state=() if compressor is None else compressor.init(params, n),
    )


def _mean_over_clients(stacked: Tree, weights: torch.Tensor) -> Tree:
    """Weighted mean over the leading clients axis; all zero when every
    weight is zero (no client contributes: no update)."""
    total = weights.sum()
    safe = torch.where(total > 0, total, torch.ones_like(total))
    alive_any = (total > 0).float()
    out = {}
    for k, x in stacked.items():
        w = weights.view((-1,) + (1,) * (x.ndim - 1)).to(x.dtype)
        out[k] = (x * w).sum(0) / safe.to(x.dtype) * alive_any.to(x.dtype)
    return out


def tree_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(x.float() ** 2) for x in tree.values()))


def make_round_step(
    model: nn.Module, cfg: RoundConfig, compressor=None
) -> Callable[..., Tuple[FederatedState, RoundMetrics]]:
    """``round_step(state, batch, generator=None) -> (new_state, metrics)``."""
    validate(cfg)
    local_update = make_local_update(model, cfg)

    def round_step(
        state: FederatedState,
        batch: RoundBatch,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[FederatedState, RoundMetrics]:
        # Dead clients do no local work.
        step_mask = batch.step_mask & batch.alive[:, None]
        out: ClientOutput = local_update(
            state.params, state.opt_state, batch.x, batch.y, step_mask,
            cfg.opt.lr_at(state.round_idx), generator,
        )
        if cfg.fed.weighted:
            agg_w = batch.weights * batch.alive.to(batch.weights.dtype)
        else:
            agg_w = batch.alive.float()
        deltas = {k: out.params[k] - state.params[k][None] for k in state.params}
        comp_state = state.comp_state
        if compressor is not None:
            deltas, new_comp = compressor.apply(deltas, comp_state)
            if comp_state:
                # A client that contributes nothing this round keeps its
                # residual until it does.
                keep = agg_w > 0
                comp_state = {
                    k: torch.where(keep.view((-1,) + (1,) * (new.ndim - 1)), new, comp_state[k])
                    for k, new in new_comp.items()
                }
            else:
                comp_state = new_comp
        mean_delta = _mean_over_clients(deltas, agg_w)
        new_params = {k: state.params[k] + mean_delta[k] for k in state.params}

        alive_f = batch.alive.float()
        n_alive = alive_f.sum()
        n_active = torch.clamp(n_alive, min=1.0)
        metrics = RoundMetrics(
            loss=(out.loss * alive_f).sum() / n_active,
            accuracy=(out.accuracy * alive_f).sum() / n_active,
            num_active=n_alive,
            update_norm=tree_norm(mean_delta),
            per_client_loss=out.loss * alive_f,
        )
        new_state = FederatedState(
            params=new_params,
            opt_state=out.opt_state,
            round_idx=state.round_idx + 1,
            comp_state=comp_state,
        )
        return new_state, metrics

    return round_step
