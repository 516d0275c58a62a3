"""The federated round: local training of every client, compression of
the deltas, the weighted mean, the new global model.

The port of ``fedtpu.core.round`` for the mean aggregator, the per-leaf and
flat delta layouts and the server optimizers (:mod:`fedtpu_torch.core.
server_opt`; ``'none'`` is FedAvg, which applies the mean delta directly).
On the flat layout the deltas are packed once into a ``[clients, P]``
buffer (:mod:`fedtpu_torch.ops.flat`), the codec and the mean run on it,
and the ``[P]`` mean is unpacked once. BatchNorm's statistics are combined
beside the params, as fedtpu does: each client's ``client - global`` delta
goes through the same weighted mean, never through a codec, and the global
statistics move by the mean delta. Everything stays on the state's device;
the host supplies only the round's batch and learning rate.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from fedtpu_torch.config import RoundConfig, validate
from fedtpu_torch.core import optim, server_opt
from fedtpu_torch.core.client import ClientOutput, make_local_update
from fedtpu_torch.ops import flat as flat_ops

Tree = Dict[str, torch.Tensor]


class FederatedState(NamedTuple):
    """Cross-round state.

    - ``params``: the global model, f32.
    - ``batch_stats``: the global BatchNorm running statistics, f32
      (``{}`` for a model without BatchNorm).
    - ``opt_state``: per-client momentum, ``[clients, ...]`` per leaf, kept
      across rounds as each reference client keeps its optimizer.
    - ``round_idx``: rounds completed (a host int: it drives the learning
      rate schedule and the data rotation without a device read).
    - ``comp_state``: per-client residuals of the codec (error feedback):
      a dict of ``[clients, ...]`` leaves per leaf, one ``[clients, P]``
      tensor on the flat layout, ``()`` when compression or error feedback
      is off.
    - ``server_opt_state``: the server optimizer's moments over the global
      model (:mod:`fedtpu_torch.core.server_opt`); ``()`` for FedAvg.
    """

    params: Tree
    batch_stats: Tree
    opt_state: Tree
    round_idx: int
    comp_state: object = ()
    server_opt_state: object = ()


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
    batch_stats: Optional[Tree] = None,
    dtype: torch.dtype = torch.float32,
) -> FederatedState:
    """Initial state on the model's device. ``params`` and
    ``batch_stats`` (for example from :func:`fedtpu_torch.convert.
    from_flax`) replace the model's own initial weights and statistics
    (its buffers). ``dtype`` is the global model's: f32, or f64 for a
    reference run, whose rounds then compute in f64 apart from the codecs
    (which work in f32, as fedtpu's do)."""
    if params is None:
        params = dict(model.named_parameters())
    if batch_stats is None:
        batch_stats = dict(model.named_buffers())
    device = next(model.parameters()).device

    def own(tree: Tree) -> Tree:
        return {
            k: v.detach().to(device=device, dtype=dtype).clone().contiguous()
            for k, v in tree.items()
        }

    params, batch_stats = own(params), own(batch_stats)
    n = cfg.fed.num_clients
    return FederatedState(
        params=params,
        batch_stats=batch_stats,
        opt_state=optim.init(params, n),
        round_idx=0,
        comp_state=() if compressor is None else compressor.init(params, n),
        server_opt_state=server_opt.init(server_opt.make_server_optimizer(cfg.fed), params),
    )


def _mean_over_clients(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted mean over the leading clients axis; all zero when every
    weight is zero (no client contributes: no update)."""
    total = weights.sum()
    safe = torch.where(total > 0, total, torch.ones_like(total))
    alive_any = (total > 0).float()
    w = weights.view((-1,) + (1,) * (x.ndim - 1)).to(x.dtype)
    return (x * w).sum(0) / safe.to(x.dtype) * alive_any.to(x.dtype)


def _keep_rows(keep: torch.Tensor, new, old):
    """``new`` where ``keep[client]``, else ``old``, per residual tensor."""
    if isinstance(old, dict):
        return {k: _keep_rows(keep, v, old[k]) for k, v in new.items()}
    return torch.where(keep.view((-1,) + (1,) * (new.ndim - 1)), new, old)


def tree_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(x.float() ** 2) for x in tree.values()))


def make_round_step(
    model: nn.Module, cfg: RoundConfig, compressor=None
) -> Callable[..., Tuple[FederatedState, RoundMetrics]]:
    """``round_step(state, batch, generator=None) -> (new_state, metrics)``."""
    validate(cfg)
    flat_mode = cfg.fed.delta_layout == "flat"
    pow2 = compressor is not None and compressor.pad_pow2
    if compressor is not None:
        if flat_mode and compressor.apply_flat is None:
            raise ValueError(
                "delta_layout='flat' needs a flat-layout compressor "
                "(make_compressor reads FedConfig.delta_layout; or pass "
                "make_topk/make_int8(..., layout='flat'))"
            )
        if not flat_mode and compressor.layout == "flat":
            raise ValueError(
                "flat-layout compressor given but FedConfig.delta_layout="
                "'per_leaf': residual state shapes would not match; make both agree"
            )
    local_update = make_local_update(model, cfg)
    server = server_opt.make_server_optimizer(cfg.fed)

    def round_step(
        state: FederatedState,
        batch: RoundBatch,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[FederatedState, RoundMetrics]:
        # Dead clients do no local work.
        step_mask = batch.step_mask & batch.alive[:, None]
        out: ClientOutput = local_update(
            state.params, state.batch_stats, state.opt_state, batch.x, batch.y, step_mask,
            cfg.opt.lr_at(state.round_idx), generator,
        )
        if cfg.fed.weighted:
            agg_w = batch.weights * batch.alive.to(batch.weights.dtype)
        else:
            agg_w = batch.alive.float()
        deltas = {k: out.params[k] - state.params[k][None] for k in state.params}
        if flat_mode:
            # Pack once into the [clients, P] buffer: the codec and the mean
            # each run as one op over the whole model.
            lay = flat_ops.make_layout(state.params, pow2=pow2)
            deltas = flat_ops.pack_stacked(lay, deltas)
        comp_state = state.comp_state
        if compressor is not None:
            if flat_mode:
                deltas, new_comp = compressor.apply_flat(
                    deltas, comp_state, lay, round_idx=state.round_idx
                )
            else:
                deltas, new_comp = compressor.apply(deltas, comp_state)
            # A flat residual is one tensor (whose truth value is ambiguous),
            # a per-leaf one a dict, no residual ().
            if isinstance(comp_state, torch.Tensor) or comp_state:
                # A client that contributes nothing this round keeps its
                # residual until it does.
                comp_state = _keep_rows(agg_w > 0, new_comp, comp_state)
            else:
                comp_state = new_comp
        if flat_mode:
            # Unpack once, the [P] mean and not each client's row.
            mean_delta = flat_ops.unpack(lay, _mean_over_clients(deltas, agg_w))
        else:
            mean_delta = {k: _mean_over_clients(x, agg_w) for k, x in deltas.items()}
        new_params, new_server_state = server_opt.apply(
            server, state.params, mean_delta, state.server_opt_state
        )
        # The statistics combine by the params' rule, uncompressed.
        new_stats = {
            k: g + _mean_over_clients(out.batch_stats[k] - g[None], agg_w)
            for k, g in state.batch_stats.items()
        }

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
            batch_stats=new_stats,
            opt_state=out.opt_state,
            round_idx=state.round_idx + 1,
            comp_state=comp_state,
            server_opt_state=new_server_state,
        )
        return new_state, metrics

    return round_step
