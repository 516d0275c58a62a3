"""The coordinator's tensor math: combining the clients' deltas into the
next global model.

The port of the three programs fedtpu's ``PrimaryServer`` jits
(``fedtpu/transport/federation.py``), as plain functions on tensors: they
run on the card when they are given card tensors. A tree here is
``{"params": {torch name: tensor}, "batch_stats": {...}}`` in torch's
layout; a row buffer is ``[rows, P]`` f32 in the edge's flax order and
layout (:func:`fedtpu_torch.ops.flat.make_tree_layout`).

- :func:`aggregate` (``_aggregate_impl``): the stacked ``[clients, ...]``
  deltas combined by the (weighted) mean, the coordinate-wise median or
  trimmed mean (:mod:`fedtpu_torch.ops.quantile`'s sorts) or Krum's
  selection, with DP clipping before and seeded noise after, then the
  server optimizer on the params and the BatchNorm statistics moved by
  their combined delta;
- :func:`finalize_stream` (``_finalize_stream_impl``): the streaming
  pipeline's weighted mean over the row buffer, unpacked once;
- :func:`finalize_partial` (``_finalize_partial_impl``): the tiered root's
  combine of pre-weighted partial sums, divided once;
- :func:`fedbuff_apply`: ``run_async``'s FedBuff update of a buffer of
  deltas, the staleness-discounted weights (and the damping) in front of
  :func:`aggregate`.

The mean sums the weighted rows as fedtpu's compiled reduce sums them on
the CPU (:func:`fedtpu_torch.ops.flat.fma_row_sum`), so these functions
give fedtpu's CPU results bit for bit where its arithmetic allows. Nothing
here imports grpc.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from fedtpu_torch.config import RoundConfig, validate_round_options
from fedtpu_torch.core import server_opt
from fedtpu_torch.core.round import (
    DP_NOISE_SEED,
    _cat_rows,
    _dp_clip,
    _dp_noise,
    _krum_over_clients,
    _robust_over_clients,
    _split_row,
    flat_weighted_mean,
)
from fedtpu_torch.ops import flat as flat_ops

Leaves = Dict[str, torch.Tensor]
Tree = Dict[str, Leaves]


def _server(cfg: RoundConfig, server):
    return server_opt.make_server_optimizer(cfg.fed) if server is None else server


def _apply(cfg: RoundConfig, server, global_tree: Tree, deltas: Tree, opt_state):
    """The server optimizer on the params, the statistics moved by their
    delta: the common tail of the three programs."""
    new_params, new_opt = server_opt.apply(
        _server(cfg, server), global_tree["params"], deltas["params"], opt_state, compiled=True
    )
    new_stats = {k: g + deltas["batch_stats"][k] for k, g in global_tree["batch_stats"].items()}
    return {"params": new_params, "batch_stats": new_stats}, new_opt


_NARROW = (torch.bfloat16, torch.float16)


def _narrow_mean(x: torch.Tensor, weights: torch.Tensor, total: torch.Tensor, excess: bool) -> torch.Tensor:
    """fedtpu's ``sum(d * w, axis=0) / total`` of a bf16 (or f16) leaf as
    XLA compiles it on the CPU, where excess precision is allowed: the
    weights cast to the leaf's dtype, the products (exact in f32) summed
    over the clients in f32 in row order (``jnp.sum`` upcasts a narrow
    float), the sum rounded to the leaf's dtype and divided by the total
    cast to it, through f32. ``excess``: the quotient stays f32, as where
    its one consumer is the add to the f32 global model (FedAvg, the
    statistics), whose fusion elides the rounding; else it is rounded to
    the leaf's dtype (a server optimizer's program keeps the rounding)."""
    w = weights.to(x.dtype).float().view((-1,) + (1,) * (x.ndim - 1))
    s = flat_ops.row_sum(x.float() * w).to(x.dtype)
    q = s.float() / total.to(x.dtype).float()
    return q if excess else q.to(x.dtype)


def _mean(stacked: Leaves, weights: torch.Tensor, total: torch.Tensor, excess: bool = True) -> Leaves:
    """fedtpu's per-leaf ``sum(d * w, axis=0) / total`` of every stacked
    leaf, the wide ones taken side by side (each coordinate is its own
    sum, so this is the per-leaf result, in one pass), a narrow one in its
    own dtype's arithmetic (:func:`_narrow_mean`, ``excess`` passed on)."""
    wide = {k: x for k, x in stacked.items() if x.dtype not in _NARROW}
    out = {k: _narrow_mean(x, weights, total, excess) for k, x in stacked.items() if x.dtype in _NARROW}
    if wide:
        leaves = list(wide.values())
        row = flat_ops.fma_row_sum(_cat_rows(leaves), weights.to(torch.float32)) / total
        out.update(zip(wide, _split_row(row, leaves)))
    return {k: out[k] for k in stacked}


def aggregate(
    cfg: RoundConfig,
    global_tree: Tree,
    stacked_deltas: Tree,
    weights: torch.Tensor,
    opt_state,
    round_idx: int,
    server: Optional[server_opt.ServerOptimizer] = None,
    dp_normals: Optional[Leaves] = None,
) -> Tuple[Tree, object]:
    """fedtpu's ``PrimaryServer._aggregate_impl``: ``(new global tree, new
    server-optimizer state)`` from the ``[clients, ...]`` deltas of the
    clients that replied (every row is live). ``weights [clients]`` are the
    example counts (or ones); the robust combines and Krum ignore them.
    ``dp_normals``: the standard normals of the DP noise (fedtpu's draws,
    for a parity check) instead of the port's seeded draw."""
    fed = cfg.fed
    validate_round_options(cfg, compressed=fed.compression != "none")
    if fed.dp_clip_norm > 0 and global_tree["batch_stats"]:
        raise ValueError(
            "DP requires a BatchNorm-free model: batch statistics are "
            "released unclipped. Pick a model without batch_stats."
        )
    n = weights.shape[0]
    params, stats = stacked_deltas["params"], stacked_deltas["batch_stats"]
    if fed.dp_clip_norm > 0:
        params = _dp_clip(params, fed.dp_clip_norm)
    live = torch.ones((n,), dtype=torch.float32, device=weights.device)
    if fed.aggregator == "krum":
        params, stats = _krum_over_clients((params, stats), live, fed.trim_fraction)
    elif fed.aggregator == "mean":
        total = torch.clamp(flat_ops.row_sum(weights), min=1e-9)
        server = _server(cfg, server)
        params, stats = _mean(params, weights, total, excess=server is None), _mean(stats, weights, total)
    else:
        params = _robust_over_clients(params, live, fed.aggregator, fed.trim_fraction)
        stats = _robust_over_clients(stats, live, fed.aggregator, fed.trim_fraction)
    if fed.dp_clip_norm > 0 and fed.dp_noise_multiplier > 0:
        count = torch.tensor(float(n), dtype=torch.float32, device=weights.device)
        std = fed.dp_clip_norm * fed.dp_noise_multiplier / torch.clamp(count, min=1.0)
        params = _dp_noise(params, std, round_idx, cfg.data.seed ^ DP_NOISE_SEED, dp_normals)
    return _apply(cfg, server, global_tree, {"params": params, "batch_stats": stats}, opt_state)


def finalize_stream(
    cfg: RoundConfig,
    layout: flat_ops.FlatLayout,
    global_tree: Tree,
    rows: torch.Tensor,
    weights: torch.Tensor,
    opt_state,
    server: Optional[server_opt.ServerOptimizer] = None,
) -> Tuple[Tree, object]:
    """fedtpu's ``_finalize_stream_impl``: the weighted mean of the
    ``[participants, P]`` rows (:func:`fedtpu_torch.core.round.
    flat_weighted_mean`), unpacked to the delta tree, then the server
    optimizer and the statistics' add."""
    deltas = flat_ops.unpack_tree(layout, flat_weighted_mean(rows, weights))
    return _apply(cfg, server, global_tree, deltas, opt_state)


def finalize_partial(
    cfg: RoundConfig,
    layout: flat_ops.FlatLayout,
    global_tree: Tree,
    sum_rows: torch.Tensor,
    weight_sums: torch.Tensor,
    opt_state,
    server: Optional[server_opt.ServerOptimizer] = None,
) -> Tuple[Tree, object]:
    """fedtpu's ``_finalize_partial_impl``: the tiers' pre-weighted sums
    combined and divided once (:func:`fedtpu_torch.ops.flat.
    combine_partial_rows`), then the flat path's tail."""
    deltas = flat_ops.unpack_tree(layout, flat_ops.combine_partial_rows(sum_rows, weight_sums))
    return _apply(cfg, server, global_tree, deltas, opt_state)


def fedbuff_apply(
    cfg: RoundConfig,
    global_tree: Tree,
    stacked_deltas: Tree,
    raw,
    stalenesses,
    staleness_power: float,
    staleness_damping: bool,
    opt_state,
    round_idx: int,
    server: Optional[server_opt.ServerOptimizer] = None,
) -> Tuple[Tree, object]:
    """One FedBuff update of ``PrimaryServer.run_async``: the buffer's
    ``[k, ...]`` deltas (each reply against the model it pulled), ``raw``
    their weights before the discount (example counts, or ones) and
    ``stalenesses`` the server updates since each pull. The weights are
    ``w / (1 + s)^p`` in Python floats; with ``staleness_damping`` every delta is
    first scaled by ``sum(disc) / max(sum(raw), 1e-9)``, the factor in f32
    and each product cast back to its leaf's dtype, so that the discount
    damps the applied magnitude; then :func:`aggregate`. Returns ``(new
    global tree, new server-optimizer state)``."""
    disc = [w / (1.0 + st) ** staleness_power for w, st in zip(raw, stalenesses)]
    device = next(iter(stacked_deltas["params"].values())).device
    weights = torch.tensor(disc, dtype=torch.float32, device=device)
    if staleness_damping:
        damp = torch.tensor(sum(disc) / max(sum(raw), 1e-9), dtype=torch.float32, device=device)
        stacked_deltas = {
            col: {k: (x.float() * damp).to(x.dtype) for k, x in leaves.items()}
            for col, leaves in stacked_deltas.items()
        }
    return aggregate(cfg, global_tree, stacked_deltas, weights, opt_state, round_idx, server=server)
