"""The federated round: local training of every client, the attack of
seeded malicious clients, compression of the deltas, screening, DP
clipping, the combine, DP noise, the new global model.

The port of ``fedtpu.core.round``, step for step in fedtpu's order. The
combine is the (weighted) mean, a coordinate-wise median or trimmed mean
(:func:`_robust_over_clients`) or Krum's selection
(:func:`_krum_over_clients`), and the server optimizers
(:mod:`fedtpu_torch.core.server_opt`; ``'none'`` is FedAvg, which applies
the combined delta directly) step on its result. On the flat layout the
deltas are packed once into a ``[clients, P]`` buffer
(:mod:`fedtpu_torch.ops.flat`), the codec and the combine run on it, and
the ``[P]`` result is unpacked once. BatchNorm's statistics are combined
beside the params, as fedtpu does: each client's ``client - global`` delta
goes through the same combine, never through a codec, and the global
statistics move by the combined delta. Everything stays on the state's
device; the host supplies only the round's batch and learning rate.

fedtpu draws the DP noise, the noise attack and the attack's fire draws
from JAX's PRNG, which torch cannot reproduce: the port draws them from
``torch.Generator`` streams seeded from ``(base seed, round)`` and takes
them injected through :class:`RoundDraws` for parity checks, as it takes
a model's dropout keep masks (drawn otherwise from the round's
generator).
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from fedtpu_torch.config import (
    RoundConfig,
    screening_enabled,
    validate,
    validate_round_options,
)
from fedtpu_torch.core import optim, server_opt
from fedtpu_torch.core.client import ClientOutput, make_local_update, make_local_update_mega
from fedtpu_torch.ops import flat as flat_ops
from fedtpu_torch.ops.compression import round_generator
from fedtpu_torch.ops.quantile import quantile, sort_rows
from fedtpu_torch.sim import adversary

Tree = Dict[str, torch.Tensor]

log = logging.getLogger("fedtpu_torch.round")

# Base seed of the DP noise stream, xor-ed with DataConfig.seed (fedtpu's).
DP_NOISE_SEED = 0x5F5E5F

_WEIGHTED_ROBUST_WARNED = set()


def warn_weighted_robust(aggregator: str) -> bool:
    """A robust aggregator ignores ``weighted=True``'s example counts (a
    count-weighted robust statistic would hand an attacker its influence
    back through an inflated count): warn once a process per aggregator.
    True when the combination applies."""
    if aggregator == "mean":
        return False
    if aggregator not in _WEIGHTED_ROBUST_WARNED:
        _WEIGHTED_ROBUST_WARNED.add(aggregator)
        log.warning(
            "aggregator=%r ignores example-count weights (weighted=True has "
            "no effect on the combine): robust statistics weight clients "
            "uniformly by design — self-reported counts are an adversary's "
            "influence knob. Set weighted=False to silence this.",
            aggregator,
        )
    return True


class FederatedState(NamedTuple):
    """Cross-round state.

    - ``params``: the global model, f32.
    - ``batch_stats``: the global BatchNorm running statistics, f32
      (``{}`` for a model without BatchNorm).
    - ``opt_state``: per-client momentum, ``[clients, ...]`` per leaf in
      ``OptimizerConfig.momentum_dtype``, kept across rounds as each
      reference client keeps its optimizer.
    - ``round_idx``: rounds completed (a host int: it drives the learning
      rate schedule, the data rotation and the seeded draws without a
      device read).
    - ``comp_state``: per-client residuals of the codec (error feedback):
      a dict of ``[clients, ...]`` leaves per leaf, one ``[clients, P]``
      tensor on the flat layout, ``()`` when compression or error feedback
      is off.
    - ``server_opt_state``: the server optimizer's moments over the global
      model (:mod:`fedtpu_torch.core.server_opt`); ``()`` for FedAvg.
    - ``last_client_loss``: ``[clients]`` f32, each client's loss in the
      last round it trained, NaN until it has; loss-proportional
      participation sampling reads it.
    """

    params: Tree
    batch_stats: Tree
    opt_state: Tree
    round_idx: int
    comp_state: object = ()
    server_opt_state: object = ()
    last_client_loss: object = ()


class RoundMetrics(NamedTuple):
    """``loss``/``accuracy`` average over alive clients; ``per_client_loss``
    is the ``[clients]`` vector, 0 for dead clients; ``screened`` the
    ``[clients]`` bool rows that screening rejected (all False when it is
    off)."""

    loss: torch.Tensor
    accuracy: torch.Tensor
    num_active: torch.Tensor
    update_norm: torch.Tensor
    per_client_loss: torch.Tensor
    screened: torch.Tensor = ()


class RoundBatch(NamedTuple):
    """One round of input for all clients: ``x [clients, steps, batch, h,
    w, c]``, ``y [clients, steps, batch]``, ``step_mask [clients, steps]``
    bool, ``weights [clients]`` example counts, ``alive [clients]`` bool;
    ``attack_seats [clients]`` f32, 1 where a seat hosts a seeded attacker
    (``()`` when no attack is armed)."""

    x: torch.Tensor
    y: torch.Tensor
    step_mask: torch.Tensor
    weights: torch.Tensor
    alive: torch.Tensor
    attack_seats: object = ()


class RoundDraws(NamedTuple):
    """Draws that replace the round's own seeded streams, each a function
    of the round index (the parity checks hand in fedtpu's draws):

    - ``dp_noise(round_idx, tree) -> tree``: standard normals shaped like
      each leaf of the combined delta (torch names and layout);
    - ``attack_noise(round_idx, tree) -> tree``: standard normals for the
      noise attack, ``[clients, ...]`` per leaf of the deltas (one leaf,
      ``""``, on the flat layout), or ``[...]`` in colluding mode;
    - ``attack_uniforms(round_idx, n) -> [n]`` (``[]`` colluding): the
      attack's fire draws;
    - ``dropout_masks(round_idx) -> tree``: the model's keep masks by
      module path, ``[clients, steps, batch, ...]`` (megabatch: ``[groups,
      steps, k * batch, ...]``), in place of the step's draws from the
      round's generator (:mod:`fedtpu_torch.core.client`).
    """

    dp_noise: Optional[Callable[[int, Tree], Tree]] = None
    attack_noise: Optional[Callable[[int, Tree], Tree]] = None
    attack_uniforms: Optional[Callable[[int, int], torch.Tensor]] = None
    dropout_masks: Optional[Callable[[int], Tree]] = None


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
    (which work in f32, as fedtpu's do). DP refuses a model with BatchNorm,
    as fedtpu does."""
    if params is None:
        params = dict(model.named_parameters())
    if batch_stats is None:
        batch_stats = dict(model.named_buffers())
    if cfg.fed.dp_clip_norm > 0 and batch_stats:
        raise ValueError(
            "DP requires a BatchNorm-free model: batch statistics are "
            "unbounded functions of client data and are released unclipped "
            "and unnoised, voiding the sensitivity bound. Pick a model "
            "without batch_stats (e.g. mlp)."
        )
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
        opt_state=optim.init(params, n, cfg.opt),
        round_idx=0,
        comp_state=() if compressor is None else compressor.init(params, n),
        server_opt_state=server_opt.init(server_opt.make_server_optimizer(cfg.fed), params),
        last_client_loss=torch.full((n,), float("nan"), device=device),
    )


def _items(tree) -> Tree:
    """A delta tree as a dict: a flat ``[clients, P]`` buffer is ``{"": it}``."""
    return {"": tree} if isinstance(tree, torch.Tensor) else tree


def _like(tree, items: Tree):
    return items[""] if isinstance(tree, torch.Tensor) else items


def _rows(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A ``[clients]`` vector shaped to broadcast against ``x``'s rows."""
    return w.view((-1,) + (1,) * (x.ndim - 1))


def _cat_rows(leaves) -> torch.Tensor:
    """``[clients, total]`` f32: each ``[clients, ...]`` leaf flattened, side
    by side."""
    return torch.cat([x.reshape(x.shape[0], -1).float() for x in leaves], dim=1)


def _split_row(row: torch.Tensor, leaves):
    """The inverse of :func:`_cat_rows` for one ``[total]`` row: each leaf's
    slice in its shape (without the clients axis) and dtype."""
    out, off = [], 0
    for x in leaves:
        size = x[0].numel()
        out.append(row[off : off + size].reshape(x.shape[1:]).to(x.dtype))
        off += size
    return out


def flat_weighted_mean(rows: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """fedtpu's ``flat_weighted_mean`` over a ``[clients, P]`` buffer, the
    streaming server's combine: ``sum(rows * w) / max(sum(w), 1e-9)``, the
    products summed as fedtpu's compiled reduce sums them on the CPU
    (:func:`fedtpu_torch.ops.flat.fma_row_sum`)."""
    total = torch.clamp(flat_ops.row_sum(weights), min=1e-9)
    return flat_ops.fma_row_sum(rows, weights.to(rows.dtype)) / total.to(rows.dtype)


def _mean_over_clients(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted mean over the leading clients axis; all zero when every
    weight is zero (no client contributes: no update)."""
    total = weights.sum()
    safe = torch.where(total > 0, total, torch.ones_like(total))
    alive_any = (total > 0).float()
    w = _rows(weights, x).to(x.dtype)
    return (x * w).sum(0) / safe.to(x.dtype) * alive_any.to(x.dtype)


def _robust_over_clients(stacked, alive_w: torch.Tensor, aggregator: str, trim: float):
    """fedtpu's coordinate-wise robust combine over the clients axis (a dict
    of ``[clients, ...]`` leaves or one flat buffer), dead rows (``alive_w
    == 0``) left out as NaNs and example counts ignored:

    - ``median``: ``jnp.nanmedian``'s median, the mean of the two middle
      values for an even count;
    - ``trimmed_mean``: the mean, summed in client order, of the values
      inside the band from the ``trim`` quantile (``lower``) to the ``1 -
      trim`` quantile (``higher``); ``trim == 0`` is the exact uniform mean.

    A coordinate with no survivors, or a round with no live client, gives
    0. Every coordinate is its own statistic, so all leaves go through one
    sort of the ``[coordinates, clients]`` transpose
    (:mod:`fedtpu_torch.ops.quantile`), never ``torch.quantile``."""
    items = _items(stacked)
    if aggregator == "trimmed_mean" and trim == 0.0:
        uniform = (alive_w > 0).float()
        return _like(stacked, {k: _mean_over_clients(x, uniform) for k, x in items.items()})
    if not items:
        return _like(stacked, {})
    xf = _cat_rows(items.values())
    masked = torch.where((alive_w > 0)[:, None], xf, torch.full_like(xf, float("nan")))
    del xf
    rows = sort_rows(masked)
    if aggregator == "median":
        out = quantile(rows, 0.5, "midpoint")
    else:
        lo = quantile(rows, trim, "lower")[None]
        hi = quantile(rows, 1.0 - trim, "higher")[None]
        del rows
        inband = (masked >= lo) & (masked <= hi)
        band = torch.where(inband, masked, torch.zeros_like(masked))
        total = band[0].clone()
        for row in band[1:]:  # in client order, as fedtpu's reduction adds
            total += row
        out = total / inband.sum(0).float()
    out = torch.nan_to_num(out, nan=0.0)
    out = torch.where(alive_w.sum() > 0, out, torch.zeros_like(out))
    return _like(stacked, dict(zip(items, _split_row(out, items.values()))))


_KRUM_BIG = 1e30  # a large finite "infinity": keeps the sort and sums NaN-free


def _krum_over_clients(trees, alive_w: torch.Tensor, trim: float):
    """Krum (Blanchard et al. 2017), fedtpu's form: the one live client
    whose delta has the smallest summed squared distance to its ``n - f -
    2`` nearest live neighbours, ``f = floor(trim * n)``, ``n`` the live
    count. ``trees``: the deltas to select from jointly (params and
    statistics, each a dict or a flat buffer), returned in the same form
    holding the chosen client's rows (zero when no client is live).

    The distances come from one Gram matrix of the ``[clients, total]``
    concatenation, computed in f64 whatever the TF32 flags say (TF32 could
    change which client is chosen); the chosen rows are copied exactly."""
    items = [_items(t) for t in trees]
    leaves = [x for it in items for x in it.values()]
    X = _cat_rows(leaves)
    n = X.shape[0]
    alive = alive_w > 0
    X64 = X.double()
    sq = torch.sum(X64 * X64, dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (X64 @ X64.T)
    del X64
    pair_ok = alive[:, None] & alive[None, :]
    d2 = torch.where(pair_ok, torch.clamp(d2, min=0.0), torch.full_like(d2, _KRUM_BIG))
    d2 = d2 + torch.eye(n, dtype=d2.dtype, device=d2.device) * _KRUM_BIG
    n_alive = alive.sum()
    f = torch.floor(torch.tensor(trim, dtype=torch.float32, device=X.device) * n_alive.float()).long()
    k = torch.clamp(n_alive - f - 2, min=1)
    d2_sorted = torch.sort(d2, dim=1).values
    pos = (torch.arange(n, device=X.device)[None, :] < k).to(d2.dtype)
    scores = torch.where(alive, torch.sum(d2_sorted * pos, dim=1), torch.full_like(sq, float("inf")))
    chosen = iter(_split_row(X[torch.argmin(scores)] * (alive_w.sum() > 0).float(), leaves))
    return [_like(t, {k: next(chosen) for k in it}) for t, it in zip(trees, items)]


def _flax_ordered(tree: Tree):
    """A params-like dict's values in fedtpu's (flax) leaf order."""
    return [tree[k] for k in flat_ops.flax_order(tree)] if len(tree) > 1 else list(tree.values())


def _dp_clip(stacked, clip_norm: float):
    """Scale each client's delta so its L2 norm over all leaves is at most
    ``clip_norm``: fedtpu's per-client sensitivity bound of DP-FedAvg. The
    squares are summed in f32 leaf by leaf in fedtpu's leaf order."""
    items = _items(stacked)
    sq = sum(
        torch.sum(torch.square(x.float()), dim=tuple(range(1, x.ndim)))
        for x in _flax_ordered(items)
    )
    norm = torch.sqrt(torch.clamp(sq, min=1e-24))
    scale = torch.clamp(clip_norm / norm, max=1.0)
    return _like(stacked, {k: (x.float() * _rows(scale, x)).to(x.dtype) for k, x in items.items()})


def _normals(tree: Tree, base: int, round_idx: int, per_leaf_shape=None) -> Tree:
    """Standard normals shaped like each leaf (or ``per_leaf_shape(leaf)``),
    leaf by leaf in sorted key order, from a generator seeded ``(base,
    round_idx)`` on the tree's device."""
    first = next(iter(tree.values()))
    g = round_generator(base, round_idx, first.device)
    shape = per_leaf_shape or (lambda x: x.shape)
    return {
        k: torch.randn(shape(tree[k]), generator=g, device=first.device, dtype=torch.float32)
        for k in sorted(tree)
    }


def _dp_noise(tree: Tree, std: torch.Tensor, round_idx: int, seed: int, normals: Optional[Tree] = None) -> Tree:
    """Add ``std`` times standard normal noise to every leaf of the
    combined delta. The draws come from a generator seeded ``(seed,
    round_idx)``, or are ``normals`` (fedtpu's, for a parity check)."""
    if normals is None:
        normals = _normals(tree, seed, round_idx)
    return {k: x + (normals[k].to(x.device) * std).to(x.dtype) for k, x in tree.items()}


def tree_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(x.float() ** 2) for x in tree.values()))


def make_round_step(
    model: nn.Module, cfg: RoundConfig, compressor=None, draws: Optional[RoundDraws] = None
) -> Callable[..., Tuple[FederatedState, RoundMetrics]]:
    """``round_step(state, batch, generator=None) -> (new_state, metrics)``.
    ``draws`` replaces the round's seeded draws (:class:`RoundDraws`)."""
    validate(cfg)
    validate_round_options(cfg, compressed=compressor is not None)
    draws = draws or RoundDraws()
    fed = cfg.fed
    flat_mode = fed.delta_layout == "flat"
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
    if fed.weighted:
        warn_weighted_robust(fed.aggregator)
    screen = fed.screen if screening_enabled(fed.screen) else None
    # label_flip acts on the data when the engine is built, not here.
    plan = None
    if fed.sim.malicious_fraction > 0:
        plan = adversary.parse_attack(fed.sim.attack)
        if plan.kind == "label_flip":
            plan = None
    k = fed.megabatch_clients
    local_update = make_local_update_mega(model, cfg, k) if k else make_local_update(model, cfg)
    server = server_opt.make_server_optimizer(fed)

    def attack(deltas, atk_fire: torch.Tensor, round_idx: int):
        """The seeded attackers replace their honest deltas: scaled by the
        attack's factor (sign_flip: -1), or noised."""
        items = _items(deltas)
        coef = torch.where(
            atk_fire,
            torch.full(atk_fire.shape, float(plan.coef), device=atk_fire.device),
            torch.ones(atk_fire.shape, device=atk_fire.device),
        )
        if plan.coef != 1.0:
            items = {kk: (x.float() * _rows(coef, x)).to(x.dtype) for kk, x in items.items()}
        if plan.kind == "noise":
            shape = (lambda x: x.shape[1:]) if plan.collude else None
            if draws.attack_noise is not None:
                noise = draws.attack_noise(round_idx, items)
            else:
                noise = _normals(items, plan.seed ^ adversary.NOISE_SEED, round_idx, shape)
            items = {
                kk: torch.where(
                    _rows(atk_fire, x),
                    (x.float() + (noise[kk].to(x.device) * plan.std).expand(x.shape)).to(x.dtype),
                    x,
                )
                for kk, x in items.items()
            }
        return _like(deltas, items), coef

    def round_step(
        state: FederatedState,
        batch: RoundBatch,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[FederatedState, RoundMetrics]:
        r = state.round_idx
        # Dead clients do no local work.
        step_mask = batch.step_mask & batch.alive[:, None]
        out: ClientOutput = local_update(
            state.params, state.batch_stats, state.opt_state, batch.x, batch.y, step_mask,
            cfg.opt.lr_at(r), generator,
            draws.dropout_masks(r) if draws.dropout_masks is not None else None,
        )
        n = step_mask.shape[0]
        if fed.weighted:
            agg_w = batch.weights * batch.alive.to(batch.weights.dtype)
        else:
            agg_w = batch.alive.float()
        deltas = {kk: out.params[kk] - state.params[kk][None] for kk in state.params}
        if flat_mode:
            # Pack once into the [clients, P] buffer: the codec and the
            # combine each run as one op over the whole model.
            lay = flat_ops.make_layout(state.params, pow2=pow2)
            deltas = flat_ops.pack_stacked(lay, deltas)
        # Malicious seats replace their honest delta before the codec: the
        # attacker follows the protocol, only its update is hostile.
        atk_fire = coef = None
        if plan is not None and isinstance(batch.attack_seats, torch.Tensor):
            uniforms = None
            if plan.p < 1.0 and draws.attack_uniforms is not None:
                uniforms = draws.attack_uniforms(r, n)
            atk_fire = adversary.attack_fire_mask(plan, batch.attack_seats, r, uniforms)
            deltas, coef = attack(deltas, atk_fire, r)
        comp_state = state.comp_state
        if compressor is not None:
            if flat_mode:
                deltas, new_comp = compressor.apply_flat(deltas, comp_state, lay, round_idx=r)
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
        stats_delta = {kk: out.batch_stats[kk] - g[None] for kk, g in state.batch_stats.items()}
        if atk_fire is not None and plan.coef != 1.0:
            # The attacker poisons its whole submission: Krum selects the
            # params and the statistics jointly.
            stats_delta = {kk: (x.float() * _rows(coef, x)).to(x.dtype) for kk, x in stats_delta.items()}
        # Screening: rejected rows leave the combine through the zero-weight
        # mask dead clients take.
        screened = torch.zeros((n,), dtype=torch.bool, device=agg_w.device)
        if screen is not None:
            rows = deltas if flat_mode else flat_ops.pack_stacked(flat_ops.make_layout(state.params), deltas)
            keep, _ = flat_ops.screen_rows(rows, agg_w, screen.norm_max, screen.zmax, screen.cos_min)
            del rows
            screened = (agg_w > 0) & ~keep
            agg_w = agg_w * keep.to(agg_w.dtype)
        if fed.dp_clip_norm > 0:
            deltas = _dp_clip(deltas, fed.dp_clip_norm)
        if fed.aggregator == "krum":
            mean_delta, mean_stats_delta = _krum_over_clients((deltas, stats_delta), agg_w, fed.trim_fraction)
        else:
            if fed.aggregator == "mean":
                def combine(t):
                    return _like(t, {kk: _mean_over_clients(x, agg_w) for kk, x in _items(t).items()})
            else:
                def combine(t):
                    return _robust_over_clients(t, agg_w, fed.aggregator, fed.trim_fraction)
            mean_delta, mean_stats_delta = combine(deltas), combine(stats_delta)
        if flat_mode:
            # Unpack once, the [P] result and not each client's row, before
            # the DP noise, whose draws then follow the leaves.
            mean_delta = flat_ops.unpack(lay, mean_delta)
        if fed.dp_clip_norm > 0 and fed.dp_noise_multiplier > 0:
            n_participants = (agg_w > 0).float().sum()
            std = fed.dp_clip_norm * fed.dp_noise_multiplier / torch.clamp(n_participants, min=1.0)
            normals = draws.dp_noise(r, mean_delta) if draws.dp_noise is not None else None
            mean_delta = _dp_noise(mean_delta, std, r, cfg.data.seed ^ DP_NOISE_SEED, normals)
        new_params, new_server_state = server_opt.apply(
            server, state.params, mean_delta, state.server_opt_state
        )
        new_stats = {kk: g + mean_stats_delta[kk] for kk, g in state.batch_stats.items()}

        alive_f = batch.alive.float()
        n_alive = alive_f.sum()
        n_active = torch.clamp(n_alive, min=1.0)
        metrics = RoundMetrics(
            loss=(out.loss * alive_f).sum() / n_active,
            accuracy=(out.accuracy * alive_f).sum() / n_active,
            num_active=n_alive,
            update_norm=tree_norm(mean_delta),
            per_client_loss=out.loss * alive_f,
            screened=screened,
        )
        new_state = FederatedState(
            params=new_params,
            batch_stats=new_stats,
            opt_state=out.opt_state,
            round_idx=r + 1,
            comp_state=comp_state,
            server_opt_state=new_server_state,
            # Only a client that trained this round is observed: an alive
            # client with an empty shard ran no step, and its 0 would starve
            # it under loss-proportional sampling.
            last_client_loss=torch.where(step_mask.any(1), out.loss.float(), _last_loss(state, n)),
        )
        return new_state, metrics

    return round_step


def _last_loss(state: FederatedState, n: int) -> torch.Tensor:
    """The state's last losses; all NaN for a state built without them."""
    if isinstance(state.last_client_loss, torch.Tensor):
        return state.last_client_loss
    return torch.full((n,), float("nan"), device=next(iter(state.params.values())).device)


def _keep_rows(keep: torch.Tensor, new, old):
    """``new`` where ``keep[client]``, else ``old``, per residual tensor."""
    if isinstance(old, dict):
        return {k: _keep_rows(keep, v, old[k]) for k, v in new.items()}
    return torch.where(_rows(keep, new), new, old)
