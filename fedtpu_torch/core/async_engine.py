"""The engine's semi-asynchronous FedBuff: buffered, staleness-weighted
aggregation over simulated clients on one device.

The port of ``fedtpu.core.async_engine``, the engine twin of
``PrimaryServer.run_async``. One *tick* is one server update. A live client
that has not trained since its last pull trains one local epoch on its own
model copy (every client holds a diverged ``[clients, ...]`` copy, unlike
the synchronous round, where every client starts from the global model),
then holds that pending update until it *arrives*. The host draws each
tick's ``buffer_k`` arrivals among the live clients, in proportion to a
per-client speed drawn once, log-normal with ``speed_sigma``. An arrival
contributes ``local - pull snapshot``, combined by :func:`fedbuff_combine`
with the discount ``(1 + staleness)^-staleness_power`` (staleness: server
updates since its pull), damped by default so that the discount scales the
applied magnitude (FedBuff, Nguyen et al. 2022). The server optimizer steps
on the combined delta, the BatchNorm statistics move by theirs, and the
arrivals re-pull the new global model and train anew next tick.

Every tick computes every client, the idle ones masked, as fedtpu's
program does. fedtpu draws the presharded rotation offset and the gather
keys from JAX's PRNG, which torch cannot reproduce: the port draws them as
its synchronous engine does (:meth:`fedtpu_torch.core.engine.Federation.
window`), and a tick takes them injected (``offset=``, ``keys=``) for a
parity check. The arrival draws are fedtpu's numpy draws, bit for bit.
fedtpu's async step ignores ``megabatch_clients`` and takes the per-client
local update; so does this one.

Composition limits are fedtpu's and rejected at build time: no delta
compression, the mean aggregator only, no DP.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from fedtpu_torch.config import RoundConfig, not_ported
from fedtpu_torch.convert import from_flax, to_flax
from fedtpu_torch.core import server_opt
from fedtpu_torch.core.client import ClientOutput, batch_eval_arrays, make_local_update
from fedtpu_torch.core.round import _mean_over_clients, _rows, tree_norm

Tree = Dict[str, torch.Tensor]


class AsyncState(NamedTuple):
    """The asynchronous federation's state, in fedtpu's field order.

    On the device: the global ``params`` and ``batch_stats``; each client's
    ``[clients, ...]`` trajectory (``client_*``), pull snapshot
    (``base_*``) and momentum (``opt_state``, in the momentum dtype);
    ``base_version [clients]`` int32, the version each client pulled;
    ``pending [clients]`` bool, True for a client that trained since its
    pull and waits to arrive; ``last_client_loss [clients]`` f32, NaN
    until a client has trained. ``version`` (server updates so far) is a
    host int, as the synchronous round's counter is; ``client_rng`` is
    ``()``: the engine draws from its own ``torch.Generator``, whose state
    :attr:`AsyncFederation.generation` carries in this leaf."""

    params: Tree
    batch_stats: Tree
    client_params: Tree
    client_stats: Tree
    base_params: Tree
    base_stats: Tree
    opt_state: Tree
    client_rng: object
    base_version: torch.Tensor
    version: int
    pending: torch.Tensor = ()
    server_opt_state: object = ()
    last_client_loss: torch.Tensor = ()


class AsyncMetrics(NamedTuple):
    """A tick's metrics: ``loss``/``accuracy`` average over the clients
    that trained this tick, ``staleness_mean`` over its arrivals."""

    loss: torch.Tensor
    accuracy: torch.Tensor
    num_arrived: torch.Tensor
    staleness_mean: torch.Tensor
    update_norm: torch.Tensor
    per_client_loss: torch.Tensor


def fedbuff_combine(
    stacked: Tree,
    raw_w: torch.Tensor,
    staleness: torch.Tensor,
    staleness_power: float,
    staleness_damping: bool = True,
) -> Tree:
    """A buffer of ``[clients, ...]`` contributions combined FedBuff-style.
    ``raw_w [clients]``: the weights before the discount, zero for a
    client that did not arrive. Damped (the default): ``sum(disc * w * x) /
    sum(w)`` with ``disc = (1 + s)^-p``; undamped: the weight-normalized
    mean ``/ sum(disc * w)``, where a uniform discount cancels."""
    agg_w = raw_w / (1.0 + staleness) ** staleness_power
    mean = {k: _mean_over_clients(x, agg_w) for k, x in stacked.items()}
    if not staleness_damping:
        return mean
    damp = agg_w.sum() / torch.clamp(raw_w.sum(), min=1e-9)
    return {k: m * damp for k, m in mean.items()}


def _validate(cfg: RoundConfig) -> None:
    if cfg.fed.compression != "none":
        raise ValueError(
            "async engine requires compression='none': sparse deltas "
            "against stale baselines corrupt aggregation."
        )
    if cfg.fed.aggregator != "mean":
        raise ValueError(
            "async engine requires aggregator='mean': a buffer_k-sized "
            "buffer is too small a population for robust statistics."
        )
    if cfg.fed.dp_clip_norm > 0:
        raise ValueError(
            "async engine does not support DP: per-update participation "
            "accounting differs from the synchronous analysis."
        )
    if cfg.fed.algorithm not in ("fedavg", "fedprox"):
        raise ValueError(f"unknown algorithm {cfg.fed.algorithm!r}")


def init_async_state(cfg: RoundConfig, params: Tree, batch_stats: Tree) -> AsyncState:
    """Everyone synced at version 0 on the global model ``params`` and
    ``batch_stats``: every client's trajectory and pull snapshot a copy of
    it, momentum zero in the momentum dtype, no client pending, the last
    losses NaN."""
    n = cfg.fed.num_clients
    device = next(iter(params.values())).device

    def rep(tree: Tree) -> Tree:
        return {k: v.expand((n,) + tuple(v.shape)).clone() for k, v in tree.items()}

    mom_dtype = getattr(torch, cfg.opt.momentum_dtype)
    return AsyncState(
        params=dict(params),
        batch_stats=dict(batch_stats),
        client_params=rep(params),
        client_stats=rep(batch_stats),
        base_params=rep(params),
        base_stats=rep(batch_stats),
        opt_state={k: torch.zeros((n,) + tuple(p.shape), dtype=mom_dtype, device=device) for k, p in params.items()},
        client_rng=(),
        base_version=torch.zeros((n,), dtype=torch.int32, device=device),
        version=0,
        pending=torch.zeros((n,), dtype=torch.bool, device=device),
        server_opt_state=server_opt.init(server_opt.make_server_optimizer(cfg.fed), params),
        last_client_loss=torch.full((n,), float("nan"), device=device),
    )


def make_async_step(
    model: nn.Module,
    cfg: RoundConfig,
    staleness_power: float = 0.5,
    staleness_damping: bool = True,
) -> Callable[..., Tuple[AsyncState, AsyncMetrics]]:
    """One tick: ``step(state, x, y, has_data, weights, arrive, alive,
    generator=None, masks=None) -> (new state, metrics)``. ``x [clients,
    steps, batch, ...]`` and ``y`` are the tick's window, ``has_data``,
    ``arrive`` and ``alive`` ``[clients]`` bool (the host draws arrivals
    among the live), ``weights [clients]`` the example counts. Every client
    that has data, is alive and is not pending trains one local epoch from
    its own trajectory, FedProx anchored at its pull snapshot, at
    ``lr_at(version)``; the arrivals' deltas against their snapshots
    combine into the global model, and the arrivals re-pull it."""
    _validate(cfg)
    server = server_opt.make_server_optimizer(cfg.fed)
    local_update = make_local_update(model, cfg, per_client=True)

    def step(
        state: AsyncState,
        x: torch.Tensor,
        y: torch.Tensor,
        has_data: torch.Tensor,
        weights: torch.Tensor,
        arrive: torch.Tensor,
        alive: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        masks: Optional[Tree] = None,
    ) -> Tuple[AsyncState, AsyncMetrics]:
        n, steps = y.shape[0], y.shape[1]
        # One epoch per pull: a pending client idles (its steps masked, so
        # its params and momentum stay as they are) until it arrives.
        trains = has_data & alive & ~state.pending
        out: ClientOutput = local_update(
            state.client_params, state.client_stats, state.opt_state, x, y,
            trains[:, None].expand(n, steps), cfg.opt.lr_at(state.version), generator, masks,
            anchor=state.base_params,
        )
        staleness = (state.version - state.base_version).float()
        base_w = weights.float() if cfg.fed.weighted else torch.ones((n,), device=arrive.device)
        arrived_f = arrive.float()
        raw_w = base_w * arrived_f
        deltas = {k: out.params[k] - state.base_params[k] for k in out.params}
        stats_delta = {k: out.batch_stats[k] - state.base_stats[k] for k in out.batch_stats}
        mean_delta = fedbuff_combine(deltas, raw_w, staleness, staleness_power, staleness_damping)
        mean_stats_delta = fedbuff_combine(stats_delta, raw_w, staleness, staleness_power, staleness_damping)
        del deltas, stats_delta
        new_params, new_server = server_opt.apply(server, state.params, mean_delta, state.server_opt_state)
        new_stats = {k: g + mean_stats_delta[k] for k, g in state.batch_stats.items()}
        new_version = state.version + 1

        def pull(stack: Tree, glob: Tree) -> Tree:
            """The arrivals' rows replaced by the new global model."""
            return {k: torch.where(_rows(arrive, v), glob[k][None], v) for k, v in stack.items()}

        n_arrived = arrived_f.sum()
        trains_f = trains.float()
        n_trained = torch.clamp(trains_f.sum(), min=1.0)
        metrics = AsyncMetrics(
            loss=(out.loss * trains_f).sum() / n_trained,
            accuracy=(out.accuracy * trains_f).sum() / n_trained,
            num_arrived=n_arrived,
            staleness_mean=(staleness * arrived_f).sum() / torch.clamp(n_arrived, min=1.0),
            update_norm=tree_norm(mean_delta),
            per_client_loss=out.loss * trains_f,
        )
        new_state = AsyncState(
            params=new_params,
            batch_stats=new_stats,
            client_params=pull(out.params, new_params),
            client_stats=pull(out.batch_stats, new_stats),
            base_params=pull(state.base_params, new_params),
            base_stats=pull(state.base_stats, new_stats),
            opt_state=out.opt_state,
            client_rng=state.client_rng,
            base_version=torch.where(arrive, torch.full_like(state.base_version, new_version), state.base_version),
            version=new_version,
            pending=(state.pending | trains) & ~arrive,
            server_opt_state=new_server,
            last_client_loss=torch.where(trains, out.loss.float(), state.last_client_loss),
        )
        return new_state, metrics

    return step


def make_multi_async_step(
    model: nn.Module,
    cfg: RoundConfig,
    num_ticks: int,
    staleness_power: float = 0.5,
    staleness_damping: bool = True,
):
    """``num_ticks`` ticks with no host sync between them (fedtpu's
    ``lax.scan`` of ticks): ``multi(state, window, has_data, weights,
    arrive [ticks, clients], alive [ticks, clients], generator=None) ->
    (state, metrics stacked [ticks, ...])``, ``window(version) -> (x, y)``
    the tick's data."""
    body = make_async_step(model, cfg, staleness_power, staleness_damping)

    def multi(state, window, has_data, weights, arrive, alive, generator=None):
        per_tick = []
        for t in range(num_ticks):
            x, y = window(state.version)
            state, m = body(state, x, y, has_data, weights, arrive[t], alive[t], generator)
            per_tick.append(m)
        return state, AsyncMetrics(*(torch.stack(f) for f in zip(*per_tick)))

    return multi


class AsyncFederation:
    """The simulated asynchronous federation on one device (the engine
    twin of ``PrimaryServer.run_async``). The data pipeline is a delegate
    :class:`fedtpu_torch.core.engine.Federation`'s (the device-resident
    dataset, the assignment, the window), whose synchronous state is
    dropped after build so that no second ``[clients, ...]`` momentum stack
    stays on the device. ``speed_sigma``: the per-client arrival
    propensities, log-normal(0, sigma), drawn once from the seed; 0 is
    homogeneous. Runs on CUDA unless ``device`` names another."""

    def __init__(
        self,
        cfg: RoundConfig,
        seed: int = 0,
        buffer_k: int = 2,
        staleness_power: float = 0.5,
        speed_sigma: float = 0.0,
        data: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        mesh=None,
        staleness_damping: bool = True,
        device=None,
    ):
        from fedtpu_torch.core.engine import Federation

        if mesh is not None:
            raise not_ported("AsyncFederation(mesh=...), the ticks over a device mesh", "slice 8, part 6")
        _validate(cfg)
        if not 1 <= buffer_k <= cfg.fed.num_clients:
            raise ValueError(f"buffer_k must be in [1, num_clients], got {buffer_k}")
        self.cfg = cfg
        self.buffer_k = buffer_k
        self.staleness_power = staleness_power
        self.staleness_damping = staleness_damping
        self._fed = Federation(cfg, seed=seed, data=data, device=device)
        self.device = self._fed.device
        self.model = self._fed.model
        g = self._fed.state
        self._server_opt = server_opt.make_server_optimizer(cfg.fed)
        self.state = init_async_state(cfg, g.params, g.batch_stats)
        self._fed._state = None
        self._step = make_async_step(self.model, cfg, staleness_power, staleness_damping)
        rng = np.random.default_rng(seed + 0xA5)
        self._speeds = np.exp(rng.normal(0.0, speed_sigma, size=cfg.fed.num_clients))
        self._arrival_rng = np.random.default_rng(cfg.data.seed * 6151 + seed)
        self.alive = self._fed.alive  # shared with the delegate
        self._tick_host = 0
        # One registry and one status board with the delegate, whichever
        # loop drives; the board's role says which one does.
        self.telemetry = self._fed.telemetry
        self.status = self._fed.status
        self.status.update(role="async_engine")

    # ------------------------------------------------------------- schedule
    def _arrive_mask(self) -> np.ndarray:
        """This tick's ``buffer_k`` arrivals among the live clients, drawn
        in proportion to speed (all of them when fewer are live), fedtpu's
        numpy draw."""
        live = np.flatnonzero(self.alive)
        arrive = np.zeros((self.cfg.fed.num_clients,), bool)
        if len(live) == 0:
            return arrive
        k = min(self.buffer_k, len(live))
        p = self._speeds[live] / self._speeds[live].sum()
        chosen = self._arrival_rng.choice(live, size=k, replace=False, p=p)
        arrive[chosen] = True
        return arrive

    def _window(self, offsets=None, keys=None):
        """``version -> (x, y)``, with injected offsets or keys (each a
        list indexed from the first tick, or one value for one tick)."""
        first = self.state.version

        def window(version):
            i = version - first
            off = offsets[i] if offsets is not None else None
            k = keys[i] if keys is not None else None
            return self._fed.window(version, off, k)

        return window

    # ---------------------------------------------------------------- ticks
    def tick(self, offset: Optional[int] = None, keys: Optional[torch.Tensor] = None) -> AsyncMetrics:
        """One server update: everyone who can trains, ``buffer_k``
        clients report. ``offset``/``keys``: the tick's presharded offset
        or gather keys instead of the engine's draw."""
        self.status.update(round=self._tick_host, phase="async_tick")
        with self.telemetry.span("async_tick", tick=self._tick_host):
            x, y = self._fed.window(self.state.version, offset, keys)
            arrive = torch.from_numpy(self._arrive_mask()).to(self.device)
            alive = torch.from_numpy(self.alive.copy()).to(self.device)
            self.state, m = self._step(
                self.state, x, y, self._fed._has_data, self._fed.weights, arrive, alive, self._fed._generator
            )
        self._tick_host += 1
        self.status.update(round=self._tick_host, phase="idle")
        self.telemetry.counter(
            "fedtpu_async_updates_total",
            "simulated FedBuff server updates dispatched",
        ).inc()
        return m

    def run_on_device(self, num_ticks: int, offsets=None, keys=None) -> AsyncMetrics:
        """``num_ticks`` server updates with no host sync between them: the
        arrivals of every tick drawn first, the live set fixed for the
        block; metrics come back stacked ``[num_ticks, ...]`` on the
        device. ``offsets``/``keys``: one per tick, injected."""
        if num_ticks < 1:
            raise ValueError(f"num_ticks must be >= 1, got {num_ticks}")
        n = self.cfg.fed.num_clients
        arrive = np.stack([self._arrive_mask() for _ in range(num_ticks)])
        alive = np.broadcast_to(self.alive.copy(), (num_ticks, n)).copy()
        multi = make_multi_async_step(self.model, self.cfg, num_ticks, self.staleness_power, self.staleness_damping)
        self.status.update(round=self._tick_host, phase="fused_ticks", fused_block=num_ticks)
        with self.telemetry.span("fused_ticks", tick=self._tick_host, num_ticks=num_ticks):
            self.state, m = multi(
                self.state, self._window(offsets, keys), self._fed._has_data, self._fed.weights,
                torch.from_numpy(arrive).to(self.device), torch.from_numpy(alive).to(self.device),
                self._fed._generator,
            )
        self._tick_host += num_ticks
        self.status.update(round=self._tick_host, phase="idle")
        self.telemetry.counter(
            "fedtpu_async_updates_total",
            "simulated FedBuff server updates dispatched",
        ).inc(num_ticks)
        return m

    # ----------------------------------------------------- checkpoint/resume
    @property
    def generation(self) -> AsyncState:
        """The whole resumable state as a host tree in fedtpu's
        ``AsyncState`` layout, what a checkpoint of the engine holds: flax
        names and layouts (every stack with its leading clients axis), the
        momentum as ``{"momentum": tree}`` (bf16 momentum as flax's
        ``"bfloat16"`` arrays), the server optimizer's state as optax keeps
        it. One leaf differs from fedtpu's: ``client_rng`` holds the state
        of the engine's ``torch.Generator`` (uint8), where fedtpu keeps
        ``[clients, 2]`` threefry keys. The arrival draws stay out, as in
        fedtpu: they model the clients' timing, which a restart redraws."""
        s = self.state
        return AsyncState(
            params=to_flax(s.params),
            batch_stats=to_flax(s.batch_stats),
            client_params=to_flax(s.client_params),
            client_stats=to_flax(s.client_stats),
            base_params=to_flax(s.base_params),
            base_stats=to_flax(s.base_stats),
            opt_state={"momentum": to_flax(s.opt_state)},
            client_rng=self._fed._generator.get_state().numpy(),
            base_version=s.base_version.cpu().numpy().astype(np.int32),
            version=np.asarray(s.version, np.int32),
            pending=s.pending.cpu().numpy(),
            server_opt_state=server_opt.to_flax_state(self._server_opt, s.server_opt_state),
            last_client_loss=s.last_client_loss.detach().cpu().numpy(),
        )

    @generation.setter
    def generation(self, g) -> None:
        """Install a restored :attr:`generation`: every leaf to the
        engine's device in the engine's names and dtypes, the version
        re-synced and the generator's state restored."""
        g = AsyncState(*g)
        dev, s = self.device, self.state

        def like(old: Tree, tree) -> Tree:
            new = from_flax(tree, device=dev)
            return {k: new[k].to(old[k].dtype) for k in old}

        self.state = AsyncState(
            params=like(s.params, g.params),
            batch_stats=like(s.batch_stats, g.batch_stats),
            client_params=like(s.client_params, g.client_params),
            client_stats=like(s.client_stats, g.client_stats),
            base_params=like(s.base_params, g.base_params),
            base_stats=like(s.base_stats, g.base_stats),
            # fedtpu's host state holds an SGDState named tuple, a restored
            # generation the dict it is written as.
            opt_state=like(s.opt_state, g.opt_state["momentum"] if isinstance(g.opt_state, dict)
                           else g.opt_state.momentum),
            client_rng=(),
            base_version=torch.tensor(np.asarray(g.base_version, np.int32), device=dev),
            version=int(np.asarray(g.version)),
            pending=torch.tensor(np.asarray(g.pending, bool), device=dev),
            server_opt_state=server_opt.from_flax_state(self._server_opt, g.server_opt_state, dev),
            last_client_loss=torch.tensor(np.asarray(g.last_client_loss, np.float32), device=dev),
        )
        self._fed._generator.set_state(torch.from_numpy(np.array(g.client_rng, np.uint8)))

    def load_state(self, tree) -> None:
        """fedtpu's name for installing a restored :attr:`generation` (a
        host tree from :mod:`fedtpu_torch.checkpoint`)."""
        self.generation = tree

    # ----------------------------------------------------------------- eval
    def evaluate(self, images: np.ndarray, labels: np.ndarray) -> Tuple[float, float]:
        """Loss and accuracy of the current global model."""
        xs, ys = batch_eval_arrays(images, labels, self.cfg.data.eval_batch_size)
        loss, acc = self._fed._evaluate(
            self.state.params,
            self.state.batch_stats,
            torch.from_numpy(np.asarray(xs, np.float32)).to(self.device),
            torch.from_numpy(np.asarray(ys, np.int64)).to(self.device),
        )
        return float(loss), float(acc)

    def status_snapshot(self) -> dict:
        """The ``/statusz`` feed, as :meth:`Federation.status_snapshot`
        gives it for the synchronous loop (the ``trace_id`` under trace)."""
        snap = self.status.snapshot()
        snap["alive"] = self.alive.tolist()
        if self.telemetry.tracer is not None:
            snap["trace_id"] = self.telemetry.tracer.trace_id
        return snap

    def set_alive(self, client: int, alive: bool) -> None:
        self.alive[client] = alive

    @property
    def data_source(self) -> str:
        return self._fed.data_source
