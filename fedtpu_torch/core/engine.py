"""The federated training engine: the port of ``fedtpu.core.engine.Federation``.

Builds the model, data, partition and round step from a
:class:`fedtpu_torch.config.RoundConfig` and drives rounds on one device.
The dataset goes to the device once, in the compute dtype and the layout
``DataConfig.device_layout`` names (:mod:`fedtpu_torch.data.device`):
presharded, where each round takes one window per client, or gather, where
each round gathers its batches by index. A presharded layout that would
store more than twice the balanced footprint falls back to gather with a
warning, as fedtpu's engine does. The client assignment is a partition
(round_robin, iid, Dirichlet label skew) or the caller's ``(idx, mask)``;
a round's participants are a seeded draw, uniform or in proportion to the
clients' last losses; seeded attackers take their seats at build time.
:attr:`Federation.generation` is the engine's checkpoint, fedtpu's
``FederatedState`` layout on the host; assigning a restored one resumes
the run where it stopped. Under ``FedConfig.telemetry='basic'`` it counts
rounds into :attr:`Federation.telemetry`'s registry and keeps a
:class:`~fedtpu_torch.obs.StatusBoard` for ``/statusz``, as fedtpu's
engine does; under ``'trace'`` each :meth:`Federation.step` is a ``round``
span and each :meth:`Federation.run_on_device` block a ``fused_rounds``
span, whose ``torch.profiler.record_function`` ranges hold the kernels
they launch. :meth:`Federation.enable_mfu_accounting` arms fedtpu's
per-round MFU accounting (:mod:`fedtpu_torch.obs.profile`). The engine
runs on CUDA unless the caller names another device: without a card and
without ``device="cpu"`` it raises, it never falls back to the CPU.
"""

from __future__ import annotations

import time
import warnings
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from fedtpu_torch import models
from fedtpu_torch.config import RoundConfig, not_ported, resolve_compute_dtype, screening_enabled, validate
from fedtpu_torch.convert import from_flax, to_flax
from fedtpu_torch.core import server_opt
from fedtpu_torch.core.client import batch_eval_arrays, make_eval_fn
from fedtpu_torch.core.round import (
    FederatedState,
    RoundBatch,
    RoundDraws,
    RoundMetrics,
    init_state,
    make_round_step,
)
from fedtpu_torch.data import datasets, device as device_data, partition
from fedtpu_torch.obs import StatusBoard, Telemetry
from fedtpu_torch.ops.compression import Compressor, make_compressor
from fedtpu_torch.sim import adversary
from fedtpu_torch.sim.sampling import loss_weights
from fedtpu_torch.utils.metrics import MetricsLogger


class EngineGeneration(NamedTuple):
    """An engine's checkpoint: fedtpu's ``FederatedState`` fields, in its
    order, as host arrays (:attr:`Federation.generation`)."""

    params: dict
    batch_stats: dict
    opt_state: dict
    client_rng: np.ndarray
    round_idx: np.ndarray
    comp_state: object = ()
    server_opt_state: object = ()
    last_client_loss: object = ()


def _on_device(x, device: torch.device):
    """Every tensor of a state (dicts, tuples, named tuples) on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: _on_device(v, device) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_on_device(v, device) for v in x])
    if isinstance(x, tuple):
        return tuple(_on_device(v, device) for v in x)
    return x


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fedtpu_torch runs on a CUDA device and none is available; pass "
            "device='cpu' explicitly to run the plain CPU path"
        )
    return dev


class Federation:
    """Synchronous FedAvg over simulated clients on one device."""

    def __init__(
        self,
        cfg: RoundConfig,
        seed: int = 0,
        compressor: Optional[Compressor] = None,
        data: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        mesh=None,
        assignment: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        device=None,
        draws: Optional[RoundDraws] = None,
    ):
        """fedtpu's arguments in fedtpu's order, then the port's own.
        ``compressor``: a codec instead of the one ``cfg.fed.compression``
        names. ``data``: ``(images, labels)`` instead of loading
        ``cfg.data.dataset``. ``mesh``: not ported (ROADMAP.md item 6).
        ``assignment``: the client→example map ``(idx, mask)``, each
        ``[num_clients, shard_len]``, instead of ``cfg.data.partition``'s.
        ``device``: where the rounds run (CUDA unless the caller says
        otherwise). ``draws``: the round's seeded draws replaced
        (:class:`fedtpu_torch.core.round.RoundDraws`)."""
        if mesh is not None:
            raise not_ported("Federation(mesh=...), the rounds over a device mesh", "slice 8, part 6")
        validate(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        shape, n_classes = datasets.dataset_info(cfg.data.dataset)
        if cfg.num_classes != n_classes:
            raise ValueError(
                f"cfg.num_classes={cfg.num_classes} but dataset "
                f"'{cfg.data.dataset}' has {n_classes} classes"
            )
        if compressor is None:
            compressor = make_compressor(cfg.fed)
        self._steps = cfg.steps_per_round * max(1, cfg.fed.local_epochs)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.model = models.create(cfg.model, cfg.num_classes, shape, remat=cfg.remat)
        self.model.to(self.device)

        if data is None:
            images, labels = datasets.load(
                cfg.data.dataset, "train", seed=cfg.data.seed, num=cfg.data.num_examples
            )
            self._data_source = datasets.data_source(cfg.data.dataset, "train")
        else:
            images, labels = data
            self._data_source = "caller"
        self.images, self.labels = images, labels
        n = cfg.fed.num_clients
        if assignment is not None:
            idx, mask = np.asarray(assignment[0]), np.asarray(assignment[1])
            if idx.shape[0] != n or idx.shape != mask.shape:
                raise ValueError(
                    f"assignment must be [num_clients={n}, shard_len] "
                    f"idx/mask pairs, got {idx.shape} vs {mask.shape}"
                )
        elif cfg.data.partition == "round_robin":
            idx, mask = partition.round_robin(len(images), n, cfg.data.batch_size)
        elif cfg.data.partition == "iid":
            idx, mask = partition.iid(len(images), n, seed=cfg.data.seed)
        else:
            idx, mask = partition.dirichlet(
                labels, n, alpha=cfg.data.dirichlet_alpha, seed=cfg.data.seed
            )
        self.client_idx, self.client_mask = idx, mask
        self.weights = torch.tensor(partition.shard_sizes(mask), device=self.device)
        self._has_data = torch.tensor(mask.any(axis=1), device=self.device)

        # Seeded attackers: the seat is the client, so the attacker mask is
        # fixed for the run. label_flip poisons the attackers' labels here,
        # once; the other attacks act on the deltas in the round.
        self._attack_plan = None
        self._attack_seats = None
        self._attack_seats_dev = ()
        # With a population (the sim engine) the attackers are population
        # clients: SimFederation poisons their rows and seats them.
        if cfg.fed.sim.malicious_fraction > 0:
            plan = adversary.parse_attack(cfg.fed.sim.attack)
            self._attack_plan = plan
            if cfg.fed.sim.population <= 0:
                amask = adversary.attacker_mask(
                    n, cfg.fed.sim.malicious_fraction, cfg.data.seed + cfg.fed.sim.seed + plan.seed
                )
                self.attacker_clients = amask
                if plan.kind == "label_flip":
                    self.labels = adversary.flip_labels(
                        labels, idx, mask, amask, plan.label_offset, cfg.num_classes
                    )
                else:
                    self._attack_seats = amask.astype(np.float32)
                    self._attack_seats_dev = torch.tensor(self._attack_seats, device=self.device)

        self._state: FederatedState = init_state(self.model, cfg, compressor)
        self._server_opt = server_opt.make_server_optimizer(cfg.fed)
        self._round_step = make_round_step(self.model, cfg, compressor, draws)
        self._shuffle = cfg.data.partition != "round_robin"
        self.layout = cfg.data.device_layout
        footprint = 2 * n * idx.shape[1]
        if self.layout == "presharded" and footprint > 4 * len(images):
            # clients * 2L rows, L the longest shard: a skewed partition
            # would store far more than the balanced case's twice the data.
            warnings.warn(
                f"device_layout='presharded' would store "
                f"{footprint / len(images):.1f}x the dataset (skewed "
                f"partition: max shard {idx.shape[1]} of {len(images)} "
                f"examples x {n} clients); falling back to 'gather'",
                stacklevel=2,
            )
            self.layout = "gather"
        self._device_data = None
        self._generator = torch.Generator(self.device).manual_seed(seed)
        self._evaluate = make_eval_fn(self.model)
        self.alive = np.ones((n,), bool)
        self._alive_dev = None  # (mask bytes, device tensor)
        self.history = []
        # Host-side telemetry; swappable after construction (the round
        # programs never close over it).
        self.telemetry = Telemetry(cfg.fed.telemetry, role="engine")
        # The /statusz feed: one locked dict merge per update.
        self.status = StatusBoard(role="engine", phase="init", round=0, num_clients=n)
        # Per-round MFU accounting, armed by enable_mfu_accounting() (it
        # runs a round to count it); a process's CompileWatcher, handed
        # over by its owner. Both feed /statusz when present.
        self.profiler = None
        self.compile_watcher = None

    # ------------------------------------------------------------- data
    def _ensure_device_data(self):
        """``(images, labels)`` on the device in the compute dtype:
        presharded ``[clients, 2L, F]`` rows, or the flat ``[N, F]`` set
        with the assignment ``(idx, mask)`` for the gather layout."""
        if self._device_data is None:
            store = getattr(torch, resolve_compute_dtype(self.cfg))
            if self.layout == "presharded":
                xs, ys = device_data.preshard_arrays(
                    self.images, self.labels, self.client_idx, self.client_mask
                )
                assign = ()
            else:
                xs = np.asarray(self.images, np.float32).reshape(len(self.images), -1)
                ys = np.asarray(self.labels, np.int32)
                assign = (
                    torch.from_numpy(np.asarray(self.client_idx, np.int64)).to(self.device),
                    torch.from_numpy(self.client_mask).to(self.device),
                )
            self._device_data = (
                torch.from_numpy(xs).to(self.device).to(store),
                torch.from_numpy(ys).to(self.device),
            ) + assign
        return self._device_data

    def set_assignment(
        self, idx: np.ndarray, mask: np.ndarray, weights: Optional[np.ndarray] = None
    ) -> None:
        """Swap the client→example assignment in place, at the same shapes,
        as fedtpu's ``set_assignment``: gather layout only (presharded
        bakes the assignment into the uploaded rows). ``weights``: the
        clients' weights, by default their example counts."""
        if self.layout != "gather":
            raise ValueError(
                "set_assignment requires device_layout='gather' (presharded "
                "bakes the assignment into the uploaded data rows)"
            )
        idx = np.asarray(idx, np.int32)
        mask = np.asarray(mask, bool)
        if idx.shape != self.client_idx.shape or mask.shape != idx.shape:
            raise ValueError(
                f"assignment shape {idx.shape} must match the engine's "
                f"{self.client_idx.shape} (static program shapes)"
            )
        self.client_idx, self.client_mask = idx, mask
        w = partition.shard_sizes(mask) if weights is None else weights
        self.weights = torch.tensor(np.asarray(w, np.float32), device=self.device)
        self._has_data = torch.tensor(mask.any(axis=1), device=self.device)
        if self._device_data is not None:
            images, labels = self._device_data[:2]
            self._device_data = (
                images,
                labels,
                torch.from_numpy(idx.astype(np.int64)).to(self.device),
                torch.from_numpy(mask).to(self.device),
            )

    def _alive_for_round(self, round_idx: int, losses: Optional[np.ndarray] = None) -> np.ndarray:
        """Alive clients, subsampled to ``participation_fraction`` with the
        same seeded numpy draw as fedtpu: uniform, or with
        ``participation_sampling='loss'`` in proportion to each client's
        last loss (``losses``, else read from the state), uniform until a
        loss has been observed."""
        alive = self.alive.copy()
        frac = self.cfg.fed.participation_fraction
        if frac < 1.0:
            rng = np.random.default_rng(self.cfg.data.seed * 7919 + round_idx)
            live = np.flatnonzero(alive)
            k = max(1, int(round(frac * len(live))))
            p = None
            if self.cfg.fed.participation_sampling == "loss":
                if losses is None:
                    losses = self._state.last_client_loss.cpu().numpy()
                p = loss_weights(np.asarray(losses)[live])
            keep = rng.choice(live, size=k, replace=False, p=p)
            alive = np.zeros_like(alive)
            alive[keep] = True
        return alive

    def _loss_sampled(self) -> bool:
        fed = self.cfg.fed
        return fed.participation_fraction < 1.0 and fed.participation_sampling == "loss"

    def _alive_tensor(self, round_idx: int, losses: Optional[np.ndarray] = None) -> torch.Tensor:
        # Re-upload only when the mask changes: a host-to-device copy from
        # pageable memory waits for the device.
        alive = self._alive_for_round(round_idx, losses)
        key = alive.tobytes()
        if self._alive_dev is None or self._alive_dev[0] != key:
            self._alive_dev = (key, torch.tensor(alive, device=self.device))
        return self._alive_dev[1]

    def device_batch(
        self,
        round_idx: int,
        offset: Optional[int] = None,
        keys: Optional[torch.Tensor] = None,
        losses: Optional[np.ndarray] = None,
    ) -> RoundBatch:
        """Round ``round_idx``'s batch from the device-resident data.
        ``offset`` overrides the presharded layout's rotation offset,
        ``keys`` the gather layout's ``[clients, shard_len]`` sort keys;
        ``losses`` are the last losses loss-proportional sampling draws
        from (by default read from the state)."""
        x, y = self.window(round_idx, offset, keys)
        return RoundBatch(
            x=x,
            y=y,
            step_mask=self._has_data[:, None].expand(self.cfg.fed.num_clients, self._steps),
            weights=self.weights,
            alive=self._alive_tensor(round_idx, losses),
            attack_seats=self._attack_seats_dev,
        )

    def window(
        self, round_idx: int, offset: Optional[int] = None, keys: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Round ``round_idx``'s ``(x, y)`` from the device-resident data:
        the presharded rotation at ``offset``, or the gather by the sort
        ``keys`` (each by default the round's seeded draw)."""
        data = self._ensure_device_data()
        shape, batch = tuple(self.images.shape[1:]), self.cfg.data.batch_size
        if self.layout == "presharded":
            images, labels = data
            if offset is None:
                offset = device_data.round_offset(
                    labels.shape[1] // 2, self._shuffle, self.cfg.data.seed, round_idx
                )
            return device_data.presharded_window(images, labels, offset, self._steps, batch, shape)
        images, labels, idx, mask = data
        if keys is None and self._shuffle:
            keys = device_data.round_keys(tuple(idx.shape), self.cfg.data.seed, round_idx, self.device)
        take = device_data.round_take_indices(
            idx, mask, self._steps * batch, None if keys is None else keys.to(self.device),
        )
        return device_data.gather_window(images, labels, take, self._steps, batch, shape)

    def round_batch(self, round_idx: int) -> RoundBatch:
        """Round ``round_idx``'s batch built on the host, as fedtpu's
        ``round_batch`` builds it (:func:`fedtpu_torch.data.partition.
        make_client_batches`, seeded ``data.seed + round_idx``), then moved
        to the device. For tests and callers that inject batches; the
        rounds themselves take :meth:`device_batch`."""
        cfg = self.cfg
        x, y, step_mask = partition.make_client_batches(
            self.images, self.labels, self.client_idx, self.client_mask,
            cfg.data.batch_size, self._steps, seed=cfg.data.seed + round_idx,
            shuffle=cfg.data.partition != "round_robin",
        )
        dev = self.device
        return RoundBatch(
            x=torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev),
            y=torch.from_numpy(np.asarray(y)).to(dev),
            step_mask=torch.from_numpy(step_mask).to(dev),
            weights=self.weights,
            alive=torch.from_numpy(self._alive_for_round(round_idx)).to(dev),
            attack_seats=self._attack_seats_dev,
        )

    @property
    def data_source(self) -> str:
        """'disk' | 'synthetic' | 'caller': where the training data came
        from, recorded at construction."""
        return self._data_source

    # ------------------------------------------------------------ state
    @property
    def state(self) -> FederatedState:
        """The cross-round state on the engine's device."""
        return self._state

    @state.setter
    def state(self, s: FederatedState) -> None:
        # A state built elsewhere (on the host, by a test) moves to the
        # engine's device; the round counter is its host int.
        self._state = _on_device(s, self.device)

    @property
    def generation(self) -> "EngineGeneration":
        """The whole resumable state as a host tree in fedtpu's
        ``FederatedState`` layout, what a checkpoint of the engine holds
        (:mod:`fedtpu_torch.checkpoint`): flax names and layouts, the
        momentum as ``{"momentum": tree}`` (bf16 momentum as flax's
        ``"bfloat16"`` arrays), the codec residuals per leaf or as
        the flat ``[clients, P]`` row, the server optimizer's state as optax
        keeps it. One leaf differs from fedtpu's: ``client_rng`` holds the
        state of the engine's ``torch.Generator`` (uint8), where fedtpu keeps
        ``[clients, 2]`` threefry keys; every round draws from that one
        generator, so a resume that did not restore it would draw another
        trajectory."""
        s = self._state
        comp = s.comp_state
        if isinstance(comp, torch.Tensor):
            comp = comp.detach().cpu().numpy()
        elif comp:
            comp = to_flax(comp)
        return EngineGeneration(
            params=to_flax(s.params),
            batch_stats=to_flax(s.batch_stats),
            opt_state={"momentum": to_flax(s.opt_state)},
            client_rng=self._generator.get_state().numpy(),
            round_idx=np.asarray(s.round_idx, np.int32),
            comp_state=comp,
            server_opt_state=server_opt.to_flax_state(self._server_opt, s.server_opt_state),
            last_client_loss=s.last_client_loss.detach().cpu().numpy(),
        )

    @generation.setter
    def generation(self, g: "EngineGeneration") -> None:
        """Install a restored :attr:`generation`: every leaf to the engine's
        device in the engine's own names, order and dtypes, the round
        counter re-synced and the generator's state restored."""
        dev, s = self.device, self._state

        def like(old: dict, tree) -> dict:
            new = from_flax(tree, device=dev)
            return {k: new[k].to(old[k].dtype) for k in old}

        comp = g.comp_state
        if isinstance(s.comp_state, torch.Tensor):
            comp = torch.tensor(np.asarray(comp), device=dev)
        elif s.comp_state:
            comp = like(s.comp_state, comp)
        else:
            comp = ()
        self._state = FederatedState(
            params=like(s.params, g.params),
            batch_stats=like(s.batch_stats, g.batch_stats),
            opt_state=like(s.opt_state, g.opt_state["momentum"]),
            round_idx=int(np.asarray(g.round_idx)),
            comp_state=comp,
            server_opt_state=server_opt.from_flax_state(self._server_opt, g.server_opt_state, dev),
            last_client_loss=torch.tensor(np.asarray(g.last_client_loss, np.float32), device=dev),
        )
        self._generator.set_state(torch.from_numpy(np.array(g.client_rng, np.uint8)))

    # ----------------------------------------------------------- rounds
    def step(self, batch: Optional[RoundBatch] = None) -> RoundMetrics:
        """One round, on ``batch`` or on the device-resident data."""
        r = self._state.round_idx
        self.status.update(round=r, phase="round")
        t0 = time.perf_counter()
        with self.telemetry.span("round", round=r):
            metrics = self._step_impl(batch)
            if self.profiler is not None:
                self._sync()
        if self.profiler is not None:
            self.profiler.observe_round(time.perf_counter() - t0)
        self.status.update(round=r + 1, phase="idle")
        self.telemetry.counter(
            "fedtpu_rounds_completed_total",
            "simulated FedAvg rounds dispatched by this engine",
        ).inc()
        return metrics

    def _step_impl(self, batch: Optional[RoundBatch] = None) -> RoundMetrics:
        if batch is None:
            batch = self.device_batch(self._state.round_idx)
        self._state, metrics = self._round_step(self._state, batch, self._generator)
        return metrics

    def run_on_device(self, num_rounds: int) -> RoundMetrics:
        """``num_rounds`` rounds with no host sync between them; metrics
        come back stacked ``[num_rounds, ...]`` on the device. Loss-
        proportional sampling draws every round's participants from the
        losses known when the block starts (one device read a call), as
        fedtpu's fused block does."""
        if num_rounds < 1:
            raise ValueError(f"num_rounds must be >= 1, got {num_rounds}")
        r = self._state.round_idx
        self.status.update(round=r, phase="fused_rounds", fused_block=num_rounds)
        t0 = time.perf_counter()
        with self.telemetry.span("fused_rounds", round=r, num_rounds=num_rounds):
            losses = self._state.last_client_loss.cpu().numpy() if self._loss_sampled() else None
            per_round = [self._step_impl(self.device_batch(r + i, losses=losses)) for i in range(num_rounds)]
            if self.profiler is not None:
                self._sync()
        if self.profiler is not None:
            self.profiler.observe_round(time.perf_counter() - t0, rounds=num_rounds)
        self.status.update(round=r + num_rounds, phase="idle")
        self.telemetry.counter(
            "fedtpu_rounds_completed_total",
            "simulated FedAvg rounds dispatched by this engine",
        ).inc(num_rounds)
        return RoundMetrics(*(torch.stack(f) for f in zip(*per_round)))

    def run(
        self,
        num_rounds: Optional[int] = None,
        logger: Optional[MetricsLogger] = None,
        eval_every: int = 0,
        eval_data: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    ) -> RoundMetrics:
        """Rounds with fedtpu's per-round record, kept in ``self.history``
        and passed to ``logger``: ``loss``, ``acc``, ``active``,
        ``worst_client_loss``, ``round_s``, ``dataset``, ``data_source``;
        ``screened`` (rows rejected) when screening is armed;
        ``attackers_fired`` when an attack is; ``achieved_flops_per_s``
        and ``mfu`` under MFU accounting; ``test_loss`` and
        ``test_acc`` every ``eval_every`` rounds on ``eval_data``. Reading
        the record syncs with the device each round."""
        if num_rounds is None:
            num_rounds = self.cfg.fed.num_rounds
        metrics = None
        self.eval_history = []
        screen_on = screening_enabled(self.cfg.fed.screen)
        for r in range(num_rounds):
            t0 = time.perf_counter()
            ridx = self._state.round_idx
            metrics = self.step()
            rec = {
                "loss": float(metrics.loss),
                "acc": float(metrics.accuracy),
                "active": float(metrics.num_active),
                # The worst live client: a diverging or poisoned client
                # shows here rounds before it moves the mean.
                "worst_client_loss": float(metrics.per_client_loss.max()),
            }
            rec["round_s"] = time.perf_counter() - t0
            rec["dataset"] = self.cfg.data.dataset
            rec["data_source"] = self._data_source
            self.telemetry.histogram(
                "fedtpu_round_wall_seconds",
                "per-round host wall time (dispatch + sync)",
            ).observe(rec["round_s"])
            if self.profiler is not None:
                # step() observed this round; the record carries the same
                # figures (none where they cannot be derived).
                rec.update(self.profiler.record_fields())
            if screen_on:
                rec["screened"] = int(metrics.screened.sum())
                if rec["screened"]:
                    self.telemetry.counter(
                        "fedtpu_screening_rejected_total",
                        "client rows rejected by the fused screening "
                        "stage, by surface",
                        labels={"surface": "engine"},
                    ).inc(rec["screened"])
            if self._attack_plan is not None:
                if self._attack_seats is not None:
                    fired = adversary.fires_this_round(self._attack_plan, self._attack_seats, ridx)
                    rec["attackers_fired"] = int(fired.sum())
                else:  # label_flip: the poisoned shards train every round
                    rec["attackers_fired"] = int(self.attacker_clients.sum())
                if rec["attackers_fired"]:
                    self.telemetry.counter(
                        "fedtpu_attack_injected_total",
                        "model/data-level attacks executed by seeded "
                        "adversarial clients, by kind",
                        labels={"kind": self._attack_plan.kind},
                    ).inc(rec["attackers_fired"])
            if eval_every and (r + 1) % eval_every == 0 and eval_data is not None:
                rec["test_loss"], rec["test_acc"] = self.evaluate(*eval_data)
                self.eval_history.append((r, rec["test_loss"], rec["test_acc"]))
            self.history.append({"round": ridx, **rec})
            if logger is not None:
                logger.log(r, **rec)
        return metrics

    # ------------------------------------------------------------- eval
    def evaluate(self, images: np.ndarray, labels: np.ndarray) -> Tuple[float, float]:
        """Loss and accuracy of the global model on ``(images, labels)``."""
        xs, ys = batch_eval_arrays(images, labels, self.cfg.data.eval_batch_size)
        loss, acc = self._evaluate(
            self._state.params,
            self._state.batch_stats,
            torch.from_numpy(np.asarray(xs, np.float32)).to(self.device),
            torch.from_numpy(np.asarray(ys, np.int64)).to(self.device),
        )
        return float(loss), float(acc)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def enable_mfu_accounting(self, xla_check: bool = True):
        """Arm per-round MFU accounting: the round gauges and the records'
        ``achieved_flops_per_s`` and ``mfu`` (:class:`fedtpu_torch.obs.
        RoundProfiler`). Builds the cost model now by running the next
        round once on a copy of the state and the generator (:func:`fedtpu_
        torch.obs.profile.engine_cost_model`; it counts every local step,
        where fedtpu counts one). Armed, :meth:`step` and
        :meth:`run_on_device` wait for the device before they read the
        wall, where fedtpu reads it after the dispatch: a wall that ends
        before the kernels do would overstate the FLOP rate. ``xla_check``
        is fedtpu's argument and changes nothing. Returns the profiler."""
        from fedtpu_torch.obs.profile import RoundProfiler, engine_cost_model

        if self.profiler is None:
            kind = torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else "cpu"
            profiler = RoundProfiler(self.telemetry, n_devices=1, device_kind=kind)
            profiler.set_cost_model(engine_cost_model(self, xla_check=xla_check))
            self.profiler = profiler
        return self.profiler

    def status_snapshot(self) -> dict:
        """The ``/statusz`` feed: the board's round and phase, the alive
        mask, under trace the tracer's ``trace_id``, and the ``perf`` and
        ``compile`` blocks when accounting is armed or a watcher handed
        over."""
        snap = self.status.snapshot()
        snap["alive"] = self.alive.tolist()
        if self.telemetry.tracer is not None:
            snap["trace_id"] = self.telemetry.tracer.trace_id
        if self.profiler is not None:
            snap["perf"] = self.profiler.snapshot()
        if self.compile_watcher is not None:
            snap["compile"] = self.compile_watcher.snapshot()
        return snap

    def set_alive(self, client: int, alive: bool) -> None:
        """Mark a simulated client dead or alive."""
        self.alive[client] = alive
