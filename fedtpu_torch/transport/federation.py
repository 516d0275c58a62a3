"""The distributed federation over the gRPC edge: the coordinator (a
primary and its backup), its membership gate, and the client agent it
drives.

The port of ``fedtpu.transport.federation``'s ``PrimaryServer``,
``BackupServer``, ``_MembershipGate``, ``ClientAgent`` and
``serve_client``. The topology is fedtpu's: a primary dials out to client
agents, each hosting a Trainer gRPC server, and replicates its state to a
backup that takes over when the primary goes silent. With ``tier_fanout``
the primary is the root of two tiers and dials out to
aggregators (:class:`~fedtpu_torch.transport.aggregator.AggregatorServer`)
instead.

- :class:`PrimaryServer` runs synchronous rounds: the initial sync, the
  StartTrain fan-out with retries, the collect (``barrier``: decoded rows
  kept on the host until the last reply; ``stream``: each row shipped to
  the card as it lands), the deadline with stragglers left alive, the
  quorum abort, screening with reputation and quarantine, the combine
  (:mod:`fedtpu_torch.transport.aggregation`), replication to the backup,
  then the broadcast. A heartbeat monitor revives and resyncs dead clients;
  fencing epochs keep a superseded coordinator from forking the lineage.
  It drives fedtpu clients and the port's alike, with fedtpu's payloads
  byte for byte (``model_bytes``, ``replica_bytes``). ``codec_policy=
  "adaptive"`` asks each client for the codec that is cheapest on its link
  (:mod:`~fedtpu_torch.transport.codec_policy`); as a root it pulls one
  pre-weighted partial sum an aggregator (SubmitPartial) and divides once.
  :meth:`PrimaryServer.start_gate` serves Join and Leave, which admit and
  resync, or evict, a member.
- :class:`BackupServer` absorbs the replica, answers the primary's pings,
  promotes to acting primary on its watchdog, and is demoted by the
  recovering primary's ping, which then fetches its state. While acting,
  Join and Leave land in the acting primary's roster; otherwise Join
  answers ``admitted=0``, ``"not primary"``.
- :class:`ClientAgent` / :func:`serve_client`: a client's servicer around
  :class:`~fedtpu_torch.transport.trainer.LocalTrainer`. StartTrain trains
  one round and replies with its payload, SendModel installs the global
  model and evaluates it, HeartBeat answers liveness. A coordinator RPC
  whose fencing epoch is below the highest this client has seen is aborted
  with ``FAILED_PRECONDITION`` and ``"STALE_COORDINATOR: ..."``.

The coordinator's tensors (the global model, the server optimizer's state,
the round's row buffer) live on the card unless ``device`` names another:
without a card it raises unless ``device="cpu"`` is passed. A reply is
decoded on the host into its row of the edge's flat layout (flax's order
and layout, :func:`fedtpu_torch.ops.flat.make_tree_layout`), so both
pipelines combine the same ``[k, P]`` rows, bit for bit. The global model
is replaced each round, never written in place, so the heartbeat's resync
can read it while a round aggregates.

A chaos schedule (``chaos=``, :mod:`fedtpu_torch.ft.chaos`) arms the
fault-injection interceptors on every channel a coordinator dials and on
every server it or a client hosts, and seeds the retries' jitter; its
attack rules make a client an attacker.

:meth:`PrimaryServer.run_async` is fedtpu's semi-asynchronous FedBuff
loop: a worker thread per seat, no barrier, an update every ``buffer_k``
replies (:func:`~fedtpu_torch.transport.aggregation.fedbuff_apply`).

The round record is API whatever ``telemetry`` says. Under ``basic`` each
component counts into its own :class:`~fedtpu_torch.obs.Telemetry`
registry under fedtpu's metric names, and the primary and the backup each
own a :class:`~fedtpu_torch.obs.FlightRecorder` (rounds, fences,
membership, failover) and a :class:`~fedtpu_torch.obs.StatusBoard`. Under
``trace`` the primary opens fedtpu's spans (``round``, ``collect``,
``client_rpc`` or ``submit_partial``, ``decode``, ``h2d``, ``screen``,
``aggregate``, ``replicate``, ``broadcast``, ``async_update``), feeds them
to its flight ring, and every RPC it dials carries its trace context
(:mod:`fedtpu_torch.obs.propagate`), which a client's ``client_train`` and
``install_global`` spans adopt.
"""

from __future__ import annotations

import json
import logging
import math
import os
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import grpc
import numpy as np
import torch

from fedtpu_torch import models
from fedtpu_torch.config import (
    RoundConfig,
    resolve_server_pipeline,
    screening_enabled,
    validate_coordinator,
    validate_screen_config,
    validate_tier_config,
)
from fedtpu_torch.core import server_opt
from fedtpu_torch.core.engine import resolve_device
from fedtpu_torch.core.round import warn_weighted_robust
from fedtpu_torch.data import datasets
from fedtpu_torch.ft import (
    FailoverStateMachine,
    HeartbeatMonitor,
    MembershipTable,
    PrimaryPinger,
    Role,
    WatchdogRunner,
)
from fedtpu_torch.obs import (
    Counter,
    FlightRecorder,
    StatusBoard,
    Telemetry,
    latency_summary,
    process_rss_bytes,
    propagate,
)
from fedtpu_torch.ops import flat as flat_ops
from fedtpu_torch.transport import aggregation, msgpack, proto, sparse, wire
from fedtpu_torch.transport.codec_policy import AdaptiveCodecPolicy
from fedtpu_torch.transport.retry import call_with_retry, is_stale_coordinator
from fedtpu_torch.transport.service import (
    TrainerServicer,
    TrainerStub,
    create_channel,
    create_server,
    probe,
    trace_context_of,
)
from fedtpu_torch.transport.trainer import LocalTrainer

__all__ = ["BackupServer", "ClientAgent", "LocalTrainer", "PrimaryServer", "serve_client"]

log = logging.getLogger("fedtpu_torch.federation")

Tree = Dict[str, Dict[str, torch.Tensor]]

# FSP1 record kind -> codec name, for the per-codec byte accounting; a
# dense FTP1 reply carries no kind and counts as "none".
_CODEC_OF_KIND = {
    "topk": "topk",
    "topk_flat": "topk",
    "int8": "int8",
    "int8_flat": "int8",
    "rotq_flat": "rotq",
    "randk_flat": "randk",
    "partial_flat": "partial",
}


def _sum_codec_bytes(pairs) -> Dict[str, int]:
    """Fold ``(codec name, bytes)`` pairs into ``{codec: total bytes}``."""
    out: Dict[str, int] = {}
    for codec_name, nb in pairs:
        out[codec_name] = out.get(codec_name, 0) + int(nb)
    return out


def _split_collections(leaves: Dict[str, torch.Tensor]) -> Tree:
    """``{"params.X": t, "batch_stats.Y": t}`` -> ``{"params": {"X": t},
    "batch_stats": {"Y": t}}``, both collections present."""
    out: Tree = {"params": {}, "batch_stats": {}}
    for name, t in leaves.items():
        col, rest = name.split(".", 1)
        out[col][rest] = t
    return out


# The server optimizer's state in fedtpu's optax layout (the replica's and
# the checkpoint's ``server_opt`` leaf).
_opt_state_to_flax = server_opt.to_flax_state
_opt_state_from_flax = server_opt.from_flax_state


# -------------------------------------------------------------------- primary
class PrimaryServer:
    """The FedAvg coordinator: per round, StartTrain(rank, world) to the
    live clients, the combine of their replies, replication to the backup,
    the broadcast. An RpcError marks a client dead; the heartbeat monitor
    revives and resyncs it."""

    def __init__(
        self,
        cfg: RoundConfig,
        clients: List[str],
        backup_address: Optional[str] = None,
        compress: bool = False,
        seed: int = 0,
        initial_model: Optional[bytes] = None,
        rpc_timeout: Optional[float] = None,
        round_deadline_s: Optional[float] = None,
        flight=None,
        chaos=None,
        device=None,
    ):
        """``round_deadline_s``: wait at most this long for the round's
        replies, then combine what arrived; stragglers stay alive (they
        still get the broadcast and rejoin), None waits for every reply.
        ``rpc_timeout`` overrides the data-plane deadlines of
        ``cfg.fed.retry``. ``initial_model``: a model or replica payload to
        start from (fedtpu's ``model_bytes()`` or ``replica_bytes()`` give
        the same start in both packages); without one the model is drawn
        from ``seed`` by torch. ``device``: where the coordinator's tensors
        live, CUDA unless named. ``chaos``: a :class:`fedtpu_torch.ft.chaos.
        FaultSchedule` whose interceptor every channel this server dials
        carries. ``flight``: the :class:`fedtpu_torch.obs.FlightRecorder`
        the round loop records into (one of its own when None)."""
        validate_coordinator(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.compress = compress
        self.round_deadline_s = round_deadline_s
        rp = cfg.fed.retry
        self.retry_policy = rp
        self._deadlines = {
            "StartTrain": rpc_timeout if rpc_timeout is not None else rp.start_train_timeout_s,
            "SendModel": rpc_timeout if rpc_timeout is not None else rp.send_model_timeout_s,
            "FetchModel": rpc_timeout if rpc_timeout is not None else rp.fetch_model_timeout_s,
            "HeartBeat": rp.probe_timeout_s,
            "CheckIfPrimaryUp": rp.backup_ping_timeout_s,
        }
        self.rpc_timeout = self._deadlines["SendModel"]
        self.chaos = chaos
        log.info(
            "transport timings: start_train=%.1fs send_model=%.1fs fetch_model=%.1fs "
            "probe=%.1fs backup_ping=%.1fs heartbeat_period=%.1fs retries=%d "
            "round_quorum=%.2f chaos=%s",
            self._deadlines["StartTrain"], self._deadlines["SendModel"],
            self._deadlines["FetchModel"], self._deadlines["HeartBeat"],
            self._deadlines["CheckIfPrimaryUp"], cfg.fed.ft_heartbeat_period_s,
            rp.max_attempts, cfg.fed.round_quorum,
            chaos.describe() if chaos is not None else "off",
        )
        # Under chaos the retries' jitter draws from a stream seeded by the
        # schedule, so a run's retry timing replays with its seed.
        self._retry_rand = random.Random(chaos.seed ^ 0xFE17CE).random if chaos is not None else None
        self.telemetry = Telemetry(cfg.fed.telemetry, role="primary")
        # The black box of recent rounds, fences and warning+ events,
        # dumpable at any moment and read over /flightz.
        self.flight = flight if flight is not None else FlightRecorder(role="primary")
        # Under trace, every finished span lands in the flight ring too.
        if self.telemetry.tracer is not None:
            self.telemetry.tracer.sink = self.flight.record_span
        # The /statusz feed: the round loop updates round and phase.
        self.status = StatusBoard(role="primary", phase="init", round=0)
        # The process's CompileWatcher (obs/profile.py), handed over by its
        # owner so that /statusz shows the kernel builds.
        self.compile_watcher = None
        metrics = self.telemetry.registry if self.telemetry.enabled else None
        if chaos is not None:
            chaos.attach(metrics=metrics, flight=self.flight)
        shape, _ = datasets.dataset_info(cfg.data.dataset)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = models.create(cfg.model, cfg.num_classes, shape)
        model.to(self.device)
        self.global_tree: Tree = {
            "params": {k: p.detach().clone() for k, p in model.named_parameters()},
            "batch_stats": {k: b.detach().clone() for k, b in model.named_buffers()},
        }
        # The edge's row: the replies' layout, the broadcast's and the
        # replica's (flax's order and layout).
        self.layout = flat_ops.make_tree_layout(self.global_tree)
        # Its flax tree of zeros: the structure payloads are decoded into.
        self._model_template = flat_ops.flax_tree(self.layout, np.zeros(self.layout.total, np.float32))
        self._weights_ignored = False
        if cfg.fed.weighted:
            self._weights_ignored = warn_weighted_robust(cfg.fed.aggregator)
        if cfg.fed.dp_clip_norm > 0 and self.global_tree["batch_stats"]:
            raise ValueError(
                "DP requires a BatchNorm-free model: batch statistics are "
                "released unclipped. Pick a model without batch_stats (e.g. mlp)."
            )
        # The adaptive codec policy: one codec a client a round, sent in
        # TrainRequest.codec and learned from bytes x RTT.
        self._codec_policy = AdaptiveCodecPolicy() if cfg.fed.codec_policy == "adaptive" else None
        # Reply bytes by the codec they used, over every committed round.
        self._codec_bytes_up: Dict[str, int] = {}
        self._server_opt = server_opt.make_server_optimizer(cfg.fed)
        self._server_opt_state = server_opt.init(self._server_opt, self.global_tree["params"])
        # The lineage's count of aggregations: it seeds DP noise and
        # participation sampling and rides the replica, so a promoted
        # backup never replays an earlier round's draws.
        self._round_counter = 0
        # Fencing: role 1 primary, 2 acting (a promoted backup); the epoch
        # is minted on promotion and on a post-fence re-base; _fenced flips
        # when a receiver rejects us as STALE_COORDINATOR, and _epoch_seen
        # is the largest epoch such a rejection named.
        self._role = 1
        self._fenced = False
        self._epoch_seen = -1
        self._fence_lock = threading.Lock()
        self._fence_retry_s = 0.5
        self._set_epoch(1)
        self.registry = MembershipTable(clients, metrics=metrics)
        # Every channel this server dials (the fan-out, the heartbeat
        # probes, the backup's pings, replication and FetchModel) carries
        # the trace-propagation interceptor, whose source yields None below
        # trace (one no-op call an RPC); chaos wraps it, keyed by peer.
        self._member_lock = threading.Lock()
        self._stubs: Dict[str, TrainerStub] = {c: self._make_stub(c) for c in clients}
        self._gate_server = None
        self.backup_stub = (
            TrainerStub(create_channel(backup_address, compress=compress,
                                       trace_source=self._trace_source, chaos=chaos))
            if backup_address else None
        )
        self.monitor = HeartbeatMonitor(
            self.registry,
            probe=self._probe_member,
            resync=self._resync,
            period=cfg.fed.ft_heartbeat_period_s,
            metrics=metrics,
            probe_deadline_s=rp.max_attempts * (rp.probe_timeout_s + rp.backoff_max_s) + 1.0,
        )
        self.pinger = PrimaryPinger(self._ping_backup, metrics=metrics) if self.backup_stub else None
        self.server_pipeline = resolve_server_pipeline(cfg.fed)
        # The root of two tiers: the roster holds aggregators, aggregator
        # seat j relays the data ranks [j * fanout, (j + 1) * fanout), and
        # the pull shares StartTrain's deadline (it waits on a cohort).
        self.tier_fanout = cfg.fed.tier_fanout
        if self.tier_fanout:
            validate_tier_config(cfg.fed, "PrimaryServer")
            self._deadlines["SubmitPartial"] = self._deadlines["StartTrain"]
        self._screen_cfg = None
        if screening_enabled(cfg.fed.screen):
            self._screen_cfg = validate_screen_config(cfg.fed.screen)
        self.history: List[dict] = []
        self._did_initial_sync = False
        # StartTrain and broadcast threads still in flight from earlier
        # rounds, by client: a client is never handed a second concurrent
        # StartTrain, nor a second concurrent SendModel.
        self._inflight: Dict[str, threading.Thread] = {}
        self._sends: Dict[str, threading.Thread] = {}
        # Installed last: a replica carries the previous primary's roster,
        # whose adoption needs the registry and the stubs.
        if initial_model is not None:
            self._install(initial_model)

    # -------------------------------------------------------------- model
    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return self.global_tree["params"]

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return self.global_tree["batch_stats"]

    def _host_model(self, tree: Optional[Tree] = None) -> dict:
        """The global model (or ``tree``) as fedtpu's flax tree of f32
        numpy arrays, copied to the host once."""
        return flat_ops.to_flax_host(self.layout, self.global_tree if tree is None else tree)

    def _device_model(self, flax_tree: dict) -> Tree:
        """A flax ``{"params", "batch_stats"}`` tree on the coordinator's
        device, through one row; :class:`wire.WireError` when its leaves do
        not match this server's model."""
        row = wire.model_row(flax_tree, self.layout.sizes, self.layout.padded)
        return flat_ops.unpack_tree(self.layout, torch.from_numpy(row).to(self.device))

    def model_bytes(self) -> bytes:
        """The client broadcast: the global model only, fedtpu's FTP1 bytes."""
        return wire.encode(self._host_model(), compress=self.compress)

    def _set_epoch(self, epoch: int) -> None:
        """Adopt a coordinator epoch and mirror it on its gauge, one path
        for mint and restore."""
        self._coord_epoch = int(epoch)
        self.telemetry.gauge(
            "fedtpu_ft_coordinator_epoch",
            "this coordinator's fencing epoch (minted on promotion or "
            "post-fence re-base)",
        ).set(float(self._coord_epoch))

    def _membership_bytes(self) -> np.ndarray:
        """The roster snapshot as a uint8 JSON leaf of the replica."""
        return np.frombuffer(json.dumps(self.registry.snapshot()).encode(), np.uint8)

    def _adopt_membership(self, leaf) -> None:
        """Adopt a replicated roster and rebuild the stubs to match."""
        blob = np.asarray(leaf, np.uint8).tobytes()
        if not blob:
            return
        self.registry.restore(json.loads(blob.decode()))
        members = set(self.registry.clients)
        with self._member_lock:
            for address in members - set(self._stubs):
                self._stubs[address] = self._make_stub(address)
            for address in set(self._stubs) - members:
                self._stubs.pop(address)

    def state_tree(self) -> dict:
        """The whole resumable state as fedtpu's replica tree: the model,
        the round counter, the fencing epoch, the roster (a uint8 JSON
        leaf) and, with a server optimizer, its state in optax's form."""
        host = self._host_model()
        tree = {
            "params": host["params"],
            "batch_stats": host["batch_stats"],
            "round_counter": np.asarray(self._round_counter, np.int64),
            "coord_epoch": np.asarray(self._coord_epoch, np.int64),
            "membership": self._membership_bytes(),
        }
        if self._server_opt is not None:
            tree["server_opt"] = _opt_state_to_flax(self._server_opt, self._server_opt_state)
        return tree

    def state_template(self, membership: bool = True, epoch: bool = True) -> dict:
        """The structure of :meth:`state_tree`; ``membership=False`` is the
        layout before elastic membership and ``epoch=False`` the one before
        fencing, which older coordinators' replicas have."""
        tree = {
            "params": self._model_template["params"],
            "batch_stats": self._model_template["batch_stats"],
            "round_counter": np.zeros((), np.int64),
        }
        if epoch:
            tree["coord_epoch"] = np.zeros((), np.int64)
        if membership:
            tree["membership"] = np.zeros((0,), np.uint8)
        if self._server_opt is not None:
            tree["server_opt"] = self._opt_template()
        return tree

    def _opt_template(self) -> dict:
        params = self._model_template["params"]
        if self._server_opt.name == "momentum":
            return {"0": {"trace": params}, "1": {}}
        return {"0": {"count": np.zeros((), np.int32), "mu": params, "nu": params}, "1": {}}

    def install_state(self, tree: dict) -> None:
        """Adopt a restored :meth:`state_tree`: the model, the counter, the
        server optimizer's state, the roster when the tree has one, and the
        fencing epoch by max (a replica never lowers it)."""
        new_global = self._device_model(tree)
        if self._server_opt is not None:
            self._server_opt_state = _opt_state_from_flax(self._server_opt, tree["server_opt"], self.device)
        self._round_counter = int(np.asarray(tree["round_counter"]))
        self.global_tree = new_global
        if "coord_epoch" in tree:
            self._set_epoch(max(self._coord_epoch, int(np.asarray(tree["coord_epoch"]))))
        if "membership" in tree:
            self._adopt_membership(tree["membership"])

    def replica_bytes(self) -> bytes:
        """The backup's payload: :meth:`state_tree` as an FTP1 frame
        stamped ``kind="replica"``, fedtpu's bytes."""
        return wire.encode(self.state_tree(), compress=self.compress, kind="replica")

    def _install(self, data: bytes) -> None:
        """Install a replica or a plain model payload, dispatched on the
        frame's kind flag. A corrupted payload raises :class:`wire.
        WireError`; a replica of another configuration fails every layout
        and raises too, never installing part of a state."""
        raw = wire.decode_raw(data)  # the CRC check: WireError on corruption
        if wire.payload_kind(data) == "replica":
            for template in (
                self.state_template(),
                self.state_template(epoch=False),
                self.state_template(membership=False, epoch=False),
            ):
                try:
                    tree = msgpack.restore_into(template, raw)
                    break
                except msgpack.MsgpackError as exc:
                    err = exc
            else:
                raise wire.WireError(
                    "replica payload does not match this server's configuration "
                    f"({err}); refusing to install a partial state"
                ) from err
            self.install_state(tree)
        else:
            try:
                tree = msgpack.restore_into(self._model_template, raw)
            except msgpack.MsgpackError as exc:
                raise wire.WireError(
                    f"model payload does not match this server's configuration ({exc})"
                ) from exc
            self.global_tree = self._device_model(tree)

    # ------------------------------------------------------------- sync
    def _send_model(self, stub: TrainerStub, payload: bytes, peer: str) -> None:
        """One SendModel under the retry policy, stamped with our epoch."""
        call_with_retry(
            self.retry_policy, "SendModel",
            lambda: stub.SendModel(
                proto.SendModelRequest(model=payload, epoch=self._coord_epoch, role=self._role),
                timeout=self._deadlines["SendModel"],
            ),
            peer=peer, telemetry=self.telemetry, rand=self._retry_rand,
        )

    def _resync(self, client: str) -> None:
        """Push the current global model to a recovered client. Raises
        (the revive waits for the next heartbeat pass) while a broadcast
        to it is still in flight: the resync could land first and leave
        the older model installed last."""
        stale = self._sends.get(client)
        if stale is not None and stale.is_alive():
            raise RuntimeError(f"stale broadcast to {client} still in flight; deferring resync")
        stub = self._stub(client)
        if stub is None:
            raise RuntimeError(f"{client} evicted; nothing to resync")
        try:
            self._send_model(stub, self.model_bytes(), client)
        except grpc.RpcError as e:
            if is_stale_coordinator(e):
                self._handle_stale("SendModel", client, e)
            raise

    def sync_clients(self) -> None:
        """Broadcast the current global model to every live client; runs
        before the first round (a client may hold a baseline from another
        server generation, which would corrupt a sparse delta)."""
        payload = self.model_bytes()
        for client in self.registry.active_clients():
            stub = self._stub(client)
            if stub is None:
                continue
            try:
                self._send_model(stub, payload, client)
            except grpc.RpcError as e:
                if is_stale_coordinator(e):
                    # We are the superseded side; the client is healthy.
                    self._handle_stale("SendModel", client, e)
                    continue
                log.warning("client %s failed during initial sync", client)
                self.telemetry.counter(
                    "fedtpu_rpc_failures_total",
                    "RpcErrors by failing RPC",
                    labels={"rpc": "SendModel"},
                ).inc()
                self.registry.mark_failed(client)
        self._did_initial_sync = True

    def _ping_backup(self, recovering: bool) -> Optional[int]:
        """One CheckIfPrimaryUp; when the backup answers 1 (it acted as
        primary), fetch and install its newer state. None when the backup
        is unreachable."""
        try:
            resp = call_with_retry(
                self.retry_policy, "CheckIfPrimaryUp",
                lambda: self.backup_stub.CheckIfPrimaryUp(
                    proto.PingRequest(req=b"1" if recovering else b"0", epoch=self._coord_epoch),
                    timeout=self._deadlines["CheckIfPrimaryUp"],
                ),
                telemetry=self.telemetry, rand=self._retry_rand,
            )
        except grpc.RpcError as e:
            if is_stale_coordinator(e):
                self._handle_stale("CheckIfPrimaryUp", "backup", e)
            return None
        if resp.value == 1:
            try:
                def fetch():
                    fetched = self.backup_stub.FetchModel(
                        proto.Request(), timeout=self._deadlines["FetchModel"]
                    )
                    if fetched.model:
                        self._install(fetched.model)
                        log.info("recovered newer global model from backup")

                call_with_retry(self.retry_policy, "FetchModel", fetch,
                                telemetry=self.telemetry, rand=self._retry_rand)
            except grpc.RpcError:
                log.warning("backup demoted but FetchModel failed")
            except wire.WireError:
                log.warning(
                    "backup demoted but its model payload stayed corrupt after retries; "
                    "keeping the local model"
                )
        return resp.value

    # ------------------------------------------------------------ fencing
    def _handle_stale(self, rpc: str, peer: str, exc: grpc.RpcError) -> None:
        """A receiver rejected us as STALE_COORDINATOR: record the winner's
        epoch from the rejection and raise the fence; the round loop voids
        the round and re-bases (:meth:`handle_fence`). ``peer`` is healthy
        and never marked failed."""
        try:
            details = exc.details() or ""
            self._epoch_seen = max(self._epoch_seen, int(details.rsplit("<", 1)[1]))
        except Exception:
            pass  # malformed details: the re-base still mints past our own epoch
        with self._fence_lock:
            first = not self._fenced
            self._fenced = True
        if not first:
            return
        log.warning(
            "FENCED by %s via %s: our epoch %d is stale (newest seen %d); "
            "voiding the in-flight round and re-basing",
            peer, rpc, self._coord_epoch, self._epoch_seen,
        )
        self.telemetry.counter(
            "fedtpu_ft_fenced_total",
            "times this coordinator was fenced by a STALE_COORDINATOR "
            "rejection (superseded by a higher epoch)",
        ).inc()
        self.flight.record("fence", rpc=rpc, peer=peer, epoch=self._coord_epoch, epoch_seen=self._epoch_seen)
        self.flight.dump(reason="fence")

    def handle_fence(self) -> None:
        """Re-base after a fence: demote the acting backup through the
        recovering handshake, adopt its state (FetchModel; the replica
        raises our epoch to the winner's), then mint an epoch past every
        one seen and resync on the next round. The fence stays up, retried
        every ``_fence_retry_s``, until the handshake is delivered:
        resuming without the winner's state would fork the lineage."""
        if not self._fenced:
            return
        log.info("re-basing after fence (epoch %d, seen %d)", self._coord_epoch, self._epoch_seen)
        if self.pinger is None:
            time.sleep(self._fence_retry_s)
            return
        self.pinger.recovering = True
        if self.pinger.tick() is None:
            time.sleep(self._fence_retry_s)
            return
        self._set_epoch(max(self._coord_epoch, self._epoch_seen) + 1)
        self._did_initial_sync = False
        with self._fence_lock:
            self._fenced = False
        self.flight.record("fence", event="rebased", epoch=self._coord_epoch)
        log.info("re-based: continuing as epoch %d", self._coord_epoch)

    def health(self) -> Tuple[bool, str]:
        """``(ok, reason)``: not ok while fenced, or when the last round
        aborted under quorum."""
        if self._fenced:
            return False, "fenced: stale coordinator pending re-base"
        if self.history and self.history[-1].get("aborted"):
            return False, "quorum unmet: last round aborted"
        return True, "ok"

    # --------------------------------------------------------- membership
    def _make_stub(self, address: str) -> TrainerStub:
        return TrainerStub(create_channel(address, compress=self.compress,
                                          trace_source=self._trace_source, chaos=self.chaos))

    def _stub(self, client: str) -> Optional[TrainerStub]:
        """The member's stub, or None for an evicted non-member."""
        with self._member_lock:
            return self._stubs.get(client)

    def _probe_member(self, client: str) -> bool:
        stub = self._stub(client)
        if stub is None:
            return False
        return probe(stub, timeout=self._deadlines["HeartBeat"], policy=self.retry_policy,
                     telemetry=self.telemetry) is not None

    def admit_client(self, address: str) -> dict:
        """Admit (or re-admit) a member: it joins dead and is resynced with
        the current global model before it is marked alive; when the
        resync fails it stays dead and the heartbeat finishes the revival."""
        with self._member_lock:
            rejoin = self.registry.is_member(address)
            seat = self.registry.admit(address)
            if address not in self._stubs:
                self._stubs[address] = self._make_stub(address)
        resynced = False
        try:
            self._resync(address)
            self.registry.mark_alive(address)
            resynced = True
        except (grpc.RpcError, RuntimeError) as exc:
            log.warning(
                "join: %s admitted at seat %d but resync failed (%s); "
                "heartbeat monitor will revive it", address, seat, exc,
            )
        self.flight.record(
            "membership", event="join", client=address, seat=seat,
            version=self.registry.version, rejoin=rejoin,
        )
        return {
            "admitted": True,
            "seat": seat,
            "world": self.registry.capacity(),
            "version": self.registry.version,
            "resynced": resynced,
        }

    def remove_client(self, address: str, reason: str = "leave") -> dict:
        """Evict a member, freeing its seat, and close its channel."""
        left = self.registry.evict(address, reason=reason)
        with self._member_lock:
            stub = self._stubs.pop(address, None)
        if stub is not None:
            stub._channel.close()
        if left:
            self.flight.record(
                "membership", event="leave", client=address,
                version=self.registry.version, reason=reason,
            )
        return {"left": left, "version": self.registry.version}

    def _update_reputation(self, order: List[str], flagged: set, quarantined_now: set) -> None:
        """Fold the round's screening verdicts into each participant's
        suspicion and run the ladder: quarantine at ``quarantine_at``,
        release below ``release_at``, evict after ``evict_after``
        quarantined rounds."""
        sc = self._screen_cfg
        for c in order:
            s = self.registry.observe_screening(c, c in flagged, ewma=sc.ewma)
            if c in quarantined_now:
                rounds_q = self.registry.tick_quarantine(c)
                if s < sc.release_at:
                    if self.registry.release(c):
                        self.flight.record("membership", event="release", client=c, suspicion=round(s, 4))
                elif sc.evict_after and rounds_q >= sc.evict_after:
                    log.warning(
                        "client %s evicted after %d quarantined rounds (suspicion %.3f)",
                        c, rounds_q, s,
                    )
                    self.remove_client(c, reason="quarantine")
            elif s >= sc.quarantine_at:
                if self.registry.quarantine(c):
                    self.flight.record("membership", event="quarantine", client=c, suspicion=round(s, 4))

    def start_gate(self, address: str):
        """Serve the membership gate (Join and Leave) on ``address``, this
        coordinator's only inbound surface; returns the gRPC server."""
        self._gate_server = create_server(address, _MembershipGate(self), compress=self.compress,
                                          chaos=self.chaos)
        self._gate_server.start()
        log.info("membership gate serving on %s", address)
        return self._gate_server

    def stop_gate(self) -> None:
        if self._gate_server is not None:
            self._gate_server.stop(0)
            self._gate_server = None

    # ------------------------------------------------------ observability
    def _trace_source(self) -> Optional[propagate.TraceContext]:
        """The context each outbound RPC carries, computed on the issuing
        thread, so the innermost open span (a collect worker's
        ``client_rpc``) becomes the receiver's remote parent. None below
        trace: the interceptor then forwards the call untouched."""
        tracer = self.telemetry.tracer
        if tracer is None:
            return None
        return propagate.TraceContext(
            trace_id=tracer.trace_id,
            span_id=tracer.current_id() or 0,
            role=self.telemetry.role or "primary",
            round=self._round_counter,
        )

    def status_snapshot(self) -> dict:
        """fedtpu's ``/statusz`` feed: the board's round and phase, liveness,
        the membership block, the memory axes, the stragglers still in
        flight, fencing, the heartbeat misses, the trace id under trace,
        the last round's split, the per-codec byte table, under the
        adaptive policy its costs, and the ``compile`` block when a
        :class:`~fedtpu_torch.obs.CompileWatcher` was handed over."""
        snap = self.status.snapshot()
        reg = self.registry
        tel = self.telemetry
        snap.update(
            pid=os.getpid(),
            clients={"alive": reg.active_clients(), "dead": reg.dead_clients()},
            membership=reg.status(),
            mem={
                "rss_bytes": process_rss_bytes(),
                "buffer_bytes": int(self.history[-1].get("buffer_bytes", 0)) if self.history else 0,
                "tier": "root" if self.tier_fanout else "flat",
                # The partial rows held toward an in-flight root combine.
                "partial_rows_buffered": (
                    int(tel.registry.gauge("fedtpu_partial_rows_buffered", "").value)
                    if self.tier_fanout and tel.enabled else 0
                ),
            },
            stragglers_in_flight=sorted(c for c, t in self._inflight.items() if t.is_alive()),
            rounds_completed=sum(1 for rec in self.history if not rec.get("aborted")),
            rounds_aborted=sum(1 for rec in self.history if rec.get("aborted")),
            fencing={"epoch": self._coord_epoch, "role": "acting" if self._role == 2 else "primary",
                     "fenced": self._fenced},
        )
        if tel.enabled:
            snap["heartbeat_misses"] = tel.registry.counter(
                "fedtpu_ft_heartbeat_misses_total",
                "heartbeat probes of dead clients that stayed dead",
            ).value
        if tel.tracer is not None:
            snap["trace_id"] = tel.tracer.trace_id
        if self.history:
            last = self.history[-1]
            snap["last_round"] = {
                k: last[k] for k in (
                    "participants", "stragglers", "bytes_up", "bytes_down", "bytes_up_by_codec",
                    "t_collect_s", "t_decode_s", "t_h2d_s", "t_aggregate_s", "t_post_barrier_s",
                    "t_round_s", "pipeline", "client_latency",
                ) if k in last
            }
        with self._member_lock:
            if self._codec_bytes_up:
                snap["codec_bytes_up"] = dict(self._codec_bytes_up)
        if self._codec_policy is not None:
            snap["codec_policy"] = self._codec_policy.snapshot()
        if self.compile_watcher is not None:
            snap["compile"] = self.compile_watcher.snapshot()
        return snap

    # ------------------------------------------------------ async (FedBuff)
    def run_async(
        self,
        num_updates: int,
        buffer_k: int = 2,
        staleness_power: float = 0.5,
        stop: Optional[Callable[[], bool]] = None,
        on_update: Optional[Callable[[int, dict], None]] = None,
        staleness_damping: bool = True,
    ) -> List[dict]:
        """Semi-asynchronous orchestration (FedBuff, Nguyen et al. 2022),
        fedtpu's ``run_async``. No round barrier: one worker thread per
        seat loops on its own (SendModel of the current global, StartTrain
        and the decode as one retryable unit, the delta against the model
        it pulled), and the server applies an update as soon as
        ``buffer_k`` deltas are buffered (:func:`~fedtpu_torch.transport.
        aggregation.fedbuff_apply`: weights ``w / (1 + staleness)^p``,
        damped by default). Below ``round_quorum`` of the current
        membership the buffer is held and the global model untouched;
        with every client dead and nothing buffered for 10 s the loop
        stops. Each update is replicated to the backup and recorded
        (``update``, ``contributors``, ``staleness``, ``alive``); the
        final model is broadcast to every live client. Composes with the
        mean aggregator and a server optimizer only: compression, robust
        aggregators, DP and screening are refused, with fedtpu's messages.
        Runs until ``num_updates`` updates or ``stop()``; returns the
        records. Each update counts into ``fedtpu_async_updates_total``,
        its deltas' staleness into the ``fedtpu_async_staleness``
        histogram, and lands in the flight recorder as ``async_update``."""
        import queue

        fed = self.cfg.fed
        tel = self.telemetry
        if fed.compression != "none":
            raise ValueError(
                "run_async requires compression='none': sparse deltas "
                "against stale baselines corrupt aggregation."
            )
        if fed.aggregator != "mean":
            raise ValueError(
                "run_async requires aggregator='mean': a buffer of "
                f"{buffer_k} is too small a population for robust statistics."
            )
        if fed.dp_clip_norm > 0:
            raise ValueError(
                "run_async does not support DP: per-update participation "
                "accounting differs from the synchronous analysis."
            )
        if self._screen_cfg is not None:
            raise ValueError(
                "run_async does not support update screening: the "
                f"buffer of {buffer_k} is too small a population for the "
                "median/MAD reference statistics. Use the synchronous "
                "round loop."
            )
        if buffer_k < 1:
            raise ValueError(f"buffer_k must be >= 1, got {buffer_k}")

        lay = self.layout
        payload_like = dict(self._model_template, num_examples=np.zeros((), np.float32))
        replies: "queue.Queue" = queue.Queue()
        done = threading.Event()
        version_lock = threading.Lock()
        self._async_version = 0

        def snapshot():
            """(version, payload, host base) of the current global model,
            built once a version."""
            return self._async_version, self.model_bytes(), self._host_model()

        current = [snapshot()]  # guarded by version_lock

        def worker(client: str, rank: int) -> None:
            """One client's loop: sync, train, enqueue, until done."""
            while not done.is_set():
                if not self.registry.is_alive(client):
                    time.sleep(0.2)  # the heartbeat monitor may revive it
                    continue
                stub = self._stub(client)
                if stub is None:
                    return  # evicted mid-run: this worker retires
                try:
                    with version_lock:
                        base_version, payload, base = current[0]
                    self._send_model(stub, payload, client)
                    tel.counter(
                        "fedtpu_rpc_bytes_down_total",
                        "server -> client/backup broadcast bytes (successful)",
                    ).inc(len(payload))

                    def train_attempt():
                        # RPC and decode as one retryable unit: a corrupt
                        # reply is asked for again.
                        reply = stub.StartTrain(
                            proto.TrainRequest(rank=rank, world=self.registry.capacity(),
                                               epoch=self._coord_epoch),
                            timeout=self._deadlines["StartTrain"],
                        )
                        row = np.zeros(lay.padded, np.float32)
                        extra = wire.decode_into_row(reply.message, payload_like, base, row)
                        return reply, row, extra

                    reply, row, extra = call_with_retry(
                        self.retry_policy, "StartTrain", train_attempt, peer=client,
                        telemetry=tel, rand=self._retry_rand,
                    )
                    tel.counter(
                        "fedtpu_rpc_bytes_up_total",
                        "client -> server StartTrain reply bytes (successful)",
                    ).inc(len(reply.message))
                    replies.put((client, row, float(extra["num_examples"]), base_version))
                except (grpc.RpcError, wire.WireError) as e:
                    if is_stale_coordinator(e):
                        # Superseded: the client stays alive, this worker
                        # retires and the caller re-bases.
                        self._handle_stale("AsyncWorker", client, e)
                        return
                    if isinstance(e, grpc.RpcError):
                        log.warning("async client %s failed: %s %s", client, e.code(), e.details())
                    else:
                        log.warning("async client %s reply still corrupt after retries: %s", client, e)
                    tel.counter(
                        "fedtpu_rpc_failures_total",
                        "RpcErrors by failing RPC",
                        labels={"rpc": "AsyncWorker"},
                    ).inc()
                    self.registry.mark_failed(client)

        self.monitor.start()
        if self.pinger is not None:
            self.pinger.tick()
            self.pinger.start()
        # One worker per member at start; a member admitted mid-run joins
        # the training loop on the next run_async.
        workers = [
            threading.Thread(target=worker, args=(c, rank), daemon=True)
            for c, rank in sorted(self.registry.seat_map().items())
        ]
        for w in workers:
            w.start()
        all_dead_since: List[Optional[float]] = [None]

        def hopeless() -> bool:
            """Every client dead and nothing buffered, for over 10 s."""
            if self.registry.active_clients() or not replies.empty():
                all_dead_since[0] = None
                return False
            if all_dead_since[0] is None:
                all_dead_since[0] = time.monotonic()
            return time.monotonic() - all_dead_since[0] > 10.0

        poll_s = fed.async_poll_s
        # The quorum counts against the current membership.
        quorum_n = max(1, math.ceil(fed.round_quorum * self.registry.size)) if fed.round_quorum > 0 else 0
        try:
            while self._async_version < num_updates:
                if stop is not None and stop():
                    break
                buf = []
                while len(buf) < buffer_k:
                    try:
                        buf.append(replies.get(timeout=poll_s))
                    except queue.Empty:
                        if (stop is not None and stop()) or hopeless():
                            break
                if len(buf) < buffer_k:
                    if hopeless():
                        log.warning("all async clients dead; stopping")
                        break
                    continue
                if quorum_n and len(self.registry.active_clients()) < quorum_n:
                    log.warning(
                        "async update held: %d alive < quorum %d; waiting for recovery",
                        len(self.registry.active_clients()), quorum_n,
                    )
                    tel.counter(
                        "fedtpu_round_aborts_total",
                        "rounds aborted below quorum (global model untouched)",
                    ).inc()
                    while (len(self.registry.active_clients()) < quorum_n and not hopeless()
                           and not (stop is not None and stop())):
                        time.sleep(poll_s)
                    if len(self.registry.active_clients()) < quorum_n:
                        log.warning("quorum never recovered; stopping")
                        break
                with tel.span("async_update"), version_lock:
                    v = self._async_version
                    stalenesses = [v - b for _, _, _, b in buf]
                    raw = [n if fed.weighted else 1.0 for _, _, n, _ in buf]
                    rows = torch.from_numpy(np.stack([r for _, r, _, _ in buf])).to(self.device)
                    stacked = _split_collections(flat_ops.unpack_stacked(lay, rows))
                    new_global, self._server_opt_state = aggregation.fedbuff_apply(
                        self.cfg, self.global_tree, stacked, raw, stalenesses, staleness_power,
                        staleness_damping, self._server_opt_state, v, server=self._server_opt,
                    )
                    del rows, stacked
                    self.global_tree = new_global
                    self._async_version = v + 1
                    # The lineage counter stays monotone across modes: a
                    # backup promoted from async replicas continues it.
                    self._round_counter += 1
                    current[0] = snapshot()
                if self.backup_stub is not None:
                    try:
                        self._send_model(self.backup_stub, self.replica_bytes(), "backup")
                    except grpc.RpcError as e:
                        if is_stale_coordinator(e):
                            self._handle_stale("Replicate", "backup", e)
                        else:
                            log.warning("backup unreachable during replication")
                rec = {
                    "update": self._async_version,
                    "contributors": [c for c, _, _, _ in buf],
                    "staleness": stalenesses,
                    "alive": self.registry.alive_mask().tolist(),
                }
                self.history.append(rec)
                self.status.update(round=self._round_counter, phase="async", async_update=self._async_version)
                self.flight.record("async_update", update=self._async_version, contributors=len(buf))
                if tel.enabled:
                    tel.counter(
                        "fedtpu_async_updates_total",
                        "FedBuff server updates applied",
                    ).inc()
                    stale_hist = tel.histogram(
                        "fedtpu_async_staleness",
                        "staleness (server updates) of buffered deltas at "
                        "apply time",
                        buckets=(0, 1, 2, 4, 8, 16, 32, 64),
                    )
                    for st in stalenesses:
                        stale_hist.observe(st)
                log.info("async update %s", rec)
                if on_update is not None:
                    on_update(self._async_version, rec)
            # Deliver the final model: the workers stop syncing once done
            # is set, and every client would end an update stale.
            done.set()
            for w in workers:
                w.join(timeout=self.rpc_timeout)
            self.sync_clients()
        finally:
            done.set()
            self.monitor.stop()
            if self.pinger is not None:
                self.pinger.stop()
        return self.history

    def restore_from_checkpoint(self, ckpt) -> Optional[int]:
        """A cold start from the newest generation of ``ckpt`` (a
        :class:`fedtpu_torch.checkpoint.Checkpointer` or its background
        wrapper) that verifies, its ``restore_latest`` falling back past
        corrupt ones: the model, the lineage counter, the roster with its
        suspicion scores, the server optimizer's moments and the fencing
        epoch. The roster's adoption rebuilds the stubs, and the initial
        sync flag is cleared, so the first round pushes the restored global
        to every client (whose next StartTrain carries the lineage round
        they roll back to).

        Layouts, newest first: the current one, before fencing (the epoch
        kept), before elastic membership (the startup roster kept), and a
        model-only generation (the counter taken from its index). Returns
        the next round to run, or None for an empty directory; raises
        :class:`wire.WireError` when generations exist and none verifies."""
        latest = None
        for template in (
            self.state_template(),
            self.state_template(epoch=False),
            self.state_template(membership=False, epoch=False),
        ):
            try:
                latest = ckpt.restore_latest(template)
                break
            except wire.WireError:
                raise
            except ValueError:
                continue
        if latest is None:
            legacy = ckpt.restore_latest(self._model_template)
            if legacy is None:
                return None
            r, tree = legacy
            self.global_tree = self._device_model(tree)
            self._round_counter = r + 1
            self._did_initial_sync = False
            log.info("resumed legacy model-only checkpoint from round %d", r)
            return r + 1
        r, tree = latest
        self.install_state(tree)
        # Survivors hold weights from rounds the restored lineage may not
        # know: the pre-round broadcast re-bases every one of them.
        self._did_initial_sync = False
        log.info(
            "cold start: restored round %d from %s (lineage continues at %d; "
            "roster size %d, membership v%d)",
            r, getattr(ckpt, "directory", "?"), self._round_counter,
            self.registry.size, self.registry.version,
        )
        self.flight.record("checkpoint", event="restore", round=r, members=self.registry.size)
        return r + 1

    # ---------------------------------------------------------- the round
    def _abort_record(self, reason: dict, completed, stragglers, world, roster_now,
                      membership_version, bytes_up, t_launch, t_barrier, decode_s, h2d_s) -> dict:
        """A voided round's record (fenced, or below quorum): the global
        model, the server optimizer and the counter are untouched, and the
        next round resyncs every client first. Counted and recorded in the
        flight recorder with its reason."""
        self._did_initial_sync = False
        self.telemetry.counter(
            "fedtpu_round_aborts_total",
            "rounds aborted below quorum (global model untouched)",
        ).inc()
        self.flight.record("round_abort", round=self._round_counter, participants=len(completed), **reason)
        rec = {
            "round": self._round_counter,
            "epoch": self._coord_epoch,
            "participants": len(completed),
            "stragglers": len(stragglers),
            "world": world,
            "alive": [self.registry.is_alive(c) for c in roster_now],
            "membership_version": membership_version,
            "aborted": True,
            **reason,
            "bytes_up": int(bytes_up.value),
            "bytes_down": 0,
            "pipeline": self.server_pipeline,
            "t_collect_s": round(t_barrier - t_launch, 6),
            "t_decode_s": round(decode_s.value, 6),
            "t_h2d_s": round(h2d_s.value, 6),
            "t_aggregate_s": 0.0,
            "t_post_barrier_s": 0.0,
        }
        self.history.append(rec)
        return rec

    def round(self) -> dict:
        """One synchronous FedAvg round; returns the round record. The body
        runs in the top-level ``round`` span; the registry (bytes, phase
        histograms, stragglers) and the flight recorder are fed after the
        record is built."""
        tel = self.telemetry
        with tel.span("round", round=self._round_counter) as rspan:
            rec = self._round_body(rspan)
        self.status.update(phase="idle")
        if tel.enabled:
            # Leak axes, sampled once a round.
            tel.gauge(
                "fedtpu_process_rss_bytes",
                "current resident set size of this process",
            ).set(process_rss_bytes())
            tel.gauge(
                "fedtpu_buffer_bytes",
                "flat collect-buffer bytes held by the last round "
                "(host rows + device twin; 0 on the barrier path), by "
                "tier: 'flat' = one-tier federation, 'root' = the tiered "
                "root's [aggregators, P] surface, 'leaf' = a sub-"
                "aggregator's [cohort, P] buffer",
                labels={"tier": "root" if self.tier_fanout else "flat"},
            ).set(rec.get("buffer_bytes", 0))
            if self.tier_fanout:
                # The round's partial rows are combined and released.
                tel.gauge(
                    "fedtpu_partial_rows_buffered",
                    "partial-sum rows (one per sub-aggregator) buffered "
                    "toward this round's root combine",
                ).set(0)
        if rec.get("aborted"):
            # Counted and recorded where it aborted; not a completed round.
            return rec
        self.flight.record(
            "round",
            round=self._round_counter - 1,
            participants=rec["participants"],
            stragglers=rec["stragglers"],
            t_collect_s=rec["t_collect_s"],
            t_aggregate_s=rec["t_aggregate_s"],
        )
        if tel.enabled:
            tel.counter(
                "fedtpu_rounds_completed_total",
                "synchronous FedAvg rounds completed by this server",
            ).inc()
            tel.counter(
                "fedtpu_rpc_bytes_up_total",
                "client -> server StartTrain reply bytes (successful)",
            ).inc(rec["bytes_up"])
            tel.counter(
                "fedtpu_rpc_bytes_down_total",
                "server -> client/backup broadcast bytes (successful)",
            ).inc(rec["bytes_down"])
            # Per-codec twins of the unlabeled total.
            for codec_name, nb in rec.get("bytes_up_by_codec", {}).items():
                tel.counter(
                    "fedtpu_rpc_bytes_up_total",
                    "client -> server StartTrain reply bytes (successful)",
                    labels={"codec": codec_name},
                ).inc(nb)
            tel.counter(
                "fedtpu_stragglers_total",
                "client-rounds lost to stragglers (deadline, in-flight)",
            ).inc(rec["stragglers"])
            for ph in ("collect", "decode", "h2d", "aggregate"):
                tel.histogram(
                    "fedtpu_round_phase_seconds",
                    "per-round phase wall time by phase label",
                    labels={"phase": ph},
                ).observe(rec[f"t_{ph}_s"])
            if "t_round_s" in rec:
                tel.gauge(
                    "fedtpu_step_time_seconds",
                    "wall time of the last round dispatch, per round",
                ).set(rec["t_round_s"])
        return rec

    def _round_body(self, rspan) -> dict:
        cfg = self.cfg
        lay = self.layout
        tel = self.telemetry
        # One lineage round for every StartTrain of this round, a late
        # retry's included: the client's replay detection reads it.
        lineage_round = self._round_counter
        self.status.update(round=self._round_counter, phase="collect")
        if self.chaos is not None:
            # rounds= windows key on the lineage round.
            self.chaos.set_round(self._round_counter)
        if not self._did_initial_sync:
            self.sync_clients()
        # The roster of this round: a join or leave mid-round counts from
        # the next. Quarantined members are served and screened, and their
        # updates dropped.
        active = self.registry.active_clients()
        quarantined_now = set(self.registry.quarantined_clients())
        members_now = self.registry.size
        membership_version = self.registry.version
        roster_now = self.registry.clients
        frac = cfg.fed.participation_fraction
        if frac < 1.0 and active:
            # Seeded from the lineage counter, as fedtpu seeds it.
            rng = np.random.default_rng(cfg.data.seed * 7919 + self._round_counter)
            k = max(1, int(round(frac * len(active))))
            active = sorted(rng.choice(np.asarray(active), size=k, replace=False).tolist())
        # The partition width is the seat capacity, stable under churn; a
        # root's spans its aggregators' cohorts.
        world = self.registry.capacity()
        tiered = self.tier_fanout > 0
        if tiered:
            world = world * self.tier_fanout
        global_now = self.global_tree
        cuda = self.device.type == "cuda"
        # The round's global on the host, for dense replies; built once, on
        # the first dense reply.
        cache: Dict[str, Any] = {}
        cache_lock = threading.Lock()

        def global_host():
            with cache_lock:
                if "g" not in cache:
                    cache["g"] = self._host_model(global_now)
                return cache["g"]

        payload_like = dict(self._model_template, num_examples=np.zeros((), np.float32))
        results: Dict[str, tuple] = {}
        latencies: Dict[str, float] = {}
        bytes_up = Counter()
        bytes_down = Counter()
        codec_of: Dict[str, tuple] = {}
        # A root's count of the clients behind the round's partials.
        clients_in = Counter()
        decode_s = Counter()
        h2d_s = Counter()
        stream = self.server_pipeline == "stream"
        # The round's rows, one per launched client, in the edge's layout:
        # a host buffer (pinned on the card's host) that replies decode
        # into, and for the stream pipeline its twin on the device, written
        # row by row as replies land. Per round, like ``results``: a
        # straggler of an earlier round holds its own round's buffers.
        row_of: Dict[str, int] = {}
        host_buf: List[torch.Tensor] = []
        dev_buf: List[torch.Tensor] = []
        copied: Dict[int, Any] = {}  # row -> event of its last device copy
        stream_lock = threading.Lock()

        def train_one(rank: int, client: str, stub: TrainerStub) -> None:
            # One codec choice a client a round, before the attempt: a retry
            # asks for the same codec.
            codec_req = self._codec_policy.choose(rank) if self._codec_policy is not None else None

            def attempt():
                # One attempt includes the decode: a reply failing its CRC
                # raises WireError and is asked for again.
                if tiered:
                    # One pulled partial: the aggregator's cohort trains,
                    # and its pre-weighted sum comes back as one record.
                    reply = stub.SubmitPartial(
                        proto.SubmitPartialRequest(
                            rank_base=rank * self.tier_fanout, world=world,
                            round=lineage_round, epoch=self._coord_epoch,
                        ),
                        timeout=self._deadlines["SubmitPartial"],
                    )
                    data = reply.record
                else:
                    reply = stub.StartTrain(
                        proto.TrainRequest(
                            rank=rank, world=world, round=lineage_round, epoch=self._coord_epoch,
                            codec=proto.CODEC_IDS.get(codec_req, 0),
                        ),
                        timeout=self._deadlines["StartTrain"],
                    )
                    data = reply.message
                i = row_of[client]
                done = copied.get(i)
                if done is not None:
                    done.synchronize()  # a retry rewrites the row only once it was read
                row = host_buf[0][i].numpy()
                t0 = time.monotonic()
                with tel.span("decode", client=client):
                    if sparse.is_sparse_payload(data):
                        extra = sparse.decode_into_row(data, lay.sizes, row)
                    else:
                        # Dense full weights: the delta against the round's global.
                        extra = wire.decode_into_row(data, payload_like, global_host(), row)
                t1 = time.monotonic()
                decode_s.inc(t1 - t0)
                kind = extra.pop("_codec", None)
                if stream:
                    # Ship the row now, overlapping the other clients'
                    # wait; a straggler landing after the round closed its
                    # buffer writes nothing.
                    with tel.span("h2d", client=client), stream_lock:
                        if dev_buf:
                            dev_buf[0][i].copy_(host_buf[0][i], non_blocking=True)
                            if cuda:
                                ev = torch.cuda.Event()
                                ev.record()
                                copied[i] = ev
                    h2d_s.inc(time.monotonic() - t1)
                if tiered:
                    clients_in.inc(reply.clients)
                bytes_up.inc(len(data))
                codec_of[client] = (_CODEC_OF_KIND.get(kind, "none"), len(data))
                # A root's combine weight is the partial's weight sum.
                return i, float(extra["weight_sum" if tiered else "num_examples"])

            rpc_name = "SubmitPartial" if tiered else "StartTrain"
            try:
                t_rpc = time.monotonic()
                # Parented to the round by id: this runs on a collect thread.
                with tel.span("submit_partial" if tiered else "client_rpc",
                              parent=rspan.id, client=client):
                    results[client] = call_with_retry(
                        self.retry_policy, rpc_name, attempt, peer=client,
                        telemetry=self.telemetry, rand=self._retry_rand,
                    )
                latencies[client] = time.monotonic() - t_rpc
                tel.histogram(
                    "fedtpu_client_rpc_seconds",
                    "per-client StartTrain wall time (RPC + decode, "
                    "retries included; successful rounds only)",
                ).observe(latencies[client])
                if self._codec_policy is not None and client in codec_of:
                    # Taught with the codec the reply used.
                    used, nbytes = codec_of[client]
                    self._codec_policy.observe(rank, used, nbytes, latencies[client])
            except (grpc.RpcError, wire.WireError) as e:
                if is_stale_coordinator(e):
                    # An aggregator relays its cohort's rejection on the
                    # same typed status: the fence whichever tier saw it.
                    self._handle_stale(rpc_name, client, e)
                    return
                # A fatal status or an exhausted budget; an aggregator's
                # SUB_QUORUM and UNSYNCED_AGGREGATOR are fatal, and its row
                # is masked like a failed client's.
                kind_of = "aggregator" if tiered else "client"
                if isinstance(e, grpc.RpcError):
                    log.warning("%s %s failed during %s: %s %s", kind_of, client, rpc_name, e.code(), e.details())
                else:
                    log.warning("%s %s %s reply still corrupt after retries: %s", kind_of, client, rpc_name, e)
                tel.counter(
                    "fedtpu_rpc_failures_total",
                    "RpcErrors by failing RPC",
                    labels={"rpc": rpc_name},
                ).inc()
                self.registry.mark_failed(client)

        # A straggler whose earlier StartTrain is still running sits out.
        still_busy = [c for c in active if c in self._inflight and self._inflight[c].is_alive()]
        if still_busy:
            log.warning("stragglers still in flight, skipping: %s", still_busy)
        # With a codec, a client whose last broadcast is still in flight
        # has a stale baseline for its delta: it sits out too. A dense reply
        # is delta'd against the current global here, so it trains on.
        unsynced = []
        if cfg.fed.compression != "none":
            unsynced = [
                c for c in active
                if c not in still_busy and c in self._sends and self._sends[c].is_alive()
            ]
            if unsynced:
                log.warning("sparse mode: broadcast still in flight, sitting out: %s", unsynced)
        with self._member_lock:
            stub_of = dict(self._stubs)
        # A client's rank is its seat, whoever else was sampled or skipped.
        rank_of = self.registry.seat_map()
        launch = [
            c for c in active
            if c not in still_busy and c not in unsynced and c in stub_of and c in rank_of
        ]
        if launch:
            row_of.update({c: i for i, c in enumerate(launch)})
            host_buf.append(torch.zeros((len(launch), lay.padded), dtype=torch.float32, pin_memory=cuda))
            if stream:
                dev_buf.append(torch.zeros((len(launch), lay.padded), dtype=torch.float32, device=self.device))
            if tiered and tel.enabled:
                tel.gauge(
                    "fedtpu_partial_rows_buffered",
                    "partial-sum rows (one per sub-aggregator) buffered "
                    "toward this round's root combine",
                ).set(len(launch))
        t_launch = time.monotonic()
        with tel.span("collect", launched=len(launch)):
            threads = {
                client: threading.Thread(target=train_one, args=(rank_of[client], client, stub_of[client]))
                for client in launch
            }
            for t in threads.values():
                t.start()
            if self.round_deadline_s is None:
                for t in threads.values():
                    t.join()
                stragglers = still_busy + unsynced
            else:
                deadline = time.monotonic() + self.round_deadline_s
                for t in threads.values():
                    t.join(max(0.0, deadline - time.monotonic()))
                stragglers = still_busy + unsynced + [c for c, t in threads.items() if t.is_alive()]
                if stragglers:
                    log.warning(
                        "round deadline %.1fs hit; aggregating without %s", self.round_deadline_s, stragglers
                    )
        t_barrier = time.monotonic()
        # Merge over the surviving earlier entries: a straggler of two
        # rounds ago may still run.
        self._inflight = {c: t for c, t in {**self._inflight, **threads}.items() if t.is_alive()}
        completed = {c: results[c] for c in active if c in results and c not in stragglers}
        abort_args = (completed, stragglers, world, roster_now, membership_version,
                      bytes_up, t_launch, t_barrier, decode_s, h2d_s)

        if self._fenced:
            # Fenced mid-round: void the round before anything commits.
            with stream_lock:
                dev_buf.clear()
            log.warning(
                "round %d voided: coordinator fenced mid-round (epoch %d superseded); "
                "global model untouched", self._round_counter, self._coord_epoch,
            )
            return self._abort_record({"fenced": True}, *abort_args)

        # The quorum counts against the current membership, or the sampled
        # set under participation sampling.
        quorum = cfg.fed.round_quorum
        quorum_base = len(active) if frac < 1.0 else members_now
        needed = max(1, math.ceil(quorum * quorum_base)) if quorum > 0 else 0
        if needed and len(completed) < needed:
            with stream_lock:
                dev_buf.clear()
            log.warning(
                "round %d aborted: %d/%d replies below quorum %.2f of %d members; "
                "global model untouched, will re-run",
                self._round_counter, len(completed), needed, quorum, quorum_base,
            )
            return self._abort_record({"quorum_needed": needed}, *abort_args)

        self.status.update(phase="aggregate")
        order = [c for c in active if c in completed]
        rows = None
        if order:
            idx = torch.tensor([row_of[c] for c in order], dtype=torch.int64)
            if stream:
                # Close the buffer under the lock (no late write after it),
                # then gather the surviving rows, in the barrier's order.
                with stream_lock:
                    buf = dev_buf.pop()
                rows = buf if order == launch else buf[idx.to(self.device)]
            else:
                t0 = time.monotonic()
                rows = host_buf[0][idx].to(self.device, non_blocking=True)
                h2d_s.inc(time.monotonic() - t0)
        # Screening and reputation, over the same rows the combine reads.
        screened_names: List[str] = []
        if self._screen_cfg is not None and order:
            sc = self._screen_cfg
            with tel.span("screen", participants=len(order)):
                live = torch.tensor(
                    [c not in quarantined_now for c in order], dtype=torch.float32, device=self.device
                )
                keep, _ = flat_ops.screen_rows(rows, live, sc.norm_max, sc.zmax, sc.cos_min)
                keep = keep.cpu().numpy()
            screened_names = [c for i, c in enumerate(order) if not bool(keep[i])]
            self._update_reputation(order, set(screened_names), quarantined_now)
            if screened_names:
                log.warning("round %d: screening rejected %s", self._round_counter, screened_names)
                tel.counter(
                    "fedtpu_screening_rejected_total",
                    "client rows rejected by the fused screening stage, "
                    "by surface",
                    labels={"surface": "server"},
                ).inc(len(screened_names))
        dropped = set(screened_names) | (quarantined_now & set(completed))
        if dropped:
            keep_idx = [i for i, c in enumerate(order) if c not in dropped]
            if len(keep_idx) != len(order):
                rows = rows[torch.tensor(keep_idx, dtype=torch.int64, device=self.device)]
            order = [c for c in order if c not in dropped]

        if order:
            with tel.span("aggregate", participants=len(order)):
                if cfg.fed.weighted or tiered:
                    # A root's weights are the partials' weight sums, the
                    # configured weighting already applied below it.
                    weights = torch.tensor([completed[c][1] for c in order], dtype=torch.float32)
                else:
                    weights = torch.ones((len(order),), dtype=torch.float32)
                weights = weights.to(self.device)
                if tiered:
                    # Pre-weighted sums: summed, then divided once.
                    new_global, self._server_opt_state = aggregation.finalize_partial(
                        cfg, lay, global_now, rows, weights, self._server_opt_state, server=self._server_opt
                    )
                elif stream:
                    new_global, self._server_opt_state = aggregation.finalize_stream(
                        cfg, lay, global_now, rows, weights, self._server_opt_state, server=self._server_opt
                    )
                else:
                    stacked = _split_collections(flat_ops.unpack_stacked(lay, rows))
                    new_global, self._server_opt_state = aggregation.aggregate(
                        cfg, global_now, stacked, weights, self._server_opt_state,
                        self._round_counter, server=self._server_opt,
                    )
                # Replaced, never written in place: a resync reading the old
                # tree meanwhile sends a whole model.
                self.global_tree = new_global
                if cuda:
                    torch.cuda.synchronize(self.device)
        t_done = time.monotonic()
        # The counter advances before replication: the replica carries the
        # next round's index.
        self._round_counter += 1
        self.status.update(phase="broadcast")
        payload = self.model_bytes()
        # The backup first, then the clients.
        if self.backup_stub is not None:
            replica = self.replica_bytes()
            try:
                with tel.span("replicate", parent=rspan.id):
                    self._send_model(self.backup_stub, replica, "backup")
                bytes_down.inc(len(replica))
            except grpc.RpcError as e:
                if is_stale_coordinator(e):
                    self._handle_stale("Replicate", "backup", e)
                else:
                    log.warning("backup unreachable during replication")
                    tel.counter(
                        "fedtpu_rpc_failures_total",
                        "RpcErrors by failing RPC",
                        labels={"rpc": "Replicate"},
                    ).inc()

        def send_one(client: str) -> None:
            stub = self._stub(client)
            if stub is None:
                return
            try:
                with tel.span("broadcast", parent=rspan.id, client=client):
                    self._send_model(stub, payload, client)
                bytes_down.inc(len(payload))
            except grpc.RpcError as e:
                if is_stale_coordinator(e):
                    self._handle_stale("SendModel", client, e)
                    return
                log.warning("client %s failed during SendModel: %s %s", client, e.code(), e.details())
                tel.counter(
                    "fedtpu_rpc_failures_total",
                    "RpcErrors by failing RPC",
                    labels={"rpc": "SendModel"},
                ).inc()
                self.registry.mark_failed(client)

        # A client whose earlier broadcast is still in flight sits this one
        # out: two concurrent SendModels could install the older model last.
        send_busy = [
            c for c in self.registry.active_clients()
            if c in self._sends and self._sends[c].is_alive()
        ]
        if send_busy:
            log.warning("previous broadcast still in flight, skipping: %s", send_busy)
        send_threads = {
            c: threading.Thread(target=send_one, args=(c,))
            for c in self.registry.active_clients() if c not in send_busy
        }
        for t in send_threads.values():
            t.start()
        if self.round_deadline_s is None:
            for t in send_threads.values():
                t.join()
        else:
            deadline = time.monotonic() + self.round_deadline_s
            for t in send_threads.values():
                t.join(max(0.0, deadline - time.monotonic()))
        self._sends = {c: t for c, t in {**self._sends, **send_threads}.items() if t.is_alive()}

        rec = {
            "round": self._round_counter - 1,
            "epoch": self._coord_epoch,
            "participants": len(completed),
            "stragglers": len(stragglers),
            "world": world,
            "aggregated": len(order),
            "alive": [self.registry.is_alive(c) for c in roster_now],
            "membership_version": membership_version,
            # The round's row buffers: the host rows, and their device twin
            # on the stream pipeline.
            "buffer_bytes": (
                (2 if stream else 1) * host_buf[0].numel() * host_buf[0].element_size()
                if host_buf else 0
            ),
            "bytes_up": int(bytes_up.value),
            "bytes_down": int(bytes_down.value),
            "pipeline": self.server_pipeline,
            "bytes_up_by_codec": _sum_codec_bytes(codec_of[c] for c in completed if c in codec_of),
            # collect: launch to the last join; decode and h2d: summed over
            # replies (on the stream pipeline they overlap the wait; on the
            # barrier, h2d is the one copy after it); post_barrier: the
            # last reply to the new global.
            "t_collect_s": round(t_barrier - t_launch, 6),
            "t_decode_s": round(decode_s.value, 6),
            "t_h2d_s": round(h2d_s.value, 6),
            "t_aggregate_s": round(t_done - t_barrier, 6),
            "t_post_barrier_s": round(t_done - t_barrier, 6),
            "t_round_s": round(t_done - t_launch, 6),
        }
        if tiered:
            rec["tier_fanout"] = self.tier_fanout
            rec["clients_aggregated"] = int(clients_in.value)
        lat = latency_summary([(c, latencies[c]) for c in completed if c in latencies])
        if lat:
            rec["client_latency"] = lat
        if self._weights_ignored:
            rec["weights_ignored"] = True
        if self._screen_cfg is not None:
            rec["screened"] = screened_names
            rec["quarantined"] = sorted(self.registry.quarantined_clients())
        with self._member_lock:
            for codec_name, nb in rec["bytes_up_by_codec"].items():
                self._codec_bytes_up[codec_name] = self._codec_bytes_up.get(codec_name, 0) + nb
        self.history.append(rec)
        return rec

    def run(
        self,
        num_rounds: Optional[int] = None,
        stop: Optional[Callable[[], bool]] = None,
        on_round: Optional[Callable[[int, dict], None]] = None,
    ) -> List[dict]:
        """Drive rounds with the heartbeat and backup-ping threads running.
        ``stop()`` is polled between rounds (a demotion sets it);
        ``on_round(r, record)`` runs after each round, an aborted one too.
        A round below quorum is re-run after a heartbeat period, up to 50
        times in a row; a fenced round re-bases first."""
        if num_rounds is None:
            num_rounds = self.cfg.fed.num_rounds
        self.monitor.start()
        if self.pinger is not None:
            # The first ping is synchronous: a demoting backup's state must
            # land before round 0.
            self.pinger.tick()
            self.pinger.start()
        try:
            r = 0
            consecutive_aborts = 0
            while r < num_rounds:
                if stop is not None and stop():
                    log.info("round loop stopped (demotion) after %d rounds", r)
                    break
                if self._fenced:
                    self.handle_fence()
                    continue
                rec = self.round()
                if rec.get("aborted"):
                    if on_round is not None:
                        on_round(r, rec)
                    consecutive_aborts += 1
                    if consecutive_aborts >= 50:
                        log.error("round %d aborted %d times in a row below quorum; giving up",
                                  r, consecutive_aborts)
                        break
                    if rec.get("fenced"):
                        continue
                    time.sleep(self.monitor.period)
                    continue
                consecutive_aborts = 0
                log.info("round %d: %s", r, rec)
                if on_round is not None:
                    on_round(r, rec)
                r += 1
        finally:
            self.monitor.stop()
            if self.pinger is not None:
                self.pinger.stop()
        return self.history


# ----------------------------------------------------------------------- gate
class _MembershipGate(TrainerServicer):
    """The coordinator's inbound membership surface: Join admits the
    caller's serving address (and resyncs it with the global model), Leave
    evicts it. Every other RPC stays UNIMPLEMENTED: the gate is not a
    Trainer."""

    def __init__(self, primary: PrimaryServer):
        self.primary = primary

    def Join(self, request: proto.JoinRequest, context) -> proto.JoinReply:
        address = request.address.decode()
        if not address:
            return proto.JoinReply(admitted=0, message=b"empty address")
        out = self.primary.admit_client(address)
        return proto.JoinReply(
            admitted=1, seat=out["seat"], world=out["world"], version=out["version"],
            message=b"resynced" if out["resynced"] else b"pending resync",
        )

    def Leave(self, request: proto.LeaveRequest, context) -> proto.LeaveReply:
        out = self.primary.remove_client(request.address.decode(), reason="leave")
        return proto.LeaveReply(left=1 if out["left"] else 0, version=out["version"])

    def HeartBeat(self, request: proto.Request, context) -> proto.HeartBeatResponse:
        return proto.HeartBeatResponse(status=1)


# --------------------------------------------------------------------- backup
class BackupServer(TrainerServicer):
    """The backup's servicer and its failover: absorbs the primary's
    replica, answers its pings, and promotes to acting primary (a
    :class:`PrimaryServer` started from the replica, on a round loop of its
    own) when the watchdog expires; the recovering primary's first ping
    demotes it back."""

    def __init__(
        self,
        cfg: RoundConfig,
        clients: List[str],
        compress: bool = False,
        watchdog_timeout: Optional[float] = None,
        round_deadline_s: Optional[float] = None,
        flight=None,
        chaos=None,
        on_acting_round: Optional[Callable[[int, dict], None]] = None,
        device=None,
    ):
        """``on_acting_round(r, record)``: passed to the acting primary's
        round loop. ``device``: where an acting primary's tensors live,
        CUDA unless named. ``chaos`` arms the backup's server and, after a
        promotion, the acting primary's channels. ``flight``: the
        :class:`fedtpu_torch.obs.FlightRecorder` that every promote and
        demote dumps (one of its own when None); an acting primary records
        into it too."""
        validate_coordinator(cfg)
        self.cfg = cfg
        self.clients = clients
        self.compress = compress
        self.round_deadline_s = round_deadline_s
        self.on_acting_round = on_acting_round
        self.chaos = chaos
        self.device = resolve_device(device)
        if watchdog_timeout is None:
            watchdog_timeout = cfg.fed.ft_watchdog_timeout_s
        log.info("backup timings: watchdog=%.1fs chaos=%s", watchdog_timeout,
                 chaos.describe() if chaos is not None else "off")
        self.latest_model: Optional[bytes] = None
        self.acting: Optional[PrimaryServer] = None
        self.telemetry = Telemetry(cfg.fed.telemetry, role="backup")
        # Dumped on every promote and demote: the run-up to a role flip
        # survives even if the promoted process dies seconds later.
        self.flight = flight if flight is not None else FlightRecorder(role="backup")
        self.machine = FailoverStateMachine(
            timeout=watchdog_timeout, on_promote=self._promote, on_demote=self._demote,
            metrics=self.telemetry.registry if self.telemetry.enabled else None,
            flight=self.flight,
        )
        self.watchdog = WatchdogRunner(self.machine)
        # A fresh stop event and thread per promotion: a flapping primary
        # cannot re-arm a stopped acting primary.
        self._acting_stop: Optional[threading.Event] = None
        self._promote_thread: Optional[threading.Thread] = None
        # The largest coordinator epoch seen, on replication, pings and our
        # own promotions: a lower-epoch sender is a superseded primary.
        self._epoch_seen = -1

    def _fence_check(self, epoch: int, rpc: str, context) -> None:
        """Track the largest epoch; abort a stale sender (``context.abort``
        raises)."""
        if epoch < 0:
            return
        if epoch >= self._epoch_seen:
            self._epoch_seen = epoch
            return
        log.warning(
            "%s from stale coordinator epoch %d rejected (newest seen %d)",
            rpc, epoch, self._epoch_seen,
        )
        self.telemetry.counter(
            "fedtpu_ft_stale_rejected_total",
            "coordinator RPCs rejected for a stale fencing epoch, by rpc",
            labels={"rpc": rpc},
        ).inc()
        context.abort(
            grpc.StatusCode.FAILED_PRECONDITION,
            f"STALE_COORDINATOR: epoch {epoch} < {self._epoch_seen}",
        )

    def SendModel(self, request: proto.SendModelRequest, context) -> proto.SendModelReply:
        # A stale primary's replica never overwrites the slot.
        self._fence_check(request.epoch, "Replicate", context)
        self.latest_model = request.model
        return proto.SendModelReply(reply=b"replicated")

    def CheckIfPrimaryUp(self, request: proto.PingRequest, context) -> proto.PingResponse:
        recovering = request.req == b"1"
        # A superseded primary's steady pings are fenced (they must not
        # hold off a re-promotion); the recovering ping is the heal
        # handshake and passes whatever its epoch.
        if not recovering:
            self._fence_check(request.epoch, "CheckIfPrimaryUp", context)
        elif request.epoch > self._epoch_seen:
            self._epoch_seen = request.epoch
        return proto.PingResponse(value=self.machine.on_ping(recovering))

    def HeartBeat(self, request: proto.Request, context) -> proto.HeartBeatResponse:
        return proto.HeartBeatResponse(status=1)

    def FetchModel(self, request: proto.Request, context) -> proto.SendModelRequest:
        """The newest state held, for a recovered primary: the acting
        primary's replica once its round loop has drained, else the last
        replicated payload."""
        self._stop_acting(wait=300.0)
        acting = self.acting
        if acting is not None and acting.history:
            return proto.SendModelRequest(model=acting.replica_bytes())
        return proto.SendModelRequest(model=self.latest_model or b"")

    def Join(self, request: proto.JoinRequest, context) -> proto.JoinReply:
        """The backup's address is a stable join target: while acting, a
        join lands in the acting primary's roster (and rides its replica
        back to the recovered primary); in the backup role it is refused,
        pointing the joiner at the primary's gate."""
        acting = self.acting
        if self.machine.role is Role.ACTING_PRIMARY and acting is not None:
            return _MembershipGate(acting).Join(request, context)
        return proto.JoinReply(admitted=0, message=b"not primary")

    def Leave(self, request: proto.LeaveRequest, context) -> proto.LeaveReply:
        acting = self.acting
        if self.machine.role is Role.ACTING_PRIMARY and acting is not None:
            return _MembershipGate(acting).Leave(request, context)
        return proto.LeaveReply(left=0)

    def status_snapshot(self) -> dict:
        """fedtpu's ``/statusz`` feed for the backup role: the failover
        state (role, watchdog timeout, seconds since the primary's last
        ping, None before the first), whether a replica is held, the
        largest epoch seen, and while promoted the acting primary's own
        snapshot under ``acting``."""
        machine = self.machine
        since = machine.seconds_since_ping()
        snap = {
            "role": machine.role.value,
            "pid": os.getpid(),
            "watchdog_timeout_s": machine.timeout,
            "seconds_since_primary_ping": None if since == float("inf") else round(since, 3),
            "has_replica": self.latest_model is not None,
            "epoch_seen": self._epoch_seen,
        }
        acting = self.acting
        if acting is not None and machine.role is Role.ACTING_PRIMARY:
            snap["acting"] = acting.status_snapshot()
        return snap

    def health(self) -> Tuple[bool, str]:
        """The acting primary's verdict while acting, else ok."""
        acting = self.acting
        if self.machine.role is Role.ACTING_PRIMARY and acting is not None:
            return acting.health()
        return True, "ok"

    def _promote(self) -> None:
        log.warning("watchdog expired: promoting to acting primary")
        self._stop_acting()
        stop_event = threading.Event()
        self._acting_stop = stop_event
        kw = dict(compress=self.compress, round_deadline_s=self.round_deadline_s, flight=self.flight,
                  chaos=self.chaos, device=self.device)
        try:
            acting = PrimaryServer(self.cfg, self.clients, initial_model=self.latest_model, **kw)
        except wire.WireError:
            # A corrupted replica must not leave the federation with no
            # primary: promote with a fresh model, and say so.
            log.exception(
                "replicated model is corrupted or config-mismatched; "
                "promoting with a freshly initialised model"
            )
            acting = PrimaryServer(self.cfg, self.clients, **kw)
        # The promotion epoch: past the replicated lineage's and past every
        # epoch seen on the wire.
        acting._set_epoch(max(acting._coord_epoch, self._epoch_seen) + 1)
        acting._role = 2
        self._epoch_seen = acting._coord_epoch
        log.warning("promotion minted coordinator epoch %d", acting._coord_epoch)
        self.acting = acting

        def run_acting():
            acting.run(stop=stop_event.is_set, on_round=self.on_acting_round)
            if acting.history:
                self.latest_model = acting.replica_bytes()

        self._promote_thread = threading.Thread(target=run_acting, daemon=True)
        self._promote_thread.start()

    def _demote(self) -> None:
        # Inside the ping's handler: signal only; FetchModel awaits the drain.
        log.warning("primary recovered: demoting to backup")
        if self._acting_stop is not None:
            self._acting_stop.set()

    def _stop_acting(self, wait: float = 120.0) -> None:
        if self._acting_stop is not None:
            self._acting_stop.set()
        # Two callers (the watchdog's demotion and a FetchModel) can stop
        # the same acting primary: read the thread once, and clear the
        # attribute only while it still holds that thread.
        thread = self._promote_thread
        if thread is not None:
            thread.join(timeout=wait)
            if not thread.is_alive() and self._promote_thread is thread:
                self._promote_thread = None

    def start(self, address: str):
        """Serve the backup on ``address`` and start the watchdog; returns
        the gRPC server."""
        server = create_server(address, self, compress=self.compress, chaos=self.chaos)
        server.start()
        self.watchdog.start()
        return server


# --------------------------------------------------------------------- client
class ClientAgent(TrainerServicer):
    """The servicer of one federated client."""

    def __init__(
        self,
        cfg: RoundConfig,
        seed: int = 0,
        state_dir: Optional[str] = None,
        device=None,
        data: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        eval_data: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    ):
        self.trainer = LocalTrainer(
            cfg, seed=seed, state_dir=state_dir, device=device, data=data, eval_data=eval_data
        )
        self.last_eval: Optional[Tuple[float, float]] = None
        # Fencing: the highest coordinator epoch seen (-1 until a peer
        # advertises one; pre-fencing coordinators are never rejected), and
        # the rejections by RPC.
        self._max_epoch = -1
        self._epoch_lock = threading.Lock()
        self.stale_rejected = {}

    def _fence_check(self, epoch: int, rpc: str, context) -> None:
        """Track the highest coordinator epoch; abort a stale sender
        (``context.abort`` raises)."""
        if epoch < 0:
            return
        with self._epoch_lock:
            if epoch >= self._max_epoch:
                self._max_epoch = epoch
                return
            newest = self._max_epoch
            self.stale_rejected[rpc] = self.stale_rejected.get(rpc, 0) + 1
        log.warning(
            "%s from stale coordinator epoch %d rejected (newest seen %d)",
            rpc, epoch, newest,
        )
        self.trainer.telemetry.counter(
            "fedtpu_ft_stale_rejected_total",
            "coordinator RPCs rejected for a stale fencing epoch, by rpc",
            labels={"rpc": rpc},
        ).inc()
        context.abort(
            grpc.StatusCode.FAILED_PRECONDITION,
            f"STALE_COORDINATOR: epoch {epoch} < {newest}",
        )

    def StartTrain(self, request: proto.TrainRequest, context) -> proto.TrainReply:
        self._fence_check(request.epoch, "StartTrain", context)
        payload = self.trainer.train_round(
            request.rank, request.world,
            trace_ctx=trace_context_of(context),
            coord_round=request.round,
            # 0 or an id this client does not know: the configured codec.
            codec_override=proto.CODEC_NAMES.get(request.codec),
        )
        return proto.TrainReply(message=payload)

    def SendModel(self, request: proto.SendModelRequest, context) -> proto.SendModelReply:
        self._fence_check(request.epoch, "SendModel", context)
        self.trainer.set_global(request.model, trace_ctx=trace_context_of(context))
        self.last_eval = self.trainer.evaluate()
        log.info("global model installed: eval %s", self.last_eval)
        return proto.SendModelReply(reply=f"{self.last_eval[1]:.4f}".encode())

    def HeartBeat(self, request: proto.Request, context) -> proto.HeartBeatResponse:
        return proto.HeartBeatResponse(status=1)

    def status_snapshot(self) -> dict:
        t = self.trainer
        return {
            "role": t.telemetry.role or "client",
            "pid": os.getpid(),
            "round": t.round_idx,
            "synced": t.synced,
            "last_eval": (
                {"loss": self.last_eval[0], "acc": self.last_eval[1]}
                if self.last_eval else None
            ),
        }


def serve_client(
    address: str,
    cfg: RoundConfig,
    seed: int = 0,
    compress: bool = False,
    chaos=None,
    state_dir: Optional[str] = None,
    device=None,
    data: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    eval_data: Optional[Tuple[np.ndarray, np.ndarray]] = None,
):
    """Build and start a client agent's server on ``address``; returns
    ``(server, agent)``. The client trains on the card unless ``device``
    names another; ``data`` / ``eval_data`` as in :class:`LocalTrainer`.
    ``chaos`` (a :class:`fedtpu_torch.ft.chaos.FaultSchedule`) arms fault
    injection on the agent's inbound RPCs, and its attack rules make the
    client an attacker."""
    agent = ClientAgent(
        cfg, seed=seed, state_dir=state_dir, device=device, data=data, eval_data=eval_data
    )
    # The bind address is the client's flight identity and attack key.
    agent.trainer.telemetry.role = f"client:{address}"
    agent.trainer.identity = address
    if chaos is not None:
        tel = agent.trainer.telemetry
        chaos.attach(metrics=tel.registry if tel.enabled else None)
    agent.trainer.chaos = chaos
    server = create_server(address, agent, compress=compress, chaos=chaos)
    server.start()
    return server, agent
