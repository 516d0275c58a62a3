"""The mid tier of a two-tier federation: the port's own copy of
``fedtpu/transport/aggregator.py``.

An :class:`AggregatorServer` sits between a root coordinator (a
:class:`~fedtpu_torch.transport.federation.PrimaryServer` with
``tier_fanout``) and a cohort of ordinary client agents:

- downstream, it fans StartTrain out to its cohort with the primary's
  retry and heartbeat machinery, decodes each reply into its row of a
  ``[cohort, P]`` buffer on the card (the edge's flat layout), and folds the
  buffer into one pre-weighted sum row and its weight sum
  (:func:`fedtpu_torch.ops.flat.partial_reduce_rows`);
- upstream, it answers the root's SubmitPartial with that pair as one FSP1
  ``partial_flat`` record, so the root decodes one record an aggregator,
  not one a client.

The sum is not divided here: the root divides once, so for inputs whose
f32 adds are exact the two-tier mean is the flat mean bit for bit.

Faults compose as in fedtpu: the aggregator tracks the highest coordinator
epoch on its parent face, relays the root's epoch downstream unchanged, and
turns a cohort client's ``STALE_COORDINATOR`` into an aborted SubmitPartial
with the same text; a cohort below ``round_quorum`` (a quorum per tier)
aborts with ``SUB_QUORUM``, and an aggregator with no global model for a
dense cohort with ``UNSYNCED_AGGREGATOR``, both ``FAILED_PRECONDITION``, so
the root spends no retries and masks the row. ``cohort_source`` replaces
the gRPC cohort and ``template`` the model's structure: fedtpu's seams for
benches and tests.

Under ``telemetry="trace"`` the aggregator adopts the root's trace id and
nests its spans (``install_global``, ``broadcast``, ``submit_partial``,
``collect``, ``client_rpc``, ``decode``, ``partial_reduce``) under the
root's, and every channel it dials carries its own context down to the
cohort, so ``tools/trace_merge.py --check`` stitches all three tiers.

The buffer and the fold run on the card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import logging
import math
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import grpc
import numpy as np
import torch

from fedtpu_torch import models
from fedtpu_torch.config import RoundConfig, validate_retry_policy, validate_tier_config
from fedtpu_torch.core.engine import resolve_device
from fedtpu_torch.data import datasets
from fedtpu_torch.ft import HeartbeatMonitor, MembershipTable
from fedtpu_torch.ops import flat as flat_ops
from fedtpu_torch.transport import proto, sparse, wire
from fedtpu_torch.transport.retry import call_with_retry, is_stale_coordinator
from fedtpu_torch.transport.service import (
    TrainerServicer,
    TrainerStub,
    announce_join,
    announce_leave,
    create_channel,
    create_server,
    probe,
    trace_context_of,
)
from fedtpu_torch.obs import Telemetry, process_rss_bytes, propagate

__all__ = ["AggregatorServer", "CohortSource", "serve_aggregator"]

log = logging.getLogger("fedtpu_torch.aggregator")

# ``(round, rank_base, world) -> the round's encoded client replies``: a
# cohort without gRPC, whose payloads take the real decode and fold.
CohortSource = Callable[[int, int, int], List[bytes]]


def _model_template(cfg: RoundConfig) -> dict:
    """The config's model as the flax ``{"params", "batch_stats"}`` tree of
    f32 zeros in the edge's order and layout."""
    shape, _ = datasets.dataset_info(cfg.data.dataset)
    model = models.create(cfg.model, cfg.num_classes, shape)
    layout = flat_ops.make_tree_layout({
        "params": dict(model.named_parameters()),
        "batch_stats": dict(model.named_buffers()),
    })
    return flat_ops.flax_tree(layout, np.zeros(layout.total, np.float32))


class AggregatorServer(TrainerServicer):
    """The mid tier: StartTrain fan-out below, SubmitPartial above.
    ``clients`` is the cohort this process dials."""

    def __init__(
        self,
        cfg: RoundConfig,
        clients: Sequence[str] = (),
        parent: Optional[str] = None,
        compress: bool = False,
        chaos=None,
        cohort_source: Optional[CohortSource] = None,
        template: Optional[dict] = None,
        identity: str = "aggregator",
        device=None,
    ):
        validate_tier_config(cfg.fed, "AggregatorServer")
        self.cfg = cfg
        self.parent = parent
        self.identity = identity
        self.device = resolve_device(device)
        self.retry_policy = rp = validate_retry_policy(cfg.fed.retry)
        self._deadlines = {"StartTrain": rp.start_train_timeout_s, "SendModel": rp.send_model_timeout_s}
        self.chaos = chaos
        self._compress = compress
        self.telemetry = Telemetry(cfg.fed.telemetry, role=f"aggregator:{identity}")
        # The decode template of dense replies and of SendModel; the row's
        # sizes come from it, so root, tier and clients agree on P.
        self._template = _model_template(cfg) if template is None else template
        self._payload_template = dict(self._template, num_examples=np.zeros((), np.float32))
        self._sizes = [int(np.size(a)) for a in wire.tree_leaves(self._template)]
        self._total = sum(self._sizes)
        self._padded = max(flat_ops.LANE, math.ceil(max(self._total, 1) / flat_ops.LANE) * flat_ops.LANE)
        # The root's broadcast: its bytes (relayed as they are) and their
        # host tree (the base of dense replies); unset until the first.
        self._global_bytes: Optional[bytes] = None
        self._global_host: Optional[dict] = None
        self._global_lock = threading.Lock()
        # Parent-face fencing: the highest epoch on any inbound RPC.
        self._max_epoch = -1
        self._epoch_lock = threading.Lock()
        self._round_seen = -1
        self._last_partial: dict = {}
        self.cohort_source = cohort_source
        metrics = self.telemetry.registry if self.telemetry.enabled else None
        self.registry = MembershipTable(clients, metrics=metrics)
        self._member_lock = threading.Lock()
        self._stubs: Dict[str, TrainerStub] = {c: self._make_stub(c) for c in clients}
        self.monitor = HeartbeatMonitor(
            self.registry,
            probe=self._probe_member,
            resync=self._resync,
            period=cfg.fed.ft_heartbeat_period_s,
            metrics=metrics,
            probe_deadline_s=rp.max_attempts * (rp.probe_timeout_s + rp.backoff_max_s) + 1.0,
        )
        self._server: Optional[grpc.Server] = None
        self._gate_stub: Optional[TrainerStub] = None

    # ------------------------------------------------------------ plumbing
    def _make_stub(self, client: str) -> TrainerStub:
        return TrainerStub(create_channel(client, compress=self._compress,
                                          trace_source=self._trace_source, chaos=self.chaos))

    def _stub(self, client: str) -> Optional[TrainerStub]:
        with self._member_lock:
            if client not in self._stubs and self.registry.is_member(client):
                self._stubs[client] = self._make_stub(client)
            return self._stubs.get(client)

    def _trace_source(self) -> Optional[propagate.TraceContext]:
        tracer = self.telemetry.tracer
        if tracer is None:
            return None
        return propagate.TraceContext(
            trace_id=tracer.trace_id,
            span_id=tracer.current_id() or 0,
            role=self.telemetry.role or "aggregator",
            round=self._round_seen,
        )

    def _probe_member(self, client: str) -> bool:
        stub = self._stub(client)
        if stub is None:
            return False
        return probe(stub, timeout=self.retry_policy.probe_timeout_s, policy=self.retry_policy,
                     telemetry=self.telemetry) is not None

    def _resync(self, client: str) -> bool:
        """The current global to a revived cohort member; False when there
        is none yet or the send fails."""
        with self._global_lock:
            payload = self._global_bytes
        if payload is None:
            return False
        stub = self._stub(client)
        if stub is None:
            return False
        try:
            call_with_retry(
                self.retry_policy, "SendModel",
                lambda: stub.SendModel(
                    proto.SendModelRequest(model=payload, epoch=self._max_epoch),
                    timeout=self._deadlines["SendModel"],
                ),
                peer=client, telemetry=self.telemetry,
            )
            return True
        except grpc.RpcError:
            return False

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
        log.warning("%s from stale coordinator epoch %d rejected (newest seen %d)", rpc, epoch, newest)
        self.telemetry.counter(
            "fedtpu_ft_stale_rejected_total",
            "coordinator RPCs rejected for a stale fencing epoch, by rpc",
            labels={"rpc": rpc},
        ).inc()
        context.abort(grpc.StatusCode.FAILED_PRECONDITION, f"STALE_COORDINATOR: epoch {epoch} < {newest}")

    # ----------------------------------------------------- inbound surface
    def SendModel(self, request: proto.SendModelRequest, context) -> proto.SendModelReply:
        """Install the root's global and relay its bytes, as they are and
        with its epoch, to the cohort."""
        self._fence_check(request.epoch, "SendModel", context)
        ctx = trace_context_of(context)
        propagate.adopt(self.telemetry.tracer, ctx)
        with self.telemetry.span("install_global", **propagate.span_args(ctx)):
            tree = wire.decode(request.model, self._template)
            with self._global_lock:
                self._global_bytes = request.model
                self._global_host = {k: tree[k] for k in ("params", "batch_stats")}
        self.telemetry.counter(
            "fedtpu_rpc_bytes_down_total",
            "payload bytes shipped/received on the downstream face",
        ).inc(len(request.model))
        failed = self._relay_model(request.model, request.epoch)
        return proto.SendModelReply(reply=f"relayed:{self.cohort_size - failed}/{self.cohort_size}".encode())

    def _relay_model(self, payload: bytes, epoch: int) -> int:
        """The broadcast one tier down; returns the failures, each marked
        for the heartbeat's revival."""
        if self.cohort_source is not None:
            return 0  # a simulated cohort installs nothing
        failures = []

        def send_one(client: str) -> None:
            stub = self._stub(client)
            if stub is None:
                return
            try:
                with self.telemetry.span("broadcast", client=client):
                    call_with_retry(
                        self.retry_policy, "SendModel",
                        lambda: stub.SendModel(
                            proto.SendModelRequest(model=payload, epoch=epoch),
                            timeout=self._deadlines["SendModel"],
                        ),
                        peer=client, telemetry=self.telemetry,
                    )
            except grpc.RpcError:
                failures.append(client)
                self.telemetry.counter(
                    "fedtpu_rpc_failures_total", "RpcErrors by failing RPC",
                    labels={"rpc": "SendModel"},
                ).inc()
                self.registry.mark_failed(client)

        threads = [threading.Thread(target=send_one, args=(c,), daemon=True)
                   for c in self.registry.active_clients()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return len(failures)

    def HeartBeat(self, request: proto.Request, context) -> proto.HeartBeatResponse:
        return proto.HeartBeatResponse(status=1)

    def SubmitPartial(self, request: proto.SubmitPartialRequest, context) -> proto.SubmitPartialReply:
        """One pulled partial: the cohort trains, its replies are decoded
        into the ``[cohort, P]`` buffer and folded into one pre-weighted
        sum, answered as one ``partial_flat`` record."""
        self._fence_check(request.epoch, "SubmitPartial", context)
        ctx = trace_context_of(context)
        propagate.adopt(self.telemetry.tracer, ctx)
        self._round_seen = request.round
        t_start = time.monotonic()
        with self.telemetry.span("submit_partial", round=request.round, rank_base=request.rank_base,
                                 **propagate.span_args(ctx)) as pspan:
            reply = self._submit_partial_impl(request, context, pspan)
        self.telemetry.histogram(
            "fedtpu_round_phase_seconds",
            "per-round phase durations by phase",
            labels={"phase": "submit_partial"},
        ).observe(time.monotonic() - t_start)
        return reply

    def _submit_partial_impl(self, request: proto.SubmitPartialRequest, context, pspan) -> proto.SubmitPartialReply:
        tel = self.telemetry
        cfg = self.cfg
        if self.cohort_source is not None:
            payloads = self.cohort_source(request.round, request.rank_base, request.world)
            launch = [f"sim:{i}" for i in range(len(payloads))]
            payload_of = dict(zip(launch, payloads))
            rank_of = {c: request.rank_base + i for i, c in enumerate(launch)}
        else:
            with self._global_lock:
                synced = self._global_host is not None
            if not synced and cfg.fed.compression == "none":
                # Dense replies need the global as their base.
                context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                              "UNSYNCED_AGGREGATOR: no global model installed yet")
            payload_of = None
            launch = self.registry.active_clients()
            seats = self.registry.seat_map()
            rank_of = {c: request.rank_base + seats[c] for c in launch}
        members_now = max(self.registry.size, 1)
        if not launch:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, f"SUB_QUORUM: 0/{members_now} cohort members alive")

        buf = torch.zeros((len(launch), self._padded), dtype=torch.float32, device=self.device)
        row_of = {c: i for i, c in enumerate(launch)}
        tel.gauge(
            "fedtpu_buffer_bytes",
            "host+device bytes of the round's flat delta buffers, by tier",
            labels={"tier": "leaf"},
        ).set(buf.numel() * buf.element_size())
        tel.gauge(
            "fedtpu_partial_rows_buffered",
            "cohort rows currently buffered toward this tier's partial "
            "reduce",
        ).set(len(launch))
        results: Dict[str, float] = {}
        stale: List[str] = []
        lock = threading.Lock()

        def decode_one(client: str, data: bytes) -> float:
            # Staged on the host and copied into the card's row once; a
            # retry rewrites every real coordinate.
            row = buf[row_of[client]]
            with tel.span("decode", client=client):
                if sparse.is_sparse_payload(data):
                    extra = sparse.decode_into_row(data, self._sizes, row)
                else:
                    with self._global_lock:
                        base = self._global_host
                    extra = wire.decode_into_row(data, self._payload_template, base, row)
            tel.counter(
                "fedtpu_rpc_bytes_up_total",
                "payload bytes received on the upstream-bound face",
            ).inc(len(data))
            return float(extra["num_examples"])

        def train_one(client: str) -> None:
            def attempt() -> float:
                reply = self._stub(client).StartTrain(
                    proto.TrainRequest(rank=rank_of[client], world=request.world,
                                       round=request.round, epoch=request.epoch),
                    timeout=self._deadlines["StartTrain"],
                )
                return decode_one(client, reply.message)

            try:
                with tel.span("client_rpc", parent=pspan.id, client=client):
                    n = call_with_retry(self.retry_policy, "StartTrain", attempt, peer=client, telemetry=tel)
                with lock:
                    results[client] = n
            except (grpc.RpcError, wire.WireError) as e:
                if is_stale_coordinator(e):
                    # The cohort has seen a newer lineage: the root is the
                    # stale one; the client is healthy.
                    with lock:
                        stale.append(e.details() or "STALE_COORDINATOR")
                    return
                log.warning("cohort member %s failed StartTrain: %s", client, e)
                tel.counter(
                    "fedtpu_rpc_failures_total", "RpcErrors by failing RPC",
                    labels={"rpc": "StartTrain"},
                ).inc()
                self.registry.mark_failed(client)

        t0 = time.monotonic()
        with tel.span("collect", parent=pspan.id, cohort=len(launch)):
            if payload_of is not None:
                for client in launch:
                    try:
                        results[client] = decode_one(client, payload_of[client])
                    except wire.WireError as e:
                        log.warning("sim payload for %s rejected: %s", client, e)
            else:
                threads = [threading.Thread(target=train_one, args=(c,), daemon=True) for c in launch]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
        t_collect = time.monotonic() - t0
        tel.gauge("fedtpu_partial_rows_buffered", "").set(0)

        if stale:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, stale[0])
        quorum = cfg.fed.round_quorum
        needed = max(1, int(np.ceil(quorum * members_now))) if quorum > 0 else 0
        if len(results) < needed:
            tel.counter(
                "fedtpu_round_aborts_total",
                "rounds aborted below quorum, by surface",
                labels={"surface": "aggregator"},
            ).inc()
            context.abort(
                grpc.StatusCode.FAILED_PRECONDITION,
                f"SUB_QUORUM: {len(results)}/{members_now} cohort replies < quorum {quorum}",
            )
        if not results:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, f"SUB_QUORUM: 0/{members_now} cohort replies")

        order = [c for c in launch if c in results]
        keep = buf if len(order) == len(launch) else buf[torch.tensor([row_of[c] for c in order], device=self.device)]
        weights = torch.tensor(
            [results[c] for c in order] if cfg.fed.weighted else [1.0] * len(order),
            dtype=torch.float32, device=self.device,
        )
        cuda = self.device.type == "cuda"
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t1 = time.perf_counter()
        with tel.span("partial_reduce", parent=pspan.id, rows=len(order)):
            sum_row, weight_sum = flat_ops.partial_reduce_rows(keep, weights)
            if cuda:
                end.record()
            sum_row = sum_row[: self._total].cpu().numpy()
            weight_sum = float(weight_sum)
        reduce_ms = start.elapsed_time(end) if cuda else (time.perf_counter() - t1) * 1e3
        tel.histogram(
            "fedtpu_round_phase_seconds", "",
            labels={"phase": "partial_reduce"},
        ).observe(time.perf_counter() - t1)
        record = sparse.encode_partial_flat(
            sum_row, self._sizes,
            extra={
                "weight_sum": np.float32(weight_sum),
                "clients": np.int64(len(order)),
                "t_leaf_s": np.float32(time.monotonic() - t0),
            },
        )
        self._last_partial = {
            "round": request.round,
            "clients": len(order),
            "cohort": len(launch),
            "weight_sum": weight_sum,
            "t_collect_s": t_collect,
            "t_reduce_ms": reduce_ms,
            "buffer_bytes": int(buf.numel() * buf.element_size()),
            "record_bytes": len(record),
        }
        tel.counter("fedtpu_rounds_completed_total",
                    "partial reduces completed by this tier").inc()
        return proto.SubmitPartialReply(record=record, clients=len(order))

    # ---------------------------------------------------------- lifecycle
    @property
    def cohort_size(self) -> int:
        return self.registry.size

    def status_snapshot(self) -> dict:
        """fedtpu's ``/statusz`` feed of an aggregator, the parts the port
        keeps."""
        with self._global_lock:
            synced = self._global_host is not None
        return {
            "role": f"aggregator:{self.identity}",
            "pid": os.getpid(),
            "tier": "leaf",
            "parent": self.parent,
            "round": self._round_seen,
            "synced": synced,
            "clients": {
                "active": len(self.registry.active_clients()),
                "dead": len(self.registry.dead_clients()),
                "total": self.registry.size,
            },
            "mem": {
                "rss_bytes": process_rss_bytes(),
                "buffer_bytes": int(self._last_partial.get("buffer_bytes", 0)),
                "partial_rows_buffered": (
                    int(self.telemetry.registry.gauge("fedtpu_partial_rows_buffered", "").value)
                    if self.telemetry.enabled else 0
                ),
                "tier": "leaf",
            },
            "last_partial": dict(self._last_partial),
            "fencing": {"epoch_seen": self._max_epoch},
        }

    def start(self, address: str) -> grpc.Server:
        """Serve the upstream face on ``address``, start the cohort's
        heartbeat, and with a ``parent`` announce this address to its
        membership gate (an aggregator is a member of the root's roster)."""
        self._server = create_server(address, self, compress=self._compress, chaos=self.chaos)
        self._server.start()
        if self.registry.size and self.cohort_source is None:
            self.monitor.start()
        if self.parent:
            self._gate_stub = announce_join(self.parent, address)
            if self._gate_stub is None:
                log.warning("parent gate %s never admitted us", self.parent)
        return self._server

    def stop(self, grace: float = 0.5) -> None:
        """Leave the parent's roster (when it admitted us) and stop."""
        self.monitor.stop()
        if self._gate_stub is not None and self.identity:
            announce_leave(self._gate_stub, self.identity)
        if self._server is not None:
            self._server.stop(grace)


def serve_aggregator(
    address: str,
    cfg: RoundConfig,
    clients: Sequence[str] = (),
    parent: Optional[str] = None,
    compress: bool = False,
    chaos=None,
    cohort_source: Optional[CohortSource] = None,
    template: Optional[dict] = None,
    device=None,
):
    """Build and start an aggregator on ``address``, its identity; returns
    ``(server, aggregator)``. It runs on the card unless ``device`` names
    another."""
    agg = AggregatorServer(
        cfg, clients=clients, parent=parent, compress=compress, chaos=chaos,
        cohort_source=cohort_source, template=template, identity=address, device=device,
    )
    server = agg.start(address)
    return server, agg
