"""The gRPC ``federated.Trainer`` service: stub, servicer, server builder.

The port's own copy of ``fedtpu.transport.service``: the reference's four
unary RPCs (StartTrain, SendModel, HeartBeat, CheckIfPrimaryUp) and
fedtpu's additive ones (FetchModel, Join, Leave, SubmitPartial) on the
method paths protoc would generate (``/federated.Trainer/<Method>``), built
from generic handlers and the hand-rolled codec of
:mod:`fedtpu_torch.transport.proto`; 1 GiB message caps on channels and
servers, and optional transport gzip; fedtpu's fault-injection
interceptors (:mod:`fedtpu_torch.ft.chaos`) on a channel and a server;
and the client's half of dynamic membership (:func:`announce_join`,
:func:`announce_leave`). fedtpu's trace-propagation interceptor is not
ported yet: asking for it raises.
"""

from __future__ import annotations

import logging
import time
from concurrent import futures
from typing import Optional

import grpc

from fedtpu_torch.config import not_ported
from fedtpu_torch.transport import proto

log = logging.getLogger("fedtpu_torch.service")

SERVICE_NAME = "federated.Trainer"
MAX_MESSAGE_BYTES = 1024 * 1024 * 1024  # 1 GiB, reference: src/server.py:42-45

_CHANNEL_OPTIONS = [
    ("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
    ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
]

_METHODS = {
    # name: (request type, response type)
    "StartTrain": (proto.TrainRequest, proto.TrainReply),
    "SendModel": (proto.SendModelRequest, proto.SendModelReply),
    "HeartBeat": (proto.Request, proto.HeartBeatResponse),
    "CheckIfPrimaryUp": (proto.PingRequest, proto.PingResponse),
    # Additive extension beyond the reference's 4 RPCs: lets a recovered
    # primary PULL the newer global model from a backup that acted as
    # primary in its absence. The reference has no such path — an acting
    # primary's training progress is silently reverted on demotion (its
    # primary restarts from its own stale files). Unknown methods don't
    # affect interop on the original 4.
    "FetchModel": (proto.Request, proto.SendModelRequest),
    # Elastic membership (docs/FAULT_TOLERANCE.md): a client announces the
    # address it serves on and is admitted into (Join) or removed from
    # (Leave) the coordinator's MembershipTable. Served by the primary's
    # membership gate and by the backup (which delegates to its acting
    # primary after a failover, so joiners keep working mid-outage).
    "Join": (proto.JoinRequest, proto.JoinReply),
    "Leave": (proto.LeaveRequest, proto.LeaveReply),
    # Hierarchical aggregation (docs/ARCHITECTURE.md §Multi-tier): the root
    # PULLS one partial reduce per round from each leaf AggregatorServer —
    # same dial-out direction as StartTrain, so retry/quorum/fencing/trace
    # machinery applies unchanged. Additive method: legacy peers answer it
    # UNIMPLEMENTED (a fatal, non-retried code) and never see new bytes on
    # the original RPCs.
    "SubmitPartial": (proto.SubmitPartialRequest, proto.SubmitPartialReply),
}


class TrainerStub:
    """Client-side stub, same call surface as protoc's ``TrainerStub``
    (reference ``src/federated_pb2_grpc.py:8-36``)."""

    def __init__(self, channel: grpc.Channel):
        # Kept for lifecycle management: dynamic membership closes a
        # member's channel on eviction instead of leaking it.
        self._channel = channel
        for name, (req_t, resp_t) in _METHODS.items():
            setattr(
                self,
                name,
                channel.unary_unary(
                    f"/{SERVICE_NAME}/{name}",
                    request_serializer=lambda m: m.encode(),
                    response_deserializer=resp_t.decode,
                ),
            )


class TrainerServicer:
    """Abstract servicer, same surface as protoc's ``TrainerServicer``
    (reference ``src/federated_pb2_grpc.py:39-64``). Subclass and override."""

    def StartTrain(self, request: proto.TrainRequest, context) -> proto.TrainReply:
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError

    def SendModel(self, request: proto.SendModelRequest, context) -> proto.SendModelReply:
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError

    def HeartBeat(self, request: proto.Request, context) -> proto.HeartBeatResponse:
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError

    def CheckIfPrimaryUp(self, request: proto.PingRequest, context) -> proto.PingResponse:
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError

    def FetchModel(self, request: proto.Request, context) -> proto.SendModelRequest:
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError

    def Join(self, request: proto.JoinRequest, context) -> proto.JoinReply:
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError

    def Leave(self, request: proto.LeaveRequest, context) -> proto.LeaveReply:
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError

    def SubmitPartial(
        self, request: proto.SubmitPartialRequest, context
    ) -> proto.SubmitPartialReply:
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError


def add_trainer_servicer(servicer: TrainerServicer, server: grpc.Server) -> None:
    """Register ``servicer`` on ``server`` (parity:
    ``add_TrainerServicer_to_server``, ``src/federated_pb2_grpc.py:67-92``)."""
    handlers = {
        name: grpc.unary_unary_rpc_method_handler(
            getattr(servicer, name),
            request_deserializer=req_t.decode,
            response_serializer=lambda m: m.encode(),
        )
        for name, (req_t, resp_t) in _METHODS.items()
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(SERVICE_NAME, handlers),)
    )


def create_channel(address: str, compress: bool = False,
                   trace_source=None, chaos=None) -> grpc.Channel:
    """Insecure channel with 1 GiB caps and optional gzip. ``chaos`` (a
    :class:`fedtpu_torch.ft.chaos.FaultSchedule`) wraps it in the
    fault-injection interceptor keyed to this peer. ``trace_source``
    (trace propagation) is not ported yet and raises."""
    if trace_source is not None:
        raise not_ported("trace propagation over gRPC (trace_source=)", "slice 8")
    kwargs = {}
    if compress:
        kwargs["compression"] = grpc.Compression.Gzip
    channel = grpc.insecure_channel(address, options=_CHANNEL_OPTIONS, **kwargs)
    if chaos is not None:
        channel = grpc.intercept_channel(channel, chaos.client_interceptor(address))
    return channel


def create_server(
    address: str,
    servicer: TrainerServicer,
    compress: bool = False,
    max_workers: int = 10,
    chaos=None,
) -> grpc.Server:
    """Build (not start) a server hosting ``servicer`` on ``address``: 10
    workers, 1 GiB caps, optional gzip, an insecure port. ``chaos`` arms
    the fault-injection interceptor on every inbound call."""
    kwargs = {}
    if compress:
        kwargs["compression"] = grpc.Compression.Gzip
    if chaos is not None:
        kwargs["interceptors"] = (chaos.server_interceptor(),)
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
        options=_CHANNEL_OPTIONS,
        **kwargs,
    )
    add_trainer_servicer(servicer, server)
    server.add_insecure_port(address)
    return server


def announce_join(
    gate_address: str, my_address: str, timeout_s: float = 60.0, poll_s: float = 0.5,
) -> Optional[TrainerStub]:
    """The client's half of dynamic membership: announce ``my_address``
    (the address this client serves on, its member identity) to a
    coordinator's membership gate, retrying at ``poll_s`` until admitted
    or ``timeout_s`` passes; a refusal and an unreachable gate both wait
    (the gate may come up after the client). Returns the gate's stub, for
    :func:`announce_leave`, on admission; None on timeout."""
    stub = TrainerStub(create_channel(gate_address))
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            reply = stub.Join(proto.JoinRequest(address=my_address.encode()), timeout=5.0)
            if reply.admitted:
                log.info(
                    "admitted by gate %s: seat=%d world=%d membership v%d (%s)",
                    gate_address, reply.seat, reply.world, reply.version,
                    reply.message.decode(errors="replace"),
                )
                return stub
        except grpc.RpcError as exc:
            log.info("gate %s not ready (%s); retrying", gate_address, exc.code())
        time.sleep(poll_s)
    return None


def announce_leave(stub: TrainerStub, my_address: str) -> bool:
    """A graceful departure: one Leave on an :func:`announce_join` gate
    stub; False when the gate is unreachable (the heartbeat then treats us
    as a silent leaver)."""
    try:
        reply = stub.Leave(proto.LeaveRequest(address=my_address.encode()), timeout=5.0)
        return bool(reply.left)
    except grpc.RpcError as exc:
        log.warning("Leave failed (%s); departing silently", exc.code())
        return False


def probe(
    stub: TrainerStub, timeout: float = 1.0, policy=None, telemetry=None
) -> Optional[proto.HeartBeatResponse]:
    """One HeartBeat RPC; None on any RpcError (the reference's liveness
    probe semantics, ``src/server.py:86-99``). With ``policy`` (a
    :class:`fedtpu_torch.config.RetryPolicy`) transient failures retry with
    backoff first, so a one-packet blip during an FT probe doesn't read as
    a dead peer."""
    try:
        if policy is None:
            return stub.HeartBeat(proto.Request(), timeout=timeout)
        from fedtpu_torch.transport.retry import call_with_retry

        return call_with_retry(
            policy, "HeartBeat",
            lambda: stub.HeartBeat(proto.Request(), timeout=timeout),
            telemetry=telemetry,
        )
    except grpc.RpcError:
        return None
