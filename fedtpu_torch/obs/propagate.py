"""Trace-context propagation over the gRPC edge: the port's own copy of
``fedtpu/obs/propagate.py``.

The tracer makes each process's spans consistent; this module makes them
consistent across a federation. The coordinator attaches a
``fedtpu-trace-bin`` metadata entry to every outbound RPC carrying:

- ``trace_id``: the federation-wide run identity (the coordinator tracer's
  random id, adopted by every client that sees it);
- ``span_id``: the sender-local id of the innermost open span on the
  issuing thread (the ``client_rpc`` span for collect workers, 0 when no
  span is open, e.g. heartbeat probes);
- ``role``: the sender's process identity ("primary", "backup", ...), which
  resolves a receiver's ``remote_parent`` to the right trace file at merge
  time;
- ``round``: the coordinator's lineage round counter.

The key and the payload are fedtpu's byte for byte, so a fedtpu primary
and port clients (or the other way round) share one trace. The payload is
JSON bytes (gRPC binary metadata: the ``-bin`` suffix is required for
non-ASCII values). Injection happens in a client-side interceptor whose
context source is injected; when the source returns ``None`` (telemetry
below ``trace``) the interceptor forwards the call untouched at the cost
of one function call.

Receivers (``fedtpu_torch.transport.service.trace_context_of``, then
``ClientAgent`` and ``LocalTrainer``) stamp the fields onto their own spans
as ``trace_id`` / ``remote_parent`` / ``remote_role`` args and adopt the
trace id: the cross-process link ``tools/trace_merge.py`` stitches on.

grpc is imported only when an interceptor is built.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Optional

METADATA_KEY = "fedtpu-trace-bin"


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """One RPC's propagated trace coordinates (see the module docstring)."""

    trace_id: str
    span_id: int = 0
    role: str = ""
    round: int = 0


def encode_context(ctx: TraceContext) -> bytes:
    return json.dumps(
        {
            "trace_id": ctx.trace_id,
            "span_id": int(ctx.span_id or 0),
            "role": ctx.role,
            "round": int(ctx.round),
        },
        separators=(",", ":"),
    ).encode()


def decode_context(data: bytes) -> Optional[TraceContext]:
    """None on any malformed payload: a bad peer never breaks an RPC."""
    try:
        obj = json.loads(data.decode())
        return TraceContext(
            trace_id=str(obj["trace_id"]),
            span_id=int(obj.get("span_id", 0)),
            role=str(obj.get("role", "")),
            round=int(obj.get("round", 0)),
        )
    except (ValueError, KeyError, TypeError, AttributeError):
        return None


def from_metadata(metadata) -> Optional[TraceContext]:
    """The context in gRPC invocation metadata (a sequence of ``(key,
    value)`` pairs), or None when absent or malformed."""
    if not metadata:
        return None
    for key, value in metadata:
        if key == METADATA_KEY:
            if isinstance(value, str):
                value = value.encode()
            return decode_context(value)
    return None


def span_args(ctx: Optional[TraceContext]) -> dict:
    """The receiver-side span args a propagated context contributes:
    ``trace_id`` (the coordinator's), ``remote_parent`` and
    ``remote_role`` (the cross-process parent link trace_merge resolves),
    and the coordinator's ``coord_round`` (named so it never collides with
    a receiver's own ``round=``). Empty without a context, so call sites
    can always ``**span_args(ctx)``."""
    if ctx is None:
        return {}
    args = {"trace_id": ctx.trace_id, "coord_round": ctx.round}
    if ctx.span_id:
        args["remote_parent"] = ctx.span_id
        args["remote_role"] = ctx.role
    return args


def adopt(tracer, ctx: Optional[TraceContext]) -> None:
    """Adopt the federation trace id on a receiver's tracer (idempotent; a
    no-op without a tracer or a context)."""
    if tracer is not None and ctx is not None and ctx.trace_id:
        tracer.trace_id = ctx.trace_id


# ------------------------------------------------------------- interceptor
def _build_interceptor_types():
    """The interceptor classes, built on first use so that this module
    loads without grpc."""
    import grpc

    class _CallDetails(grpc.ClientCallDetails):
        # grpc wants a ClientCallDetails, attribute-compatible with the one
        # it handed the interceptor.
        def __init__(self, base, metadata):
            self.method = base.method
            self.timeout = base.timeout
            self.metadata = metadata
            self.credentials = getattr(base, "credentials", None)
            self.wait_for_ready = getattr(base, "wait_for_ready", None)
            self.compression = getattr(base, "compression", None)

    class TraceContextInterceptor(grpc.UnaryUnaryClientInterceptor):
        """Appends ``fedtpu-trace-bin`` metadata when the injected source
        yields a context; forwards the call untouched otherwise."""

        def __init__(self, source: Callable[[], Optional[TraceContext]]):
            self._source = source

        def intercept_unary_unary(self, continuation, client_call_details,
                                  request):
            try:
                ctx = self._source()
            except Exception:
                ctx = None
            if ctx is None:
                return continuation(client_call_details, request)
            metadata = list(client_call_details.metadata or ())
            metadata.append((METADATA_KEY, encode_context(ctx)))
            return continuation(
                _CallDetails(client_call_details, metadata), request
            )

    return TraceContextInterceptor


def instrument_channel(channel,
                       source: Callable[[], Optional[TraceContext]]):
    """Wrap ``channel`` so every unary RPC carries the source's current
    context. ``source`` runs per RPC on the issuing thread, which is what
    lets the innermost span's id ride along."""
    import grpc

    return grpc.intercept_channel(channel, _build_interceptor_types()(source))
