"""Retry/backoff execution of federation RPCs under a ``RetryPolicy``.

The port's own copy of ``fedtpu.transport.retry``.

One helper, :func:`call_with_retry`, wraps every RPC the coordinator
issues (StartTrain fan-out, SendModel broadcast/initial sync/resync,
backup replication, FT probes, async workers). The unit of retry is the
caller's whole *attempt* closure — RPC **plus** reply decode — so a reply
whose payload fails the wire CRC (:class:`fedtpu_torch.transport.wire.WireError`,
a corrupted record in flight) is rejected and re-requested exactly like a
transient status code, instead of silently losing the client's round.

Classification is data-driven from ``RetryPolicy.transient_codes``
(status-code *names*, so the policy stays a hashable config value):
transient codes retry with exponential backoff + jitter and count into
``fedtpu_rpc_retries_total{rpc}``; fatal codes (UNIMPLEMENTED,
INVALID_ARGUMENT, ...) and exhausted budgets re-raise to the caller's
existing failure path — only THOSE ever reach ``mark_failed``.
"""

from __future__ import annotations

import logging
import random
import time
from typing import Callable, Optional, TypeVar

import grpc

from fedtpu_torch.config import RetryPolicy
from fedtpu_torch.transport.wire import WireError

log = logging.getLogger("fedtpu_torch.retry")

T = TypeVar("T")


def status_name(exc: grpc.RpcError) -> str:
    """The status-code NAME of an RpcError (``"UNKNOWN"`` when the error
    carries no code — e.g. a channel torn down mid-call)."""
    try:
        code = exc.code()
    except Exception:
        code = None
    return code.name if code is not None else "UNKNOWN"


def is_stale_coordinator(exc: BaseException) -> bool:
    """Is this a typed STALE_COORDINATOR fence rejection? Receivers abort
    with FAILED_PRECONDITION and a details string starting with the token,
    so a fenced sender can distinguish "I have been superseded" (self-demote
    and re-base) from an ordinary fatal RPC error (mark the peer failed).
    FAILED_PRECONDITION is deliberately NOT in ``transient_codes`` — a
    fence rejection must never be retried."""
    if not isinstance(exc, grpc.RpcError):
        return False
    try:
        code = exc.code()
        details = exc.details() or ""
    except Exception:
        return False
    return (code == grpc.StatusCode.FAILED_PRECONDITION
            and "STALE_COORDINATOR" in details)


def is_transient(exc: BaseException, policy: RetryPolicy) -> bool:
    """Retryable under ``policy``? Wire corruption is always transient
    (reject-and-retry: the bytes were damaged in flight, the peer is
    healthy); RpcErrors classify by status-code name; anything else —
    a programming error — is never retried."""
    if isinstance(exc, WireError):
        return True
    if isinstance(exc, grpc.RpcError):
        return status_name(exc) in policy.transient_codes
    return False


def backoff_s(policy: RetryPolicy, attempt: int,
              rand: Callable[[], float] = random.random) -> float:
    """Sleep before attempt ``attempt + 1`` (attempt is 1-based): exponential
    from ``backoff_s``, capped at ``backoff_max_s``, with up to ``jitter``
    fractional randomization on top."""
    base = min(
        policy.backoff_s * policy.backoff_multiplier ** (attempt - 1),
        policy.backoff_max_s,
    )
    return base * (1.0 + policy.jitter * rand())


def call_with_retry(
    policy: RetryPolicy,
    rpc: str,
    attempt_fn: Callable[[], T],
    peer: str = "",
    telemetry: Optional[object] = None,
    sleep: Callable[[float], None] = time.sleep,
    rand: Optional[Callable[[], float]] = None,
) -> T:
    """Run ``attempt_fn`` (one full RPC attempt, including reply decode) up
    to ``policy.max_attempts`` times. Transient failures back off and
    retry, incrementing ``fedtpu_rpc_retries_total{rpc}`` on ``telemetry``
    (a :class:`fedtpu_torch.obs.Telemetry`, or None); the final (or first fatal)
    exception propagates unchanged so callers keep their existing
    ``except grpc.RpcError`` / ``except WireError`` handling. ``rand``
    (a 0..1 draw, e.g. a seeded ``random.Random(...).random``) replaces
    the global jitter source so chaos-soak timing replays
    deterministically; None keeps the module default."""
    attempts = max(1, policy.max_attempts)
    for attempt in range(1, attempts + 1):
        try:
            return attempt_fn()
        except Exception as exc:
            if attempt >= attempts or not is_transient(exc, policy):
                raise
            if telemetry is not None:
                telemetry.counter(
                    "fedtpu_rpc_retries_total",
                    "transient RPC failures retried, by rpc",
                    labels={"rpc": rpc},
                ).inc()
            delay = backoff_s(policy, attempt, rand or random.random)
            why = (
                status_name(exc)
                if isinstance(exc, grpc.RpcError)
                else f"corrupt payload ({exc})"
            )
            log.warning(
                "transient %s%s failed (%s), attempt %d/%d; retrying in %.2fs",
                rpc, f" to {peer}" if peer else "", why, attempt, attempts,
                delay,
            )
            sleep(delay)
    raise AssertionError("unreachable")  # loop always returns or raises
