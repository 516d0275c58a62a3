"""Seeded fault injection for the gRPC federation: the port's own copy of
``fedtpu/ft/chaos.py``.

A :class:`FaultSchedule` of :class:`FaultRule` entries, parsed from
fedtpu's spec strings by :func:`parse_spec`, decides per call which fault
fires; the same spec and seed inject the same faults at the same points in
both packages. Four classes of kinds, which never cross:

- wire kinds (``delay``, ``drop``, ``error``, ``corrupt``, ``kill``) and
  net kinds (``partition``, ``flaky``, link faults, group-keyed with
  ``peer=a|b`` and windowed with ``rounds=`` or the wall-clock
  ``window=``) fire from the gRPC interceptors,
  :meth:`FaultSchedule.client_interceptor` on a channel to one peer and
  :meth:`FaultSchedule.server_interceptor` on a server's inbound calls;
- attack kinds (``sign_flip``, ``scale``, ``noise``, ``label_flip``) are
  consulted by the client's trainer once a round
  (:meth:`FaultSchedule.decide_attack`, the pseudo-RPC ``Attack``) and
  transform the update it sends (:meth:`FaultSchedule.apply_attack_delta`);
- disk kinds (``ckpt_fail``, ``ckpt_torn``, ``ckpt_rot``, the pseudo-RPC
  ``Disk``) are consulted by the checkpoint store's save
  (:meth:`fedtpu_torch.checkpoint.Checkpointer.save`).

The draw rule is fedtpu's to the bit: each ``(rule, rpc, peer)`` stream
keeps its own counter, and its n-th draw fires iff
``crc32(f"{seed}|{rule}|{rpc}|{peer}|{n}") / 2**32 < p``. A rule at its
``max`` takes no draw; after ``consec`` fires in a row a stream passes
until one of its draws passes. The decision depends only on the seed and
on that stream's own calls, never on how threads interleave.

:meth:`FaultSchedule.attach` hooks a metrics registry and a flight
recorder: every injection counts into ``fedtpu_chaos_injected_total{kind,
rpc}`` (wire and disk faults) or ``fedtpu_attack_injected_total{kind}``
(attacks) and records a ``chaos`` or ``attack`` event. Importing this module
imports no grpc: the interceptors and the injected errors build their grpc
classes when first asked for.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import signal
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from fedtpu_torch.transport.wire import tree_map

log = logging.getLogger("fedtpu_torch.chaos")

WIRE_KINDS = ("delay", "drop", "error", "corrupt", "kill")
DISK_KINDS = ("ckpt_fail", "ckpt_torn", "ckpt_rot")
ATTACK_KINDS = ("sign_flip", "scale", "noise", "label_flip")
NET_KINDS = ("partition", "flaky")
KINDS = WIRE_KINDS + NET_KINDS + ATTACK_KINDS + DISK_KINDS
# The service's RPCs, the engine loop's pseudo-RPC, the attack consult and
# the checkpoint store's.
RPC_NAMES = (
    "StartTrain", "SendModel", "SubmitPartial", "HeartBeat",
    "CheckIfPrimaryUp", "FetchModel", "Round", "Attack", "Disk", "*",
)


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One fault: what to inject (``kind`` and its parameters) and where
    (rpc, peer, round or wall-clock window, probability, caps)."""

    kind: str
    rpc: str = "*"
    peer: str = "*"
    p: float = 1.0
    delay_s: float = 0.25
    code: str = "UNAVAILABLE"
    # Half-open [lo, hi) coordinator-round window; None = every round.
    rounds: Optional[Tuple[int, int]] = None
    # Half-open [lo, hi) seconds since the schedule was built; None = always.
    window: Optional[Tuple[float, float]] = None
    # Total injections this rule may make; None = unbounded.
    max_injections: Optional[int] = None
    # Fires in a row per (rule, rpc, peer) stream before a forced pass.
    max_consecutive: Optional[int] = None
    factor: float = 10.0      # scale: boost on the honest delta
    noise_std: float = 1.0    # noise: Gaussian std
    label_offset: int = 1     # label_flip: class shift (mod num_classes)
    # Colluding attackers share one draw (and one noise vector) a round.
    collude: bool = False

    @property
    def is_attack(self) -> bool:
        return self.kind in ATTACK_KINDS

    @property
    def is_disk(self) -> bool:
        return self.kind in DISK_KINDS

    @property
    def is_net(self) -> bool:
        return self.kind in NET_KINDS

    def validate(self) -> "FaultRule":
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; have {'|'.join(KINDS)}")
        if self.rpc not in RPC_NAMES:
            raise ValueError(f"unknown rpc {self.rpc!r}; have {'|'.join(RPC_NAMES)}")
        if self.is_attack and self.rpc not in ("Attack", "*"):
            raise ValueError(
                f"attack kind {self.kind!r} applies to the model update, "
                "not an RPC — leave rpc unset (it keys on the pseudo-RPC "
                "'Attack')"
            )
        if self.is_disk and self.rpc not in ("Disk", "*"):
            raise ValueError(
                f"disk kind {self.kind!r} applies to the checkpoint "
                "store, not an RPC — leave rpc unset (it keys on the "
                "pseudo-RPC 'Disk')"
            )
        if self.kind in WIRE_KINDS + NET_KINDS and self.rpc in ("Attack", "Disk"):
            raise ValueError(
                f"wire kind {self.kind!r} cannot target the pseudo-RPC "
                f"{self.rpc!r} (kind classes never cross)"
            )
        if self.is_net and self.rpc == "Round":
            raise ValueError(
                f"net kind {self.kind!r} models a LINK fault — it needs a "
                "wire RPC, not the engine-loop pseudo-RPC 'Round'"
            )
        if self.window is not None:
            lo, hi = self.window
            if lo < 0 or hi <= lo:
                raise ValueError(f"fault window must satisfy 0 <= lo < hi, got {lo}-{hi}")
        if self.kind == "scale" and self.factor == 0.0:
            raise ValueError("scale attack factor must be nonzero")
        if self.noise_std < 0:
            raise ValueError(f"noise std must be >= 0, got {self.noise_std}")
        if self.kind == "label_flip" and self.label_offset == 0:
            raise ValueError("label_flip offset must be nonzero")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"fault p must be in [0, 1], got {self.p}")
        if self.delay_s < 0:
            raise ValueError(f"fault delay must be >= 0, got {self.delay_s}")
        if self.max_injections is not None and self.max_injections < 1:
            raise ValueError("fault max must be >= 1")
        if self.max_consecutive is not None and self.max_consecutive < 1:
            raise ValueError("fault consec must be >= 1")
        return self


class FaultSchedule:
    """A seeded schedule of fault rules, consulted per call. Thread-safe;
    one instance serves every channel and server of a process."""

    def __init__(self, rules: List[FaultRule], seed: int = 0):
        self.rules = [r.validate() for r in rules]
        self.seed = int(seed)
        self._counts: Dict[Tuple[int, str, str], int] = {}
        self._streak: Dict[Tuple[int, str, str], int] = {}
        self._fired = [0] * len(self.rules)
        self._round: Optional[int] = None
        # Origin of the window= axis.
        self._t0 = time.monotonic()
        self._lock = threading.Lock()
        self._metrics = None
        self._flight = None

    # ------------------------------------------------------------ wiring
    def attach(self, metrics=None, flight=None) -> "FaultSchedule":
        """Hook the owning component's metrics registry and flight recorder
        (a later call with None keeps an earlier hook)."""
        if metrics is not None:
            self._metrics = metrics
        if flight is not None:
            self._flight = flight
        return self

    def set_round(self, round_idx: int) -> None:
        """The coordinator's current round, which ``rounds=`` windows key
        on (a schedule that never learns one matches any window)."""
        self._round = int(round_idx)

    # ---------------------------------------------------------- decision
    def _matches(self, rule: FaultRule, rpc: str, peer: str) -> bool:
        # Kind classes never cross: a wildcard wire rule never fires on the
        # attack or disk consult, nor an attack or disk rule on a wire call.
        if rule.is_attack != (rpc == "Attack"):
            return False
        if rule.is_disk != (rpc == "Disk"):
            return False
        if rule.rpc != "*" and rule.rpc != rpc:
            return False
        if rule.peer != "*" and peer not in rule.peer.split("|"):
            return False
        if rule.rounds is not None and self._round is not None:
            lo, hi = rule.rounds
            if not lo <= self._round < hi:
                return False
        if rule.window is not None:
            lo, hi = rule.window
            if not lo <= time.monotonic() - self._t0 < hi:
                return False
        return True

    def decide(self, rpc: str, peer: str = "*") -> Optional[FaultRule]:
        """The first rule that fires for this call, advancing the draw
        counters; None when the call proceeds untouched."""
        fired = None
        with self._lock:
            for i, rule in enumerate(self.rules):
                if not self._matches(rule, rpc, peer):
                    continue
                if rule.max_injections is not None and self._fired[i] >= rule.max_injections:
                    continue
                key = (i, rpc, peer)
                n = self._counts.get(key, 0)
                self._counts[key] = n + 1
                draw = f"{self.seed}|{i}|{rpc}|{peer}|{n}".encode()
                u = (zlib.crc32(draw) & 0xFFFFFFFF) / 2**32
                capped = (
                    rule.max_consecutive is not None
                    and self._streak.get(key, 0) >= rule.max_consecutive
                )
                if u < rule.p and not capped:
                    self._streak[key] = self._streak.get(key, 0) + 1
                    self._fired[i] += 1
                    fired = rule
                    break
                if u >= rule.p:
                    # Only a drawn pass re-arms a capped stream.
                    self._streak[key] = 0
        if fired is not None:
            self._record(fired, rpc, peer)
        return fired

    def _record(self, rule: FaultRule, rpc: str, peer: str) -> None:
        log.warning(
            "chaos: injecting %s on %s%s (round=%s)",
            rule.kind, rpc, f" -> {peer}" if peer != "*" else "", self._round,
        )
        if self._metrics is not None:
            if rule.is_attack:
                self._metrics.counter(
                    "fedtpu_attack_injected_total",
                    "model/data-level attacks executed by seeded "
                    "adversarial clients, by kind",
                    labels={"kind": rule.kind},
                ).inc()
            else:
                self._metrics.counter(
                    "fedtpu_chaos_injected_total",
                    "faults injected by the chaos schedule, by kind and rpc",
                    labels={"kind": rule.kind, "rpc": rpc},
                ).inc()
        if self._flight is not None:
            self._flight.record(
                "attack" if rule.is_attack else "chaos",
                fault=rule.kind, rpc=rpc, peer=peer, round=self._round,
            )

    def injected_total(self) -> int:
        with self._lock:
            return sum(self._fired)

    def describe(self) -> str:
        """The armed rules in one line, fedtpu's startup-log form."""
        parts = []
        for r in self.rules:
            opts = [f"p={r.p:g}"]
            if r.peer != "*":
                opts.append(f"peer={r.peer}")
            if r.rounds is not None:
                opts.append(f"rounds={r.rounds[0]}-{r.rounds[1]}")
            if r.window is not None:
                opts.append(f"window={r.window[0]:g}-{r.window[1]:g}")
            if r.max_injections is not None:
                opts.append(f"max={r.max_injections}")
            if r.max_consecutive is not None:
                opts.append(f"consec={r.max_consecutive}")
            if r.kind == "scale":
                opts.append(f"factor={r.factor:g}")
            elif r.kind == "noise":
                opts.append(f"std={r.noise_std:g}")
            elif r.kind == "label_flip":
                opts.append(f"offset={r.label_offset}")
            if r.collude:
                opts.append("collude=1")
            parts.append(f"{r.kind}@{r.rpc}:{','.join(opts)}")
        return f"seed={self.seed} " + "; ".join(parts)

    # ------------------------------------------------------- application
    def _kill(self, rpc: str) -> None:
        log.warning("chaos: SIGKILL of pid %d (rule on %s)", os.getpid(), rpc)
        if self._flight is not None:
            # SIGKILL leaves no exit path: the dump is the drill's record.
            try:
                self._flight.dump(reason="chaos:kill")
            except Exception:
                pass
        os.kill(os.getpid(), signal.SIGKILL)

    def apply_precall(self, rule: FaultRule, rpc: str) -> None:
        """A fired rule applied before a client's call goes out
        (``corrupt`` is applied to the reply instead)."""
        import grpc

        if rule.kind == "delay":
            time.sleep(rule.delay_s)
        elif rule.kind == "drop":
            time.sleep(rule.delay_s)
            raise ChaosRpcError(grpc.StatusCode.DEADLINE_EXCEEDED, "chaos: dropped request")
        elif rule.kind == "error":
            raise ChaosRpcError(getattr(grpc.StatusCode, rule.code), "chaos: injected error")
        elif rule.kind == "partition":
            raise ChaosRpcError(grpc.StatusCode.UNAVAILABLE, "chaos: partitioned link")
        elif rule.kind == "flaky":
            time.sleep(rule.delay_s)
            raise ChaosRpcError(getattr(grpc.StatusCode, rule.code), "chaos: flaky link")
        elif rule.kind == "kill":
            self._kill(rpc)

    def decide_attack(self, client: str, round_idx: Optional[int] = None) -> Optional[FaultRule]:
        """The attack consult of one training round: the first attack rule
        that fires for ``client`` (its serving address) at its local
        ``round_idx``; None trains honestly."""
        if round_idx is not None:
            self.set_round(round_idx)
        return self.decide("Attack", client)

    def apply_attack_delta(self, rule: FaultRule, delta: dict, peer: str, round_idx: int) -> dict:
        """A host delta tree (nested dicts of numpy arrays) transformed by
        a fired ``sign_flip``, ``scale`` or ``noise`` rule, fedtpu's
        arithmetic: one f32 multiply by the coefficient, then one f32 add
        of a normal draw per leaf in ``jax.tree.map`` order, from numpy's
        ``default_rng(crc32(f"{seed}|attack-noise|{who}|{round}"))``, where
        ``who`` is ``peer``, or ``*`` for colluders, who all send the same
        noise."""
        coef = {"sign_flip": -1.0, "scale": rule.factor}.get(rule.kind, 1.0)
        if coef != 1.0:
            delta = tree_map(
                lambda x: (np.asarray(x, np.float32) * coef).astype(np.asarray(x).dtype), delta
            )
        if rule.kind == "noise":
            who = "*" if rule.collude else peer
            rng = np.random.default_rng(zlib.crc32(f"{self.seed}|attack-noise|{who}|{round_idx}".encode()))
            delta = tree_map(
                lambda x: (
                    np.asarray(x, np.float32)
                    + rng.normal(0.0, rule.noise_std, np.shape(x)).astype(np.float32)
                ).astype(np.asarray(x).dtype),
                delta,
            )
        return delta

    def tick_round(self, round_idx: int) -> None:
        """One consult of the pseudo-RPC ``Round`` for a loop with no wire:
        ``delay`` sleeps, ``kill`` kills, other kinds are counted only."""
        self.set_round(round_idx)
        rule = self.decide("Round")
        if rule is None:
            return
        if rule.kind == "delay":
            time.sleep(rule.delay_s)
        elif rule.kind == "kill":
            self._kill("Round")

    # ------------------------------------------------------ interceptors
    def client_interceptor(self, peer: str):
        """A ``grpc.UnaryUnaryClientInterceptor`` that injects this
        schedule's faults on every call over one channel to ``peer``."""
        import grpc

        schedule = self

        class _CorruptedCall:
            """The continuation's call, its ``result()`` corrupted."""

            def __init__(self, inner):
                self._inner = inner

            def result(self, timeout=None):
                return _corrupt_message(self._inner.result())

            def __getattr__(self, name):
                return getattr(self._inner, name)

        class _ChaosClientInterceptor(grpc.UnaryUnaryClientInterceptor):
            def intercept_unary_unary(self, continuation, client_call_details, request):
                rpc = client_call_details.method.rsplit("/", 1)[-1]
                rule = schedule.decide(rpc, peer)
                if rule is not None and rule.kind != "corrupt":
                    schedule.apply_precall(rule, rpc)
                call = continuation(client_call_details, request)
                if rule is not None and rule.kind == "corrupt":
                    return _CorruptedCall(call)
                return call

        return _ChaosClientInterceptor()

    def server_interceptor(self):
        """A ``grpc.ServerInterceptor`` that injects this schedule's faults
        on every inbound unary call (the peer is unknown there: ``*``)."""
        import grpc

        schedule = self

        class _ChaosServerInterceptor(grpc.ServerInterceptor):
            def intercept_service(self, continuation, handler_call_details):
                handler = continuation(handler_call_details)
                if handler is None or handler.unary_unary is None:
                    return handler
                rpc = handler_call_details.method.rsplit("/", 1)[-1]
                inner = handler.unary_unary

                def behavior(request, context):
                    rule = schedule.decide(rpc)
                    if rule is not None:
                        if rule.kind in ("delay", "drop"):
                            time.sleep(rule.delay_s)
                            if rule.kind == "drop":
                                context.abort(grpc.StatusCode.DEADLINE_EXCEEDED, "chaos: dropped reply")
                        elif rule.kind == "error":
                            context.abort(getattr(grpc.StatusCode, rule.code), "chaos: injected error")
                        elif rule.kind == "partition":
                            context.abort(grpc.StatusCode.UNAVAILABLE, "chaos: partitioned link")
                        elif rule.kind == "flaky":
                            time.sleep(rule.delay_s)
                            context.abort(getattr(grpc.StatusCode, rule.code), "chaos: flaky link")
                        elif rule.kind == "kill":
                            schedule._kill(rpc)
                    response = inner(request, context)
                    if rule is not None and rule.kind == "corrupt":
                        response = _corrupt_message(response)
                    return response

                return grpc.unary_unary_rpc_method_handler(
                    behavior,
                    request_deserializer=handler.request_deserializer,
                    response_serializer=handler.response_serializer,
                )

        return _ChaosServerInterceptor()


_CHAOS_ERROR_TYPE = None


def ChaosRpcError(code, details: str):
    """An injected RPC failure: a real ``grpc.RpcError`` (its class built
    on first use), so the retry classifier and every ``except
    grpc.RpcError`` treat it as a failure off the wire."""
    global _CHAOS_ERROR_TYPE
    if _CHAOS_ERROR_TYPE is None:
        import grpc

        class _ChaosRpcError(grpc.RpcError):
            def __init__(self, code, details):
                super().__init__(f"chaos: {code} ({details})")
                self._code = code
                self._details = details

            def code(self):
                return self._code

            def details(self):
                return self._details

        _CHAOS_ERROR_TYPE = _ChaosRpcError
    return _CHAOS_ERROR_TYPE(code, details)


def _corrupt_message(msg):
    """Flip the last byte of the message's largest bytes field (past the
    FTP1/FSP1 header, so the CRC catches it, not the magic check); a
    message with no non-empty bytes field passes untouched."""
    target, size = None, 0
    for field in getattr(msg, "__dataclass_fields__", {}):
        value = getattr(msg, field)
        if isinstance(value, (bytes, bytearray)) and len(value) > size:
            target, size = field, len(value)
    if target is None:
        return msg
    raw = bytearray(getattr(msg, target))
    raw[-1] ^= 0xFF
    setattr(msg, target, bytes(raw))
    return msg


# ------------------------------------------------------------------ parsing
def parse_spec(spec: Optional[str]) -> Optional[FaultSchedule]:
    """A chaos spec -> an armed :class:`FaultSchedule` (None for an empty
    or absent one): JSON when it starts with ``{``, else the DSL
    ``kind@rpc:key=val,...`` with rules joined by ``;``. ValueError names
    the offending fragment."""
    if spec is None or not spec.strip():
        return None
    spec = spec.strip()
    if spec.startswith("{"):
        return _parse_json(spec)
    return _parse_dsl(spec)


def _parse_json(spec: str) -> FaultSchedule:
    try:
        obj = json.loads(spec)
    except json.JSONDecodeError as exc:
        raise ValueError(f"chaos spec is not valid JSON: {exc}") from exc
    rules = [_rule_from(dict(raw)) for raw in obj.get("rules", [])]
    if not rules:
        raise ValueError("chaos spec has no rules")
    return FaultSchedule(rules, seed=int(obj.get("seed", 0)))


# DSL option -> FaultRule field, where the names differ.
_DSL_FIELDS = {
    "delay": "delay_s", "max": "max_injections", "consec": "max_consecutive",
    "std": "noise_std", "offset": "label_offset",
}


def _parse_dsl(spec: str) -> FaultSchedule:
    rules, seed = [], 0
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        head, _, opt_str = part.partition(":")
        kind, _, rpc = head.partition("@")
        fields: dict = {"kind": kind.strip(), "rpc": rpc.strip() or "*"}
        for opt in filter(None, (o.strip() for o in opt_str.split(","))):
            key, eq, val = opt.partition("=")
            if not eq:
                raise ValueError(f"chaos option {opt!r} is not key=value")
            key, val = key.strip(), val.strip()
            if key == "seed":
                seed = int(val)
            elif key in ("p", "peer", "code", "rounds", "window", "factor"):
                fields[key] = val
            elif key in _DSL_FIELDS:
                fields[_DSL_FIELDS[key]] = val
            elif key == "collude":
                fields["collude"] = val not in ("0", "false", "False", "")
            else:
                raise ValueError(
                    f"unknown chaos option {key!r} in {part!r}; have "
                    "p|peer|delay|code|rounds|window|max|consec|seed|"
                    "factor|std|offset|collude"
                )
        rules.append(_rule_from(fields))
    if not rules:
        raise ValueError("chaos spec has no rules")
    return FaultSchedule(rules, seed=seed)


def _rule_from(fields: dict) -> FaultRule:
    # A bare attack or disk spec keys on its pseudo-RPC.
    if fields.get("kind") in ATTACK_KINDS and fields.get("rpc", "*") == "*":
        fields["rpc"] = "Attack"
    if fields.get("kind") in DISK_KINDS and fields.get("rpc", "*") == "*":
        fields["rpc"] = "Disk"
    if "rounds" in fields and not isinstance(fields["rounds"], (tuple, list)):
        lo, dash, hi = str(fields["rounds"]).partition("-")
        fields["rounds"] = (int(lo), int(hi)) if dash else (int(lo), int(lo) + 1)
    if "rounds" in fields and fields["rounds"] is not None:
        fields["rounds"] = tuple(int(x) for x in fields["rounds"])
    if "window" in fields and not isinstance(fields["window"], (tuple, list)):
        lo, dash, hi = str(fields["window"]).partition("-")
        if not dash:
            raise ValueError(f"chaos window must be lo-hi seconds, got {fields['window']!r}")
        fields["window"] = (float(lo), float(hi))
    if "window" in fields and fields["window"] is not None:
        fields["window"] = tuple(float(x) for x in fields["window"])
    for key in ("p", "delay_s", "factor", "noise_std"):
        if key in fields:
            fields[key] = float(fields[key])
    for key in ("max_injections", "max_consecutive", "label_offset"):
        if key in fields and fields[key] is not None:
            fields[key] = int(fields[key])
    if "collude" in fields:
        fields["collude"] = bool(fields["collude"])
    unknown = set(fields) - {f.name for f in dataclasses.fields(FaultRule)}
    if unknown:
        raise ValueError(f"unknown chaos rule fields {sorted(unknown)}")
    return FaultRule(**fields)
