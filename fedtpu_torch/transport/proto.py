"""Hand-rolled proto3 codec of the ``federated.Trainer`` messages.

The port's own copy of ``fedtpu.transport.proto``: the same messages, field
numbers and wire types, so a fedtpu_torch client and a fedtpu coordinator
read each other's bytes. The schema is the reference's
``federated.proto`` (``:24-63``) plus fedtpu's additive fields and
messages:

    TrainRequest{rank=1:int32, world=2:int32, round=3, epoch=4, codec=5}
    TrainReply{message=1}
    SendModelRequest{model=1, epoch=2, role=3}
    SendModelReply{reply=1}
    Request{}
    HeartBeatResponse{status=1:int32}
    PingRequest{req=1, epoch=2}
    PingResponse{value=1:int32}
    JoinRequest / JoinReply / LeaveRequest / LeaveReply
    SubmitPartialRequest / SubmitPartialReply

The additive int32 fields that may be absent (``round``, ``epoch``) travel
as value + 1, so proto3's omitted zero reads back as -1 ("absent"). Payload
fields (``TrainReply.message``, ``SendModelRequest.model``) are bytes, not
UTF-8 strings: proto3 strings and bytes share wire type 2, and raw model
bytes ride the same field number with no base64.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

_VARINT = 0
_LEN = 2


class ProtoError(ValueError):
    """Malformed message bytes."""


def _write_varint(out: bytearray, value: int) -> None:
    if value < 0:
        value += 1 << 64  # proto int32 negatives are 10-byte varints
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise ProtoError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
        if shift > 63:
            raise ProtoError("varint too long")
    return result, pos


def _encode_fields(fields: List[Tuple[int, int, object]]) -> bytes:
    """fields: [(field_number, wire_type, value)]; proto3 default values
    (0 / empty) are omitted, matching canonical encoders."""
    out = bytearray()
    for num, wtype, value in fields:
        if wtype == _VARINT:
            if value == 0:
                continue
            _write_varint(out, (num << 3) | _VARINT)
            _write_varint(out, int(value))
        elif wtype == _LEN:
            if not value:
                continue
            _write_varint(out, (num << 3) | _LEN)
            _write_varint(out, len(value))
            out += value
        else:
            raise ProtoError(f"unsupported wire type {wtype}")
    return bytes(out)


def _decode_fields(data: bytes) -> Dict[int, object]:
    """Last-one-wins scalar decode (proto3 semantics); unknown fields are
    skipped, as generated code does."""
    fields: Dict[int, object] = {}
    pos = 0
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        num, wtype = key >> 3, key & 0x7
        if wtype == _VARINT:
            value, pos = _read_varint(data, pos)
            fields[num] = value
        elif wtype == _LEN:
            size, pos = _read_varint(data, pos)
            if pos + size > len(data):
                raise ProtoError("truncated length-delimited field")
            fields[num] = data[pos : pos + size]
            pos += size
        elif wtype in (5, 1):  # fixed32 / fixed64 — skip
            width = 4 if wtype == 5 else 8
            if pos + width > len(data):
                raise ProtoError("truncated fixed-width field")
            pos += width
        else:
            raise ProtoError(f"unsupported wire type {wtype}")
    return fields


def _int32(value: int) -> int:
    """Reinterpret a decoded uint64 varint as int32 (sign wrap)."""
    value &= 0xFFFFFFFF
    return value - (1 << 32) if value >= 1 << 31 else value


@dataclasses.dataclass
class TrainRequest:
    rank: int = 0
    world: int = 0
    # Additive field 3 (beyond the reference schema's two): the
    # coordinator's LINEAGE round for this StartTrain, or -1 when unknown
    # (older peers, async workers). Carried so a client can detect a
    # coordinator REPLAY after disaster recovery (the resumed round is
    # behind the client's local counter) and roll its local state back to
    # the matching per-round snapshot instead of silently training a
    # diverged round (docs/OPERATIONS.md §Disaster recovery). Encoded as
    # round+1 so proto3's omit-zero default reads back as "absent" (-1),
    # never as round -1 colliding with a real round 0; stock
    # ``federated_pb2`` peers skip the unknown field.
    round: int = -1
    # Additive field 4: the sender's coordinator EPOCH, or -1 when absent
    # (pre-fencing peers). Minted on every promotion; receivers track the
    # max epoch seen and reject lower-epoch senders with STALE_COORDINATOR
    # so a healed partition cannot fork the lineage
    # (docs/FAULT_TOLERANCE.md §Fencing). Same +1 omit-zero trick as
    # ``round``: epoch 0 stays distinguishable from "absent".
    epoch: int = -1
    # Additive field 5: the coordinator's per-round CODEC CHOICE for this
    # client (the adaptive codec policy, docs/OPERATIONS.md §Adaptive
    # codec). 0 = unset — the client keeps its static configured codec, and
    # proto3 omit-zero means the field costs zero wire bytes in that (the
    # common) case; legacy peers skip the unknown field and likewise keep
    # their static codec. Nonzero values name a codec via
    # CODEC_IDS/CODEC_NAMES below.
    codec: int = 0

    def encode(self) -> bytes:
        return _encode_fields([
            (1, _VARINT, self.rank),
            (2, _VARINT, self.world),
            (3, _VARINT, self.round + 1),
            (4, _VARINT, self.epoch + 1),
            (5, _VARINT, self.codec),
        ])

    @classmethod
    def decode(cls, data: bytes) -> "TrainRequest":
        f = _decode_fields(data)
        return cls(
            rank=_int32(f.get(1, 0)),
            world=_int32(f.get(2, 0)),
            round=_int32(f.get(3, 0)) - 1,
            epoch=_int32(f.get(4, 0)) - 1,
            codec=_int32(f.get(5, 0)),
        )


# TrainRequest.codec wire ids (0 = unset/static). An enum by convention —
# kept as module constants so the hand-rolled codec stays dataclass-plain.
CODEC_IDS = {"none": 1, "int8": 2, "topk": 3, "rotq": 4, "randk": 5}
CODEC_NAMES = {v: k for k, v in CODEC_IDS.items()}


@dataclasses.dataclass
class TrainReply:
    message: bytes = b""

    def encode(self) -> bytes:
        return _encode_fields([(1, _LEN, self.message)])

    @classmethod
    def decode(cls, data: bytes) -> "TrainReply":
        return cls(message=_decode_fields(data).get(1, b""))


@dataclasses.dataclass
class SendModelRequest:
    model: bytes = b""
    # Additive fields 2/3: coordinator epoch (+1 encoded, -1 = absent, see
    # TrainRequest.epoch) and the sender's ROLE (0 = unset/legacy,
    # 1 = configured primary, 2 = acting primary). Role rides along so the
    # backup and flight recorder can attribute a replica stream without
    # decoding the payload; proto3 omit-zero keeps legacy bytes identical.
    epoch: int = -1
    role: int = 0

    def encode(self) -> bytes:
        return _encode_fields([
            (1, _LEN, self.model),
            (2, _VARINT, self.epoch + 1),
            (3, _VARINT, self.role),
        ])

    @classmethod
    def decode(cls, data: bytes) -> "SendModelRequest":
        f = _decode_fields(data)
        return cls(
            model=f.get(1, b""),
            epoch=_int32(f.get(2, 0)) - 1,
            role=_int32(f.get(3, 0)),
        )


@dataclasses.dataclass
class SendModelReply:
    reply: bytes = b""

    def encode(self) -> bytes:
        return _encode_fields([(1, _LEN, self.reply)])

    @classmethod
    def decode(cls, data: bytes) -> "SendModelReply":
        return cls(reply=_decode_fields(data).get(1, b""))


@dataclasses.dataclass
class Request:
    def encode(self) -> bytes:
        return b""

    @classmethod
    def decode(cls, data: bytes) -> "Request":
        _decode_fields(data)  # validate framing of any unknown fields
        return cls()


@dataclasses.dataclass
class HeartBeatResponse:
    status: int = 0

    def encode(self) -> bytes:
        return _encode_fields([(1, _VARINT, self.status)])

    @classmethod
    def decode(cls, data: bytes) -> "HeartBeatResponse":
        return cls(status=_int32(_decode_fields(data).get(1, 0)))


@dataclasses.dataclass
class PingRequest:
    req: bytes = b""
    # Additive field 2: coordinator epoch (+1 encoded, -1 = absent). Lets
    # the backup fence a stale primary's liveness probes — a partitioned
    # ex-primary must not keep resetting the watchdog of a backup that has
    # already promoted past it.
    epoch: int = -1

    def encode(self) -> bytes:
        return _encode_fields([
            (1, _LEN, self.req),
            (2, _VARINT, self.epoch + 1),
        ])

    @classmethod
    def decode(cls, data: bytes) -> "PingRequest":
        f = _decode_fields(data)
        return cls(req=f.get(1, b""), epoch=_int32(f.get(2, 0)) - 1)


@dataclasses.dataclass
class PingResponse:
    value: int = 0

    def encode(self) -> bytes:
        return _encode_fields([(1, _VARINT, self.value)])

    @classmethod
    def decode(cls, data: bytes) -> "PingResponse":
        return cls(value=_int32(_decode_fields(data).get(1, 0)))


# Elastic-membership extension beyond the reference's 8 messages (the
# reference freezes its registry at startup, src/server.py:281-282). A
# joiner announces the address it SERVES on — the coordinator dials
# clients, so the address is the member identity — and learns its seat
# (rank / data shard), the world (partition width) and the membership
# epoch. Leave is the graceful counterpart; silent departures are handled
# by the heartbeat machinery instead.
@dataclasses.dataclass
class JoinRequest:
    address: bytes = b""

    def encode(self) -> bytes:
        return _encode_fields([(1, _LEN, self.address)])

    @classmethod
    def decode(cls, data: bytes) -> "JoinRequest":
        return cls(address=_decode_fields(data).get(1, b""))


@dataclasses.dataclass
class JoinReply:
    admitted: int = 0
    seat: int = 0
    world: int = 0
    version: int = 0
    message: bytes = b""

    def encode(self) -> bytes:
        return _encode_fields([
            (1, _VARINT, self.admitted),
            (2, _VARINT, self.seat),
            (3, _VARINT, self.world),
            (4, _VARINT, self.version),
            (5, _LEN, self.message),
        ])

    @classmethod
    def decode(cls, data: bytes) -> "JoinReply":
        f = _decode_fields(data)
        return cls(
            admitted=_int32(f.get(1, 0)),
            seat=_int32(f.get(2, 0)),
            world=_int32(f.get(3, 0)),
            version=_int32(f.get(4, 0)),
            message=f.get(5, b""),
        )


# Hierarchical-aggregation extension (docs/ARCHITECTURE.md §Multi-tier):
# the ROOT coordinator pulls one partial reduce per round from each leaf
# AggregatorServer over SubmitPartial. Both messages are additive — new
# method name, new field numbers, proto3 omit-zero throughout — so a
# legacy peer that never speaks SubmitPartial sees zero new wire bytes on
# the original RPCs, and an unset message encodes to b"" (pinned in
# tests/test_transport.py and tests/test_torch_wire.py).
@dataclasses.dataclass
class SubmitPartialRequest:
    # First cohort rank this aggregator hands out: cohort member i trains
    # shard ``rank_base + i`` of the root-wide ``world``-way partition, so
    # tiers tile the data partition without coordination.
    rank_base: int = 0
    world: int = 0
    # Coordinator lineage round / fencing epoch, +1 omit-zero encoded
    # exactly like TrainRequest fields 3/4 (-1 reads back as "absent").
    round: int = -1
    epoch: int = -1

    def encode(self) -> bytes:
        return _encode_fields([
            (1, _VARINT, self.rank_base),
            (2, _VARINT, self.world),
            (3, _VARINT, self.round + 1),
            (4, _VARINT, self.epoch + 1),
        ])

    @classmethod
    def decode(cls, data: bytes) -> "SubmitPartialRequest":
        f = _decode_fields(data)
        return cls(
            rank_base=_int32(f.get(1, 0)),
            world=_int32(f.get(2, 0)),
            round=_int32(f.get(3, 0)) - 1,
            epoch=_int32(f.get(4, 0)) - 1,
        )


@dataclasses.dataclass
class SubmitPartialReply:
    # One FSP1 ``partial_flat`` record (fedtpu_torch.transport.sparse): the
    # cohort's pre-weighted sum row + weight sum, framed/CRC'd like every
    # other delta payload.
    record: bytes = b""
    # How many cohort replies folded into the record (telemetry/records
    # only — the combine weight travels INSIDE the record, where it is
    # covered by the frame CRC).
    clients: int = 0

    def encode(self) -> bytes:
        return _encode_fields([
            (1, _LEN, self.record),
            (2, _VARINT, self.clients),
        ])

    @classmethod
    def decode(cls, data: bytes) -> "SubmitPartialReply":
        f = _decode_fields(data)
        return cls(record=f.get(1, b""), clients=_int32(f.get(2, 0)))


@dataclasses.dataclass
class LeaveRequest:
    address: bytes = b""

    def encode(self) -> bytes:
        return _encode_fields([(1, _LEN, self.address)])

    @classmethod
    def decode(cls, data: bytes) -> "LeaveRequest":
        return cls(address=_decode_fields(data).get(1, b""))


@dataclasses.dataclass
class LeaveReply:
    left: int = 0
    version: int = 0

    def encode(self) -> bytes:
        return _encode_fields([
            (1, _VARINT, self.left),
            (2, _VARINT, self.version),
        ])

    @classmethod
    def decode(cls, data: bytes) -> "LeaveReply":
        f = _decode_fields(data)
        return cls(left=_int32(f.get(1, 0)), version=_int32(f.get(2, 0)))
