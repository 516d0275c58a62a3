"""The port's wire against fedtpu's, byte for byte: the proto messages,
flax's msgpack form (the port's own encoder against
``flax.serialization``), and FTP1 frames.

Every case encodes the same numpy values in both packages and requires
identical bytes; each side then decodes the other's bytes. Nothing here
has a tolerance: the wire is bytes.
"""

import struct
import zlib

import jax
import numpy as np
import pytest
from flax import serialization

from fedtpu import models as jmodels
from fedtpu.transport import proto as jproto
from fedtpu.transport import wire as jwire
from fedtpu_torch.transport import msgpack as tmsgpack
from fedtpu_torch.transport import proto as tproto
from fedtpu_torch.transport import wire as twire

# ------------------------------------------------------------------- proto

_MESSAGES = {
    "TrainRequest": [dict(), dict(rank=3, world=64), dict(rank=1, world=2, round=0, epoch=0, codec=4),
                     dict(rank=70000, world=2**31 - 1, round=123456, epoch=7, codec=5),
                     dict(rank=-1, world=-5, round=-1, epoch=-1, codec=0)],
    "TrainReply": [dict(), dict(message=b"\x00FSP1" + bytes(range(256)) * 300)],
    "SendModelRequest": [dict(), dict(model=b"FTP1" * 1000, epoch=2, role=1),
                         dict(model=b"x", epoch=0, role=2)],
    "SendModelReply": [dict(), dict(reply=b"0.8125")],
    "Request": [dict()],
    "HeartBeatResponse": [dict(), dict(status=1), dict(status=-2)],
    "PingRequest": [dict(), dict(req=b"ping", epoch=0), dict(req=b"", epoch=12)],
    "PingResponse": [dict(), dict(value=1)],
    "JoinRequest": [dict(), dict(address=b"localhost:50151")],
    "JoinReply": [dict(), dict(admitted=1, seat=3, world=8, version=2, message=b"ok")],
    "LeaveRequest": [dict(address=b"localhost:1")],
    "LeaveReply": [dict(), dict(left=1, version=9)],
    "SubmitPartialRequest": [dict(), dict(rank_base=4, world=16, round=2, epoch=1)],
    "SubmitPartialReply": [dict(), dict(record=b"FSP1" + b"\x01" * 99, clients=4)],
}
_CASES = [(name, i) for name, kws in _MESSAGES.items() for i in range(len(kws))]


@pytest.mark.parametrize("name,case", _CASES)
def test_proto_message_bytes_equal(name, case):
    kw = _MESSAGES[name][case]
    want = getattr(jproto, name)(**kw)
    got = getattr(tproto, name)(**kw)
    assert got.encode() == want.encode()
    assert getattr(tproto, name).decode(want.encode()) == got
    back = getattr(jproto, name).decode(got.encode())
    for field in kw:
        assert getattr(back, field) == getattr(want, field), field


def test_proto_codec_ids_equal():
    assert tproto.CODEC_IDS == jproto.CODEC_IDS
    assert tproto.CODEC_NAMES == jproto.CODEC_NAMES


def test_proto_skips_unknown_fields_and_rejects_truncation():
    # An unknown field 9 (varint), a fixed64 and a fixed32 are skipped.
    data = jproto.TrainRequest(rank=2, world=4).encode() + bytes([0x48, 0x05, 0x51]) + bytes(8) + bytes([0x5D]) + bytes(4)
    assert tproto.TrainRequest.decode(data) == tproto.TrainRequest(rank=2, world=4)
    with pytest.raises(tproto.ProtoError):
        tproto.TrainReply.decode(bytes([0x0A, 0x05, 0x01]))


# ----------------------------------------------------------------- msgpack


def _flax_tree(model_name):
    """The model's flax variables (their structure, in flax's key order,
    and shapes), filled with seeded normals."""
    model = jmodels.create(model_name, num_classes=10)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3), np.float32), train=False))
    rng = np.random.default_rng(0)
    return jax.tree.map(lambda s: rng.normal(size=s.shape).astype(s.dtype), dict(shapes))


@pytest.fixture(scope="module")
def flax_trees():
    return {name: _flax_tree(name) for name in ("smallcnn", "MobileNet")}


def _leaves_equal(a, b):
    la, lb = jax.tree_util.tree_leaves(a), twire.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("model_name", ["smallcnn", "MobileNet"])
def test_to_bytes_equals_flax(flax_trees, model_name):
    tree = flax_trees[model_name]
    payload = dict(tree, num_examples=np.float32(768.0))
    for t in (tree["params"], payload):
        want = serialization.to_bytes(t)
        assert tmsgpack.to_bytes(t) == want
        _leaves_equal(serialization.from_bytes(t, want), tmsgpack.from_bytes(t, want))
        _leaves_equal(serialization.msgpack_restore(want), tmsgpack.msgpack_restore(want))


def test_scalar_and_primitives_equal_flax():
    values = [
        np.float32(768.0), np.int64(-3), np.uint64(2**64 - 1), np.float64(0.1), np.int8(-128), np.bool_(True),
        {"a": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33, -128, -129, -2**31, -2**63],
         "f": 1.5, "t": True, "n": None, "s": "x" * 31, "s8": "y" * 32, "s16": "z" * 256,
         "b": b"", "b16": b"\x01" * 256, "b32": b"\x02" * 65536, "c": 1 + 2j, "l": list(range(17))},
        {str(i): np.arange(i, dtype=np.int32) for i in range(20)},
        np.zeros((0, 3), np.float32), np.arange(16, dtype=np.int8),
    ]
    for v in values:
        want = serialization.to_bytes(v)
        assert tmsgpack.to_bytes(v) == want
        assert tmsgpack.msgpack_serialize(v) == serialization.msgpack_serialize(v)
        got, ref = tmsgpack.msgpack_restore(want), serialization.msgpack_restore(want)
        if isinstance(ref, dict):
            assert jax.tree.structure(ref) == jax.tree.structure(got)
        for x, y in zip(jax.tree_util.tree_leaves(ref), twire.tree_leaves(got)):
            assert type(x) is type(y) and np.array_equal(x, y)


def test_msgpack_serialize_sorts_keys_as_jax_does():
    body = {"kind": "topk", "leaves": {str(i): {"vals": np.ones(i, np.float32), "idx": np.arange(i, dtype=np.int32),
                                                "size": np.int64(i)} for i in range(12)},
            "extra": {"num_examples": np.float32(3)}}
    assert tmsgpack.msgpack_serialize(body) == serialization.msgpack_serialize(body)


def test_chunked_array_equals_flax(monkeypatch):
    # flax chunks arrays over MAX_CHUNK_SIZE bytes; shrink the limit on
    # both sides to exercise the chunked form at a test size.
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(tmsgpack, "MAX_CHUNK_SIZE", 64)
    tree = {"w": np.arange(50, dtype=np.float32).reshape(5, 10), "small": np.ones(3, np.float32)}
    want = serialization.msgpack_serialize(tree)
    assert tmsgpack.msgpack_serialize(tree) == want
    np.testing.assert_array_equal(tmsgpack.msgpack_restore(want)["w"], tree["w"])


def test_msgpack_refuses_malformed_documents():
    with pytest.raises(tmsgpack.MsgpackError):
        tmsgpack.msgpack_restore(serialization.to_bytes({"a": np.ones(4, np.float32)})[:-3])
    with pytest.raises(tmsgpack.MsgpackError):
        tmsgpack.msgpack_restore(b"\xc1")
    with pytest.raises(TypeError):
        tmsgpack.msgpack_serialize({"t": (1, 2)})  # flax's strict_types refuses tuples too


# -------------------------------------------------------------------- FTP1


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("kind", ["model", "replica"])
@pytest.mark.parametrize("model_name", ["smallcnn", "MobileNet"])
def test_ftp1_frames_equal(flax_trees, model_name, kind, compress):
    tree = flax_trees[model_name]
    payload = {"params": tree["params"], "batch_stats": tree.get("batch_stats", {}),
               "num_examples": np.float32(32.0)}
    want = jwire.encode(payload, compress=compress, kind=kind)
    got = twire.encode(payload, compress=compress, kind=kind)
    assert got == want
    assert twire.payload_kind(want) == jwire.payload_kind(got) == kind
    like = jax.tree.map(np.zeros_like, payload)
    _leaves_equal(jwire.decode(got, like), twire.decode(want, like))
    _leaves_equal(jwire.decode_raw(got), twire.decode_raw(want))
    assert twire.payload_size(payload) == jwire.payload_size(payload)


def test_ftp1_accepts_torch_leaves(flax_trees):
    import torch

    tree = flax_trees["smallcnn"]["params"]
    as_torch = jax.tree.map(torch.from_numpy, tree)
    assert twire.encode({"params": as_torch}) == jwire.encode({"params": tree})


def test_v1_frame_decodes_and_a_flipped_flags_byte_fails_the_crc(flax_trees):
    tree = {"params": flax_trees["smallcnn"]["params"]}
    body = serialization.to_bytes(jax.tree.map(np.asarray, tree))
    v1 = jwire.frame(b"FTP1", body, 0, version=1)
    assert twire.frame(b"FTP1", body, 0, version=1) == v1
    _leaves_equal(tree, twire.decode(v1, tree))
    good = twire.encode(tree, compress=True)
    flipped = good[:5] + bytes([good[5] ^ 2]) + good[6:]  # the replica bit
    with pytest.raises(twire.WireError, match="CRC"):
        twire.decode(flipped, tree)
    with pytest.raises(jwire.WireError, match="CRC"):
        jwire.decode(flipped, tree)
    with pytest.raises(twire.WireError):
        twire.decode(b"XXXX" + good[4:], tree)
    ver3 = good[:4] + bytes([3]) + good[5:]
    with pytest.raises(twire.WireError, match="version"):
        twire.decode(ver3, tree)


def test_decode_into_row_equals_fedtpu(flax_trees):
    rng = np.random.default_rng(3)
    tree = flax_trees["MobileNet"]
    base = {"params": tree["params"], "batch_stats": tree["batch_stats"]}
    sent = jax.tree.map(lambda a: a + rng.normal(size=a.shape).astype(a.dtype), base)
    data = jwire.encode(dict(sent, num_examples=np.float32(5.0)))
    like = dict(jax.tree.map(np.zeros_like, base), num_examples=np.zeros((), np.float32))
    total = sum(a.size for a in jax.tree_util.tree_leaves(base))
    want = np.zeros(total + 9, np.float32)
    got = want.copy()
    ex_j = jwire.decode_into_row(data, like, base, want)
    ex_t = twire.decode_into_row(data, like, base, got)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert float(ex_t["num_examples"]) == float(ex_j["num_examples"]) == 5.0


def test_crc_rule_is_fedtpus():
    body = b"payload"
    for version, flags in ((1, 0), (2, 0), (2, 3)):
        frame = twire.frame(b"FTP1", body, flags, version=version)
        crc = struct.unpack_from("<I", frame, 6)[0]
        want = zlib.crc32(body) if version == 1 else zlib.crc32(body, zlib.crc32(bytes((version, flags))))
        assert crc == want & 0xFFFFFFFF
