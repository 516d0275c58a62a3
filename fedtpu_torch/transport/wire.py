"""FTP1, the dense model payload of the gRPC edge.

The port's own copy of ``fedtpu.transport.wire``, byte for byte: a payload
is flax's msgpack form of the tree (:mod:`fedtpu_torch.transport.msgpack`)
behind a framed header

    magic(4) | version(1) | flags(1) | crc32(4) | payload

``flags`` bit 0 marks a zlib-compressed payload, bit 1 a backup-replica
payload (model, server-optimizer moments and round counter) against a plain
model payload. A v2 frame (the current one) has its CRC over ``version |
flags | payload``; a v1 frame, over the payload alone; both decode, each
under its own rule.

A tree here is what fedtpu ships: nested dicts of arrays in flax's layout
(Conv kernels HWIO, Dense kernels ``[in, out]``), whose leaves are taken in
``jax.tree_util.tree_flatten``'s order: dict keys sorted at every level
(:func:`tree_leaves`). A named tuple (a checkpointed state) keeps its
fields in their order, as flax serializes it by field name. A leaf may be
a numpy array or scalar, or a torch tensor, which is copied to the host.
"""

from __future__ import annotations

import struct
import zlib
from typing import Any, List, Optional

import numpy as np
import torch

from fedtpu_torch.convert import host_array
from fedtpu_torch.transport import msgpack

Tree = Any

_MAGIC = b"FTP1"
_VERSION = 2
_FLAG_ZLIB = 1
_FLAG_REPLICA = 2
_HEADER = struct.Struct("<4sBBI")


class WireError(ValueError):
    """Malformed or corrupted payload."""


# --------------------------------------------------------------------- trees


def tree_leaves(tree: Tree) -> List[Any]:
    """The leaves of a tree of dicts and lists in ``jax.tree_util``'s
    order: each dict's keys sorted, depth first; ``None`` and an empty dict
    hold no leaf."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_unflatten(like: Tree, leaves) -> Tree:
    """A tree shaped like ``like`` (its dicts rebuilt with sorted keys, as
    jax rebuilds them) holding ``leaves`` in :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if msgpack.is_namedtuple(node):
            return type(node)(*[build(v) for v in node])
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return None if node is None else next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and of trees of its structure, in
    :func:`tree_leaves` order, as ``jax.tree.map`` applies it; the result
    is shaped like ``tree``, its dicts' keys sorted."""
    return tree_unflatten(tree, [fn(*xs) for xs in zip(tree_leaves(tree), *map(tree_leaves, rest))])


def host(x) -> Any:
    """A leaf on the host: a torch tensor as a numpy array (a bf16 one as
    its :class:`~fedtpu_torch.transport.msgpack.Bfloat16Array`), anything
    else through ``np.asarray`` (a numpy scalar becomes a 0-d array, as
    ``jax.tree.map(np.asarray, ...)`` makes it)."""
    if isinstance(x, torch.Tensor):
        return host_array(x)
    if isinstance(x, msgpack.Bfloat16Array):
        return x
    return np.asarray(x)


def host_tree(tree: Tree) -> Tree:
    """Every leaf through :func:`host`, dict keys sorted, tuples and named
    tuples kept (``()`` is an empty node, as in jax)."""
    if isinstance(tree, dict):
        return {k: host_tree(tree[k]) for k in sorted(tree)}
    if msgpack.is_namedtuple(tree):
        return type(tree)(*[host_tree(v) for v in tree])
    if isinstance(tree, tuple):
        return tuple(host_tree(v) for v in tree)
    return host(tree)


# -------------------------------------------------------------------- frames


def _crc(version: int, flags: int, payload: bytes) -> int:
    """v1 covers the payload; v2 the version and flags bytes too."""
    if version == 1:
        return zlib.crc32(payload) & 0xFFFFFFFF
    return zlib.crc32(payload, zlib.crc32(bytes((version, flags)))) & 0xFFFFFFFF


def frame(magic: bytes, payload: bytes, flags: int = 0, version: int = _VERSION) -> bytes:
    """``payload`` behind the shared header (FTP1 here, FSP1 in
    :mod:`fedtpu_torch.transport.sparse`); ``version=1`` writes a legacy
    frame."""
    if not 1 <= version <= _VERSION:
        raise ValueError(f"unknown frame version {version}")
    return _HEADER.pack(magic, version, flags, _crc(version, flags, payload)) + payload


def unframe(magic: bytes, data: bytes, what: str = "wire", version: int = _VERSION):
    """``(flags, payload)`` of a frame of any version from 1 to ``version``;
    raises :class:`WireError` on a wrong magic, an unknown version or a CRC
    mismatch."""
    if len(data) < _HEADER.size or data[:4] != magic:
        raise WireError(f"not a fedtpu {what} payload")
    _, ver, flags, crc = _HEADER.unpack_from(data)
    if not 1 <= ver <= version:
        raise WireError(f"unsupported {what} version {ver}")
    payload = data[_HEADER.size :]
    if _crc(ver, flags, payload) != crc:
        raise WireError(f"{what} payload CRC mismatch")
    return flags, payload


# ------------------------------------------------------------------ payloads


def encode(tree: Tree, compress: bool = False, level: int = 6, kind: str = "model") -> bytes:
    """A tree as an FTP1 payload; ``kind`` (``"model"`` or ``"replica"``)
    is stamped into the flags."""
    if kind not in ("model", "replica"):
        raise ValueError(f"unknown payload kind {kind!r}")
    payload = msgpack.to_bytes(host_tree(tree))
    flags = _FLAG_REPLICA if kind == "replica" else 0
    if compress:
        payload = zlib.compress(payload, level)
        flags |= _FLAG_ZLIB
    return frame(_MAGIC, payload, flags)


def payload_kind(data: bytes) -> str:
    """``"model"`` or ``"replica"`` from the frame flags."""
    if len(data) < _HEADER.size or data[:4] != _MAGIC:
        raise WireError("not a fedtpu wire payload")
    _, version, flags, _ = _HEADER.unpack_from(data)
    if not 1 <= version <= _VERSION:
        raise WireError(f"unsupported wire version {version}")
    return "replica" if flags & _FLAG_REPLICA else "model"


def _payload(data: bytes) -> bytes:
    flags, payload = unframe(_MAGIC, data)
    return zlib.decompress(payload) if flags & _FLAG_ZLIB else payload


def decode(data: bytes, like: Tree) -> Tree:
    """Inverse of :func:`encode`: the payload restored into the structure
    of ``like`` (each leaf as the wire carried it)."""
    try:
        return msgpack.from_bytes(like, _payload(data))
    except msgpack.MsgpackError as exc:
        raise WireError(str(exc)) from exc


def decode_raw(data: bytes) -> Tree:
    """The payload's nested dicts of numpy arrays, with no template."""
    return msgpack.msgpack_restore(_payload(data))


def staged_row(out, total: int):
    """``(host row, device row)``: where a decode writes its ``total``
    coordinates, and the tensor they are copied into after (None when
    ``out`` is already a host f32 row)."""
    if isinstance(out, torch.Tensor):
        if out.dtype != torch.float32 or out.ndim != 1 or out.shape[0] < total:
            raise ValueError(f"row buffer too small or not f32: {tuple(out.shape)} {out.dtype}")
        return np.empty(total, np.float32), out
    if out.ndim != 1 or out.shape[0] < total or out.dtype != np.float32:
        raise ValueError(
            f"row buffer too small or not f32: {out.shape} {out.dtype} for {total} coordinates"
        )
    return out, None


def finish_row(row: np.ndarray, dev: Optional[torch.Tensor], total: int) -> None:
    """Copy a staged host row into its tensor (one copy)."""
    if dev is not None:
        dev[:total].copy_(torch.from_numpy(row[:total]), non_blocking=False)


def decode_into_row(data: bytes, like: Tree, base: Tree, out) -> dict:
    """A dense model payload's DELTA against ``base`` (the round's global
    model on the host, ``{"params", "batch_stats"}``), leaf by leaf in
    :func:`tree_leaves` order, written into ``out[:total]``: a host f32 row
    or a row of a tensor (written once, from the host). Returns the
    payload's other fields (``num_examples``)."""
    tree = decode(data, like)
    packed = {k: tree[k] for k in ("params", "batch_stats")}
    base_leaves = tree_leaves(base)
    leaves = tree_leaves(packed)
    if len(leaves) != len(base_leaves):
        raise WireError(f"payload has {len(leaves)} model leaves, base has {len(base_leaves)}")
    total = sum(int(np.size(b)) for b in base_leaves)
    row, dev = staged_row(out, total)
    off = 0
    for leaf, b in zip(leaves, base_leaves):
        n = int(np.size(b))
        if int(np.size(leaf)) != n:
            raise WireError("dense leaf size mismatch with base model")
        row[off : off + n] = (
            np.asarray(leaf, np.float32).ravel() - np.asarray(host(b), np.float32).ravel()
        )
        off += n
    finish_row(row, dev, total)
    return {k: v for k, v in tree.items() if k not in ("params", "batch_stats")}


def model_row(tree: Tree, sizes, padded: int) -> np.ndarray:
    """A model tree's ``{"params", "batch_stats"}`` leaves, in
    :func:`tree_leaves` order, as one f32 row of ``padded`` coordinates
    (zeros past the leaves); :class:`WireError` when the leaves are not
    ``sizes``, the receiver's model."""
    leaves = tree_leaves({"params": tree["params"], "batch_stats": tree["batch_stats"]})
    if [int(np.size(a)) for a in leaves] != [int(n) for n in sizes]:
        raise WireError(
            f"model payload has {len(leaves)} leaves of other sizes than the "
            f"receiver's {len(sizes)}"
        )
    row = np.zeros(padded, np.float32)
    off = 0
    for leaf, n in zip(leaves, sizes):
        row[off : off + n] = np.asarray(leaf, np.float32).ravel()
        off += n
    return row


def payload_size(tree: Tree) -> int:
    """Uncompressed payload bytes of a tree, without the header."""
    return len(msgpack.to_bytes(host_tree(tree)))
