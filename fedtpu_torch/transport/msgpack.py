"""flax's msgpack form of a tree of arrays, in pure Python.

fedtpu puts every tree on the wire through ``flax.serialization``: a dense
model payload is ``to_bytes`` of the tree, an FSP1 record is
``msgpack_serialize`` of its body. The port writes and reads the same bytes
without flax and without the ``msgpack`` package:

- a numpy array is the extension type 1 whose data is the msgpack array
  ``(shape, dtype name, C-order bytes)``; a numpy scalar is the extension
  type 3 with the same data for its 0-d array; an array of more than
  ``MAX_CHUNK_SIZE`` bytes is written as a dict of flat chunks;
- dicts keep their order in :func:`to_bytes`, as flax's state dict does,
  and :func:`msgpack_serialize` sorts their keys at every level first, as
  the ``jax.tree_util.tree_map`` that flax runs over its input does;
- every other value takes msgpack's smallest form for it (``use_bin_type``,
  and flax's ``strict_types``: a numpy float is a numpy scalar, not a
  float, and a tuple is refused).

The decoder reads any msgpack document into dicts, lists, ``str``,
``bytes`` and numbers, with arrays as read-only numpy arrays over the
input's bytes.

numpy has no bfloat16, and the port does not need ``ml_dtypes``: a
bfloat16 array travels as :class:`Bfloat16Array`, its raw 16-bit words,
written as flax writes an ``ml_dtypes`` array (``(shape, "bfloat16",
bytes)``) and read back into the same holder
(:func:`fedtpu_torch.convert.from_flax` turns it into a bf16 tensor).
"""

from __future__ import annotations

import struct
from typing import Any, Mapping

import numpy as np

MAX_CHUNK_SIZE = 2**30  # flax's: arrays above this many bytes are chunked

_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


class MsgpackError(ValueError):
    """Bytes that are not a msgpack document of the form read here."""


class Bfloat16Array:
    """A bfloat16 array as its raw 16-bit words (``words``: a uint16 numpy
    array of the same shape, C order when written)."""

    __slots__ = ("words",)

    def __init__(self, words: np.ndarray):
        words = np.asarray(words)
        if words.dtype.itemsize != 2:
            raise MsgpackError(f"bfloat16 words must be 16-bit, got {words.dtype}")
        self.words = words.view(np.uint16)

    @property
    def shape(self):
        return self.words.shape

    def __repr__(self) -> str:
        return f"Bfloat16Array(shape={self.shape})"


# ------------------------------------------------------------------ encoding


def _uint(out: bytearray, fixmax: int, fixbase: int, codes, n: int) -> None:
    """A length or count header: the fix form up to ``fixmax``, else the
    8-, 16- or 32-bit form whose codes ``codes`` lists (None: absent)."""
    if n <= fixmax:
        out.append(fixbase | n)
    elif codes[0] is not None and n <= 0xFF:
        out += struct.pack(">BB", codes[0], n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", codes[1], n)
    elif n <= 0xFFFFFFFF:
        out += struct.pack(">BI", codes[2], n)
    else:
        raise MsgpackError(f"object of {n} bytes or entries is too large for msgpack")


def _pack_int(out: bytearray, v: int) -> None:
    if v >= 0:
        if v < 0x80:
            out.append(v)
        elif v <= 0xFF:
            out += struct.pack(">BB", 0xCC, v)
        elif v <= 0xFFFF:
            out += struct.pack(">BH", 0xCD, v)
        elif v <= 0xFFFFFFFF:
            out += struct.pack(">BI", 0xCE, v)
        elif v <= 0xFFFFFFFFFFFFFFFF:
            out += struct.pack(">BQ", 0xCF, v)
        else:
            raise MsgpackError(f"integer {v} does not fit 64 bits")
    elif v >= -0x20:
        out += struct.pack("b", v)
    elif v >= -0x80:
        out += struct.pack(">Bb", 0xD0, v)
    elif v >= -0x8000:
        out += struct.pack(">Bh", 0xD1, v)
    elif v >= -0x80000000:
        out += struct.pack(">Bi", 0xD2, v)
    elif v >= -0x8000000000000000:
        out += struct.pack(">Bq", 0xD3, v)
    else:
        raise MsgpackError(f"integer {v} does not fit 64 bits")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    elif n <= 0xFF:
        out += struct.pack(">BB", 0xC7, n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", 0xC8, n)
    elif n <= 0xFFFFFFFF:
        out += struct.pack(">BI", 0xC9, n)
    else:
        raise MsgpackError(f"extension of {n} bytes is too large for msgpack")
    out += struct.pack("b", code)
    out += data


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: ``packb((shape, dtype name, bytes))``."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise MsgpackError("object and structured dtypes cannot be serialized")
    out = bytearray()
    _pack(out, [list(arr.shape), arr.dtype.name, arr.tobytes("C")], strict=False)
    return bytes(out)


def _pack(out: bytearray, obj: Any, strict: bool) -> None:
    t = type(obj)
    if obj is None:
        out.append(0xC0)
    elif t is bool:
        out.append(0xC3 if obj else 0xC2)
    elif t is int:
        _pack_int(out, obj)
    elif t is float:
        out += struct.pack(">Bd", 0xCB, obj)
    elif t is str:
        data = obj.encode("utf-8")
        _uint(out, 0x1F, 0xA0, (0xD9, 0xDA, 0xDB), len(data))
        out += data
    elif t in (bytes, bytearray, memoryview):
        data = bytes(obj)
        _uint(out, -1, 0, (0xC4, 0xC5, 0xC6), len(data))
        out += data
    elif t is list or (t is tuple and not strict):
        _uint(out, 0x0F, 0x90, (None, 0xDC, 0xDD), len(obj))
        for v in obj:
            _pack(out, v, strict)
    elif t is dict:
        _uint(out, 0x0F, 0x80, (None, 0xDE, 0xDF), len(obj))
        for k, v in obj.items():
            _pack(out, k, strict)
            _pack(out, v, strict)
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_bytes(obj))
    elif t is Bfloat16Array:
        inner = bytearray()
        _pack(inner, [list(obj.shape), "bfloat16", obj.words.tobytes("C")], strict=False)
        _pack_ext(out, _EXT_NDARRAY, bytes(inner))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)))
    elif t is complex:
        inner = bytearray()
        _pack(inner, [obj.real, obj.imag], strict=False)
        _pack_ext(out, _EXT_COMPLEX, bytes(inner))
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def packb(obj: Any) -> bytes:
    """One msgpack document, with flax's ``default`` and ``strict_types``."""
    out = bytearray()
    _pack(out, obj, strict=True)
    return bytes(out)


def _chunk(arr: np.ndarray) -> dict:
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i : i + size] for i in range(0, flat.size, size)]
    return {
        _CHUNKED: True,
        "shape": {str(i): d for i, d in enumerate(arr.shape)},
        "chunks": {str(i): c for i, c in enumerate(chunks)},
    }


def _too_big(v) -> bool:
    return isinstance(v, np.ndarray) and v.size * v.dtype.itemsize > MAX_CHUNK_SIZE


def _chunk_leaves(tree):
    """flax's ``_chunk_array_leaves_in_place``, on a copy."""
    if isinstance(tree, dict):
        return {
            k: _chunk(v) if _too_big(v) else _chunk_leaves(v) if isinstance(v, dict) else v
            for k, v in tree.items()
        }
    return _chunk(tree) if _too_big(tree) else tree


def _sorted_tree(tree):
    """The tree with every dict's keys sorted, as a jax ``tree_map`` rebuilds
    it; lists and leaves kept."""
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_sorted_tree(v) for v in tree]
    return tree


def msgpack_serialize(tree) -> bytes:
    """``flax.serialization.msgpack_serialize``: dict keys sorted at every
    level, oversized arrays chunked, packed."""
    return packb(_chunk_leaves(_sorted_tree(tree)))


def is_namedtuple(x) -> bool:
    """A named tuple, which flax serializes by field name."""
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _state_dict(target):
    """flax's ``to_state_dict`` for the trees the edge and the checkpoints
    ship: a dict keeps its order with ``str`` keys, a named tuple becomes
    ``{field: ...}`` in field order, a list or tuple ``{"0": ...}``."""
    if isinstance(target, dict):
        return {str(k): _state_dict(v) for k, v in target.items()}
    if is_namedtuple(target):
        return {k: _state_dict(getattr(target, k)) for k in target._fields}
    if isinstance(target, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(target)}
    return target


def to_bytes(target) -> bytes:
    """``flax.serialization.to_bytes`` of a tree of dicts (in their own
    order) and numpy arrays or scalars."""
    return packb(_chunk_leaves(_state_dict(target)))


# ------------------------------------------------------------------ decoding


def _ndarray_from(data: memoryview):
    """An array extension's numpy array, or a :class:`Bfloat16Array` of
    its words for flax's ``"bfloat16"``."""
    shape, name, buf = _Reader(data, raw=True).document()
    if isinstance(name, bytes):
        name = name.decode("ascii")
    if name == "bfloat16":
        return Bfloat16Array(np.frombuffer(buf, dtype=np.uint16).reshape(shape, order="C"))
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape, order="C")


class _Reader:
    """A cursor over one msgpack document; ``raw`` leaves strings as bytes
    (flax reads an array's header so)."""

    def __init__(self, data, raw: bool = False):
        self.mv = memoryview(data).cast("B")
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.mv):
            raise MsgpackError("truncated msgpack document")
        out = self.mv[self.pos : end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def document(self):
        obj = self.read()
        if self.pos != len(self.mv):
            raise MsgpackError("extra bytes after the msgpack document")
        return obj

    def _str(self, n: int):
        b = self.take(n)
        return bytes(b) if self.raw else str(b, "utf-8")

    def _ext(self, code: int, n: int):
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray_from(data)
        if code == _EXT_NPSCALAR:
            arr = _ndarray_from(data)
            return arr if isinstance(arr, Bfloat16Array) else arr[()]
        if code == _EXT_COMPLEX:
            re, im = _Reader(data).document()
            return complex(re, im)
        raise MsgpackError(f"unknown msgpack extension type {code}")

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return self.take(self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b]))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self._ext(self.unpack("b"), n)
        if b in (0xCA, 0xCB):
            return self.unpack(">f" if b == 0xCA else ">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self.unpack(ints[b])
        if 0xD4 <= b <= 0xD8:
            code = self.unpack("b")
            return self._ext(code, 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self._str(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b]))
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self._map(self.unpack(">H" if b == 0xDE else ">I"))
        raise MsgpackError(f"unknown msgpack type byte 0x{b:02x}")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            if isinstance(k, memoryview):
                k = bytes(k)
            if not isinstance(k, (str, bytes)):
                raise MsgpackError(f"map key of type {type(k).__name__} (str or bytes expected)")
            out[k] = self.read()
        return out


def unpackb(data) -> Any:
    """One msgpack document: binary values as ``memoryview`` slices of
    ``data``, arrays as read-only numpy arrays."""
    return _Reader(data).document()


def _unchunk(tree):
    """flax's ``_unchunk_array_leaves_in_place``, on a copy."""
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def _binary_as_bytes(tree):
    if isinstance(tree, dict):
        return {k: _binary_as_bytes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_binary_as_bytes(v) for v in tree]
    return bytes(tree) if isinstance(tree, memoryview) else tree


def msgpack_restore(data) -> Any:
    """``flax.serialization.msgpack_restore``: the nested dicts (lists,
    scalars, arrays) of the document, chunked arrays joined."""
    return _unchunk(_binary_as_bytes(unpackb(data)))


def restore_into(target, state, path: str = "."):
    """flax's ``from_state_dict`` for trees of dicts, named tuples and
    lists: every key of a dict ``target`` must be in ``state`` (keys
    ``state`` has beyond it are dropped), a named tuple's fields must be
    exactly the state's keys; a leaf is the state's value as it was
    decoded."""
    if isinstance(target, Mapping):
        if not isinstance(state, Mapping):
            raise MsgpackError(f"expected a dict at path {path}")
        missing = {str(k) for k in target} - set(state)
        if missing:
            raise MsgpackError(
                "The target dict keys and state dict keys do not match, target "
                f"dict contains keys {missing} which are not present in state "
                f"dict at path {path}"
            )
        return {k: restore_into(v, state[str(k)], f"{path}{k}/") for k, v in target.items()}
    if is_namedtuple(target):
        if not isinstance(state, Mapping) or set(state) != set(target._fields):
            raise MsgpackError(
                "The field names of the state dict and the named tuple do not "
                f"match, got {set(state) if isinstance(state, Mapping) else state!r} "
                f"and {set(target._fields)} at path {path}"
            )
        return type(target)(**{
            k: restore_into(getattr(target, k), state[k], f"{path}{k}/") for k in target._fields
        })
    if isinstance(target, (list, tuple)):
        if len(state) != len(target):
            raise MsgpackError(f"list length mismatch at path {path}")
        out = [restore_into(v, state[str(i)], f"{path}{i}/") for i, v in enumerate(target)]
        return type(target)(out)
    return state


def from_bytes(target, data) -> Any:
    """``flax.serialization.from_bytes``: restore the document into the
    structure of ``target``."""
    return restore_into(target, msgpack_restore(data))
