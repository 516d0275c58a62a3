"""The port's FSP1 records against fedtpu's, with fedtpu's native codec
loaded (``native/codec.cpp``, built here if it is not).

For the same delta tree and residual, every encoder's bytes are identical
and its returned residual bit-equal; each package decodes the other's
records (``decode`` and ``decode_into_row``) to bit-equal values. The
port's numpy versions of the native entry points are held against the
native library itself.
"""

import jax
import numpy as np
import pytest
import torch

from fedtpu import native
from fedtpu.transport import sparse as jsparse
from fedtpu_torch.transport import sparse as tsparse
from fedtpu_torch.transport import wire as twire


@pytest.fixture(scope="module", autouse=True)
def native_codec():
    assert native.ensure_built(), "fedtpu's native codec did not build"
    assert native.available()


def _tree(rng, zero_leaf=False):
    """A delta tree of the edge's shape: params and BatchNorm statistics,
    flax layout, with ties, exact zeros and a -0.0."""
    k = rng.normal(size=(3, 3, 3, 8)).astype(np.float32)
    k[0, 0, 0, :4] = k[0, 0, 0, 4]  # a run of equal magnitudes
    d = rng.normal(size=(72, 10)).astype(np.float32) * 1e-3
    d[5] = 0.0
    d[6, 0] = -0.0
    return {
        "params": {
            "Conv_0": {"kernel": k, "bias": np.zeros(8, np.float32) if zero_leaf else rng.normal(size=8).astype(np.float32)},
            "Dense_0": {"kernel": d, "bias": rng.normal(size=10).astype(np.float32) * 10},
        },
        "batch_stats": {"BatchNorm_0": {"mean": rng.normal(size=8).astype(np.float32),
                                        "var": rng.random(8).astype(np.float32)}},
    }


def _bits_equal(a, b):
    la, lb = jax.tree_util.tree_leaves(a), twire.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes()


_ENCODERS = [
    ("encode_topk", dict(fraction=0.1)),
    ("encode_topk", dict(fraction=0.01)),
    ("encode_int8", {}),
    ("encode_topk_flat", dict(fraction=0.1)),
    ("encode_topk_flat", dict(fraction=0.003)),
    ("encode_int8_flat", {}),
    ("encode_rotq_flat", dict(bits=1, seed=5)),
    ("encode_rotq_flat", dict(bits=2, seed=(7 << 16) | 3)),
    ("encode_rotq_flat", dict(bits=4, seed=2**40 + 1)),
    ("encode_rotq_flat", dict(bits=8, seed=0)),
    ("encode_randk_flat", dict(fraction=0.1, seed=11)),
    ("encode_randk_flat", dict(fraction=1.0, seed=1)),
]


@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("collect", [True, False])
@pytest.mark.parametrize("name,kw", _ENCODERS, ids=[f"{n}-{i}" for i, (n, _) in enumerate(_ENCODERS)])
def test_encoder_bytes_residuals_and_decodes_equal(name, kw, collect, with_residual):
    rng = np.random.default_rng(len(name) * 7 + int(collect) + 2 * int(with_residual))
    delta = _tree(rng)
    residual = _tree(rng) if with_residual else None
    extra = {"num_examples": np.float32(32.0)}
    want, want_res = getattr(jsparse, name)(delta, residuals=residual, extra=extra, collect_residual=collect, **kw)
    got, got_res = getattr(tsparse, name)(delta, residuals=residual, extra=extra, collect_residual=collect, **kw)
    assert got == want
    if collect:
        _bits_equal(want_res, got_res)
    else:
        assert want_res is None and got_res is None
    like = jax.tree.map(np.zeros_like, delta)
    # Each package decodes the other's bytes.
    dj, ej = jsparse.decode(got, like)
    dt, et = tsparse.decode(want, like)
    _bits_equal(dj, dt)
    assert ej["_codec"] == et["_codec"] and float(et["num_examples"]) == 32.0
    sizes = [a.size for a in jax.tree_util.tree_leaves(delta)]
    row_j = np.full(sum(sizes) + 7, 9.0, np.float32)
    row_t = row_j.copy()
    jsparse.decode_into_row(got, sizes, row_j)
    tsparse.decode_into_row(want, sizes, row_t)
    assert row_t.tobytes() == row_j.tobytes()  # the pad past total untouched too
    dev_row = torch.full((sum(sizes) + 7,), 9.0)
    tsparse.decode_into_row(want, sizes, dev_row)
    assert dev_row.numpy().tobytes() == row_j.tobytes()


@pytest.mark.parametrize("name", ["encode_topk", "encode_topk_flat"])
def test_topk_of_zero_leaves_equal(name):
    rng = np.random.default_rng(4)
    for delta in (_tree(rng, zero_leaf=True), jax.tree.map(np.zeros_like, _tree(rng))):
        want, wr = getattr(jsparse, name)(delta, 0.05, extra={"num_examples": np.float32(1)})
        got, gr = getattr(tsparse, name)(delta, 0.05, extra={"num_examples": np.float32(1)})
        assert got == want
        _bits_equal(wr, gr)


def test_partial_flat_equal():
    rng = np.random.default_rng(5)
    sizes = [72, 8, 10, 720, 8, 8]
    row = rng.normal(size=sum(sizes)).astype(np.float32)
    extra = {"weight_sum": np.float32(96.0), "clients": np.int64(3)}
    want = jsparse.encode_partial_flat(row, sizes, extra)
    assert tsparse.encode_partial_flat(row, sizes, extra) == want
    out_j, out_t = np.zeros(sum(sizes), np.float32), np.zeros(sum(sizes), np.float32)
    assert float(jsparse.decode_into_row(want, sizes, out_j)["weight_sum"]) == 96.0
    assert float(tsparse.decode_into_row(want, sizes, out_t)["weight_sum"]) == 96.0
    assert out_t.tobytes() == out_j.tobytes() == row.tobytes()


def test_untrusted_records_refused_as_fedtpu_refuses_them():
    rng = np.random.default_rng(6)
    delta = _tree(rng)
    sizes = [a.size for a in jax.tree_util.tree_leaves(delta)]
    rec, _ = jsparse.encode_topk_flat(delta, 0.1)
    with pytest.raises(twire.WireError):
        tsparse.decode_into_row(rec, sizes[:-1] + [sizes[-1] + 1], np.zeros(sum(sizes) + 1, np.float32))
    with pytest.raises(twire.WireError, match="CRC"):
        tsparse.decode_into_row(rec[:-1] + bytes([rec[-1] ^ 1]), sizes, np.zeros(sum(sizes), np.float32))
    bad = {"kind": "topk_flat", "sizes": np.asarray(sizes, np.int64), "idx": np.asarray([sum(sizes)], np.int32),
           "vals": np.ones(1, np.float32), "extra": {}}
    from flax import serialization

    forged = jsparse._frame(serialization.msgpack_serialize(bad))
    for mod in (jsparse, tsparse):
        with pytest.raises(mod.WireError, match="out of range"):
            mod.decode_into_row(forged, sizes, np.zeros(sum(sizes), np.float32))


def test_numpy_codec_equals_native():
    rng = np.random.default_rng(8)
    for x in (rng.normal(size=10007).astype(np.float32),
              np.round(rng.normal(size=4096), 1).astype(np.float32),  # many ties
              np.zeros(300, np.float32),
              np.array([0.0, -0.0, 1.0, -1.0, 127.0, 0.5, -0.5], np.float32)):
        for k in (1, 7, x.size // 3, x.size, x.size + 5):
            assert tsparse.kth_magnitude(x, k) == native.kth_magnitude(x, k)
        t = native.kth_magnitude(x, max(1, x.size // 10))
        for a, b in zip(tsparse.pack_sparse(x, t), native.pack_sparse(x, t)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        for a, b in zip(tsparse.pack_sparse_with_residual(x, t), native.pack_sparse_with_residual(x, t)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        codes_t, scale_t = tsparse.quant_int8(x)
        codes_n, scale_n = native.quant_int8(x)
        assert scale_t == scale_n and codes_t.tobytes() == codes_n.tobytes()
        assert (tsparse.dequant_int8(codes_n, scale_n, x.size).tobytes()
                == native.dequant_int8(codes_n, scale_n, x.size).tobytes())
        idx, vals = native.pack_sparse(x, t)
        assert tsparse.unpack_sparse(idx, vals, x.size).tobytes() == native.unpack_sparse(idx, vals, x.size).tobytes()
    with pytest.raises(twire.WireError):
        tsparse.dequant_int8(np.zeros(3, np.int8), 1.0, 4)
