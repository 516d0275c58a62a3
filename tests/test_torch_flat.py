"""The port's flat delta layout, K3 and flat codecs against fedtpu's.

- The packed ``[clients, P]`` row (``fedtpu_torch.ops.flat``) is fedtpu's
  row bit for bit: leaves in flax's order (bias before kernel) and layout
  (HWIO, ``[in, out]``), padded alike.
- K3's plain version (``kernels.hadamard_rotate_plain``) is bit-equal to
  fedtpu's ``hadamard_rotate`` through the interpreted ``pallas_call``
  (h <= 1024) and its plain-XLA branch (h up to 2^14), forward and inverse,
  and its butterfly to the numpy ``_fwht_np`` of fedtpu's wire decoder.
- The flat codecs, fed the same deltas, residuals and fedtpu's own
  ``jax.random`` draws (signs, uniforms, coordinates), give fedtpu's output
  and residual bit for bit.

Inputs are smallcnn-shaped (4 clients, P = 545,098) from one numpy draw.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedtpu.ops import compression as jcomp
from fedtpu.ops import flat as jflat
from fedtpu.ops import pallas_kernels as pk
from fedtpu.transport.sparse import _fwht_np
from fedtpu_torch import models as tmodels
from fedtpu_torch.convert import from_flax
from fedtpu_torch.ops import compression as tcomp
from fedtpu_torch.ops import flat as tflat
from fedtpu_torch.ops import kernels
from test_torch_compression import CLIENTS, _stacked
from test_torch_cuda import _hadamard_inputs


def _bits(t):
    a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return a.view(np.int32)


def _assert_bits(got, want, msg=""):
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=msg)


def _both_rows(flax_stacked, pow2=False):
    """The same stacked params packed by both packages, with the layouts."""
    single = jax.tree.map(lambda a: jnp.asarray(a[0]), flax_stacked)
    jlay = jflat.make_layout(single, pow2=pow2)
    jrow = jflat.pack_stacked(jlay, jax.tree.map(jnp.asarray, flax_stacked))
    tstacked = from_flax(flax_stacked)
    tlay = tflat.make_layout({k: v[0] for k, v in tstacked.items()}, pow2=pow2)
    return jlay, jrow, tlay, tflat.pack_stacked(tlay, tstacked)


# --------------------------------------------------------------- layout


@pytest.mark.parametrize("pow2", [False, True])
def test_pack_stacked_is_fedtpus_row(pow2):
    stacked = _stacked(np.random.default_rng(0), 0.01)
    jlay, jrow, tlay, trow = _both_rows(stacked, pow2)
    assert (tlay.offsets, tlay.sizes, tlay.total, tlay.padded) == (
        jlay.offsets, jlay.sizes, jlay.total, jlay.padded
    )
    assert tlay.names[:2] == ("Conv_0.bias", "Conv_0.weight")
    _assert_bits(trow, jrow)
    # And back: the torch leaves exactly, fedtpu's unpack of one row too.
    back = tflat.unpack_stacked(tlay, trow)
    for k, v in from_flax(stacked).items():
        assert torch.equal(back[k], v), k
    one = tflat.unpack(tlay, trow[2])
    want = from_flax(jax.tree.map(np.asarray, jflat.unpack(jlay, jrow[2])))
    for k, v in want.items():
        _assert_bits(one[k], v, k)


def test_smallcnn_pow2_row_is_two_to_the_twenty():
    params = {k: p.detach() for k, p in tmodels.create("smallcnn", 10).named_parameters()}
    lay = tflat.make_layout(params, pow2=True)
    assert lay.total == 545_098 and lay.padded == 2**20
    assert tflat.make_layout(params).padded == 545_152


@pytest.mark.parametrize("fraction", [0.01, 0.3, 1.0])
def test_topk_threshold_bit_equal(fraction):
    _, jrow, tlay, trow = _both_rows(_stacked(np.random.default_rng(2), 0.01))
    want = jflat.topk_threshold(jrow, fraction, tlay.total)
    got = tflat.topk_threshold(trow, fraction, tlay.total)
    if fraction == 1.0:
        assert got is None and want is None
    else:
        _assert_bits(got, want)


def test_int8_scales_and_segments_bit_equal():
    jlay, jrow, tlay, trow = _both_rows(_stacked(np.random.default_rng(3), 0.01))
    np.testing.assert_array_equal(tflat.segment_ids(tlay), jflat.segment_ids(jlay))
    _assert_bits(tflat.int8_scales(trow, tlay), jflat.int8_scales(jrow, jlay))


# ------------------------------------------------------------------- K3


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("mode,h", [
    ("interpret", 128), ("interpret", 256), ("interpret", 1024),
    ("xla", 128), ("xla", 1024), ("xla", 4096), ("xla", 2**14),
])
def test_hadamard_plain_bit_equal_to_fedtpu(mode, h, inverse):
    y, signs = _hadamard_inputs(np.random.default_rng(h), 3, h)
    want = pk.hadamard_rotate(
        jnp.asarray(y), jnp.asarray(signs), inverse=inverse,
        interpret=True if mode == "interpret" else None,
    )
    got = kernels.hadamard_rotate_plain(torch.from_numpy(y), torch.from_numpy(signs), inverse)
    _assert_bits(got, want)


@pytest.mark.parametrize("h", [1, 2, 128, 2**12, 2**15])
def test_fwht_plain_bit_equal_to_wire_decoder(h):
    y, _ = _hadamard_inputs(np.random.default_rng(h + 1), 2, h)
    got = kernels.fwht_plain(torch.from_numpy(y))
    for r in range(2):
        _assert_bits(got[r], _fwht_np(y[r]))


def test_hadamard_rotation_pair_is_identity_and_checks_width():
    y, signs = _hadamard_inputs(np.random.default_rng(9), 3, 1024)
    y[-1] = np.random.default_rng(10).normal(size=1024)  # no 1e30 here
    yt, st = torch.from_numpy(y), torch.from_numpy(signs)
    back = kernels.hadamard_rotate(kernels.hadamard_rotate(yt, st), st, inverse=True)
    np.testing.assert_allclose(back.numpy(), y, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="power-of-two"):
        kernels.hadamard_rotate(yt[:, :100], st[:100])
    with pytest.raises(ValueError, match="signs"):
        kernels.hadamard_rotate(yt, st[:512])


# ------------------------------------------------------------ flat codecs


def _fedtpu_rotq_draws(rows, h, round_idx):
    """fedtpu's rotq draws, taken the way _make_rotq_flat takes them."""
    key = jax.random.fold_in(jax.random.PRNGKey(jcomp._ROTQ_SEED), round_idx)
    k_sign, k_unif = jax.random.split(key)
    signs = jax.random.rademacher(k_sign, (h,), jnp.float32)
    uniforms = jax.random.uniform(k_unif, (rows, h), jnp.float32)
    return torch.tensor(np.asarray(signs)), torch.tensor(np.asarray(uniforms))


def _fedtpu_randk_indices(total, fraction, round_idx):
    """fedtpu's randk coordinate set, taken the way _make_randk_flat does."""
    k = max(1, int(np.ceil(fraction * total)))
    key = jax.random.fold_in(jax.random.PRNGKey(jcomp._RANDK_SEED), round_idx)
    return torch.tensor(np.asarray(jax.random.choice(key, total, (k,), replace=False)))


ROUND = 5
FLAT_CASES = [
    ("topk", dict(fraction=0.01)),
    ("topk", dict(fraction=1.0)),  # keep-all budget
    ("int8", {}),
    ("rotq", dict(bits=1)),
    ("rotq", dict(bits=2)),
    ("rotq", dict(bits=4)),
    ("rotq", dict(bits=8)),
    ("randk", dict(fraction=0.05)),
]


def _codecs(codec, kw, ef):
    if codec == "topk":
        return (jcomp.make_topk(kw["fraction"], ef, layout="flat"),
                tcomp.make_topk(kw["fraction"], ef, layout="flat"))
    if codec == "int8":
        return jcomp.make_int8(ef, layout="flat"), tcomp.make_int8(ef, layout="flat")
    if codec == "rotq":
        return jcomp.make_rotq(kw["bits"], ef), tcomp.make_rotq(kw["bits"], ef)
    return jcomp.make_randk(kw["fraction"], ef), tcomp.make_randk(kw["fraction"], ef)


@pytest.mark.parametrize("ef", [True, False], ids=["ef", "no_ef"])
@pytest.mark.parametrize("codec,kw", FLAT_CASES, ids=lambda v: str(v))
def test_flat_codec_bit_equal_to_fedtpu(codec, kw, ef):
    rng = np.random.default_rng(17)
    deltas, residual = _stacked(rng, 0.01), _stacked(rng, 0.003)
    jc, tc = _codecs(codec, kw, ef)
    jlay, jy, tlay, ty = _both_rows(deltas, pow2=jc.pad_pow2)
    assert tc.pad_pow2 == jc.pad_pow2 and tc.layout == jc.layout == "flat"
    if ef:
        _, js, _, ts = _both_rows(residual, pow2=jc.pad_pow2)
    else:
        js = ts = ()
    j_kw, t_kw = {}, {}
    if codec in ("rotq", "randk"):
        j_kw["round_idx"] = t_kw["round_idx"] = ROUND
    if codec == "rotq":
        t_kw["signs"], t_kw["uniforms"] = _fedtpu_rotq_draws(CLIENTS, tlay.padded, ROUND)
    if codec == "randk":
        t_kw["indices"] = _fedtpu_randk_indices(tlay.total, kw["fraction"], ROUND)
    j_out, j_new = jc.apply_flat(jy, js, jlay, **j_kw)
    t_out, t_new = tc.apply_flat(ty, ts, tlay, **t_kw)
    _assert_bits(t_out, j_out, "output")
    if ef:
        _assert_bits(t_new, j_new, "residual")
    else:
        assert t_new == () and j_new == ()
    # The dict-level apply of the flat codec unpacks the same row.
    if codec in ("topk", "int8"):
        t_tree, _ = tc.apply(from_flax(deltas), ts)
        for k, v in tflat.unpack_stacked(tlay, t_out).items():
            _assert_bits(t_tree[k], v, k)


@pytest.mark.parametrize("ef", [True, False], ids=["ef", "no_ef"])
def test_flat_int8_bit_equal_to_per_leaf_int8(ef):
    rng = np.random.default_rng(5)
    deltas, residual = from_flax(_stacked(rng, 0.01)), from_flax(_stacked(rng, 0.003))
    per_leaf, flat = tcomp.make_int8(ef), tcomp.make_int8(ef, layout="flat")
    lay = tflat.make_layout({k: v[0] for k, v in deltas.items()})
    p_out, p_new = per_leaf.apply(deltas, residual if ef else ())
    f_out, f_new = flat.apply(deltas, tflat.pack_stacked(lay, residual) if ef else ())
    for k in deltas:
        _assert_bits(f_out[k], p_out[k], k)
    if ef:
        _assert_bits(f_new, tflat.pack_stacked(lay, p_new))


@pytest.mark.parametrize("codec", ["rotq", "randk"])
def test_seeded_codec_replays_its_round(codec):
    """Without injected draws a round's draws come from its seed: the same
    round twice gives the same bits, another round other bits."""
    comp = tcomp.make_rotq(4) if codec == "rotq" else tcomp.make_randk(0.05)
    deltas = from_flax(_stacked(np.random.default_rng(6), 0.01))
    lay = tflat.make_layout({k: v[0] for k, v in deltas.items()}, pow2=comp.pad_pow2)
    y = tflat.pack_stacked(lay, deltas)
    state = comp.init({k: v[0] for k, v in deltas.items()}, CLIENTS)
    assert state.shape == (CLIENTS, lay.padded) and not state.any()
    a, _ = comp.apply_flat(y, state, lay, round_idx=3)
    b, _ = comp.apply_flat(y, state, lay, round_idx=3)
    c, _ = comp.apply_flat(y, state, lay, round_idx=4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not a[:, lay.total :].any()


def test_cpu_hadamard_wrapper_runs_plain_without_counting():
    kernels.reset_launch_counts()
    y, signs = _hadamard_inputs(np.random.default_rng(4), 2, 256)
    yt, st = torch.from_numpy(y), torch.from_numpy(signs)
    for inverse in (False, True):
        got = kernels.hadamard_rotate(yt, st, inverse=inverse)
        assert torch.equal(got, kernels.hadamard_rotate_plain(yt, st, inverse))
    assert kernels.hadamard_rotate.launches == 0


def test_codec_launches_k3_twice_and_k1_once_per_flat_round():
    """The flat codecs' kernel calls per round: rotq rotates twice, flat
    topk thresholds once (spies count, as the CPU wrappers do not)."""
    calls = []

    def spy(fn):
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            calls.append(fn.__name__)
            return fn(*a, **kw)
        return wrapped

    deltas = from_flax(_stacked(np.random.default_rng(7), 0.01))
    single = {k: v[0] for k, v in deltas.items()}
    for comp, want in (
        (tcomp.make_rotq(4, rotate=spy(kernels.hadamard_rotate)), ["hadamard_rotate"] * 2),
        (tcomp.make_topk(0.01, layout="flat", threshold=spy(kernels.threshold_feedback_grouped)),
         ["threshold_feedback_grouped"]),
    ):
        calls.clear()
        comp.apply(deltas, comp.init(single, CLIENTS))
        assert calls == want


def test_nested_batch_norm_tree_packs_as_fedtpus_row():
    """BatchNorm's ``scale`` leaf and nested module paths: flax's sorted
    order (``Block_10`` before ``Block_2``, ``bias`` before ``scale``) and
    layout, bit for bit."""
    rng = np.random.default_rng(12)
    shapes = {
        "BatchNorm_0": {"scale": (6,), "bias": (6,)},
        "Block_2": {"Conv_0": {"kernel": (3, 3, 1, 6)}, "BatchNorm_0": {"scale": (6,), "bias": (6,)}},
        "Block_10": {"Conv_1": {"kernel": (1, 1, 6, 5)}},
        "Dense_0": {"kernel": (5, 3), "bias": (3,)},
    }
    stacked = jax.tree.map(
        lambda s: rng.normal(size=(CLIENTS,) + s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple),
    )
    jlay, jrow, tlay, trow = _both_rows(stacked)
    assert tlay.names[:3] == ("BatchNorm_0.bias", "BatchNorm_0.scale", "Block_10.Conv_1.weight")
    assert (tlay.offsets, tlay.sizes) == (jlay.offsets, jlay.sizes)
    _assert_bits(trow, jrow)
