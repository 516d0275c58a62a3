"""Per-leaf codecs of the port (fedtpu_torch.ops.compression) against
fedtpu's (fedtpu.ops.compression), bit for bit.

Both codecs see the same stacked smallcnn-shaped deltas and residuals (4
clients) from one numpy draw; the port's outputs and new residuals, moved
back to flax's layout with ``to_flax``, must equal fedtpu's exactly. fedtpu
runs its kernels both through the default plain-jnp branch and through the
interpreted ``pallas_call``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fedtpu.ops import compression as jcomp
from fedtpu.ops import pallas_kernels as pk
from fedtpu_torch import config as tconfig
from fedtpu_torch.convert import from_flax, to_flax
from fedtpu_torch.ops import compression as tcomp

CLIENTS = 4
SMALLCNN_SHAPES = {
    "Conv_0": {"kernel": (3, 3, 3, 32), "bias": (32,)},
    "Conv_1": {"kernel": (3, 3, 32, 64), "bias": (64,)},
    "Dense_0": {"kernel": (4096, 128), "bias": (128,)},
    "Dense_1": {"kernel": (128, 10), "bias": (10,)},
}


def _stacked(rng, scale):
    return {
        mod: {
            leaf: (scale * rng.normal(size=(CLIENTS,) + shape)).astype(np.float32)
            for leaf, shape in leaves.items()
        }
        for mod, leaves in SMALLCNN_SHAPES.items()
    }


@pytest.fixture(params=["plain_jnp", "interpret"])
def pallas_mode(request, monkeypatch):
    """fedtpu's kernels through their default branch, or forced through the
    interpreted pallas_call for the length of one test."""
    if request.param == "interpret":
        for name in ("threshold_with_feedback", "quantdequant_int8"):
            monkeypatch.setattr(
                pk, name, functools.partial(getattr(pk, name), interpret=True)
            )
    return request.param


CASES = [
    ("topk", 0.01, True),
    ("topk", 0.01, False),
    ("topk", 1.0, True),  # keep-all budget: the early return
    ("int8", None, True),
    ("int8", None, False),
]


@pytest.mark.parametrize("codec,fraction,ef", CASES)
def test_per_leaf_codec_bit_equal_to_fedtpu(codec, fraction, ef, pallas_mode):
    rng = np.random.default_rng(11)
    deltas = _stacked(rng, 0.01)
    residual = _stacked(rng, 0.003)
    if codec == "topk":
        jc = jcomp.make_topk(fraction, error_feedback=ef)
        tc = tcomp.make_topk(fraction, error_feedback=ef)
    else:
        jc = jcomp.make_int8(error_feedback=ef)
        tc = tcomp.make_int8(error_feedback=ef)
    j_state = jax.tree.map(jnp.asarray, residual) if ef else ()
    t_state = from_flax(residual) if ef else ()
    j_out, j_new = jc.apply(jax.tree.map(jnp.asarray, deltas), j_state)
    t_out, t_new = tc.apply(from_flax(deltas), t_state)

    def assert_bits(t_tree, j_tree):
        got = to_flax(t_tree)
        for mod, leaves in SMALLCNN_SHAPES.items():
            for leaf in leaves:
                want = np.asarray(j_tree[mod][leaf])
                assert got[mod][leaf].shape == want.shape
                np.testing.assert_array_equal(
                    got[mod][leaf].view(np.int32), want.view(np.int32),
                    err_msg=f"{codec} {mod}/{leaf}",
                )

    assert_bits(t_out, j_out)
    if ef:
        assert_bits(t_new, j_new)
    else:
        assert t_new == () and j_new == ()


def test_codec_counts_one_kernel_call_per_leaf():
    """The round's launch count per codec is one per leaf: eight on smallcnn
    (on the CPU the wrapper runs its plain version, so a spy counts)."""
    calls = []

    def spy(y, t):
        calls.append(tuple(y.shape))
        return tcomp.kernels.threshold_feedback(y, t)

    deltas = from_flax(_stacked(np.random.default_rng(3), 0.01))
    comp = tcomp.make_topk(0.01, threshold=spy)
    comp.apply(deltas, comp.init({k: v[0] for k, v in deltas.items()}, CLIENTS))
    assert sorted(c for _, c in calls) == sorted(
        int(np.prod(s)) for leaves in SMALLCNN_SHAPES.values() for s in leaves.values()
    )


def test_flat_layout_names_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcomp.make_compressor(tconfig.FedConfig(compression="topk", delta_layout="flat"))
