"""The port's CUDA kernels (fedtpu_torch.ops.kernels) against fedtpu's
Pallas kernels.

On the CPU the plain PyTorch versions are held bit-equal to fedtpu's
``threshold_with_feedback`` / ``quantdequant_int8``, both through the
interpreted ``pallas_call`` (``interpret=True``) and through the default
plain-jnp branch, including ties at the threshold, zero scales and
``x / s`` exactly halfway between integers. The kernels themselves are
held against the plain versions on the card by ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedtpu.ops import pallas_kernels as pk
from fedtpu_torch.ops import kernels
from test_torch_cuda import SHAPES as CUDA_SHAPES, _quant_inputs, _threshold_inputs

PALLAS_MODES = [{"interpret": True}, {}]

# The CPU shapes of the card tests (the 64-row widths run there only).
SHAPES = [s for s in CUDA_SHAPES if s[0] < 64]


@pytest.mark.parametrize("mode", PALLAS_MODES, ids=["interpret", "plain_jnp"])
@pytest.mark.parametrize("rows,cols", SHAPES)
def test_threshold_feedback_plain_matches_pallas(rows, cols, mode):
    y, t = _threshold_inputs(np.random.default_rng(rows * 1000 + cols), rows, cols)
    out_j, e_j = pk.threshold_with_feedback(jnp.asarray(y), jnp.asarray(t), **mode)
    out_t, e_t = kernels.threshold_feedback_plain(torch.from_numpy(y), torch.from_numpy(t))
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
    # Bit patterns too: assert_array_equal treats -0.0 == 0.0.
    np.testing.assert_array_equal(out_t.numpy().view(np.int32), np.asarray(out_j).view(np.int32))
    np.testing.assert_array_equal(e_t.numpy().view(np.int32), np.asarray(e_j).view(np.int32))


@pytest.mark.parametrize("mode", PALLAS_MODES, ids=["interpret", "plain_jnp"])
@pytest.mark.parametrize("rows,cols", SHAPES)
def test_quantdequant_int8_plain_matches_pallas(rows, cols, mode):
    x, s = _quant_inputs(np.random.default_rng(rows * 1000 + cols + 7), rows, cols)
    out_j = pk.quantdequant_int8(jnp.asarray(x), jnp.asarray(s), **mode)
    out_t = kernels.quantdequant_int8_plain(torch.from_numpy(x), torch.from_numpy(s))
    np.testing.assert_array_equal(out_t.numpy().view(np.int32), np.asarray(out_j).view(np.int32))


def test_halfway_values_round_to_even():
    x = torch.tensor([[0.5, 1.5, 2.5, -0.5, -2.5, 126.5, 127.5, -300.0]])
    out = kernels.quantdequant_int8_plain(x, torch.tensor([1.0]))
    assert out.tolist() == [[0.0, 2.0, 2.0, -0.0, -2.0, 126.0, 127.0, -127.0]]


def test_cpu_wrappers_take_plain_path_without_counting():
    kernels.reset_launch_counts()
    y, t = _threshold_inputs(np.random.default_rng(1), 3, 300)
    out, e = kernels.threshold_feedback(torch.from_numpy(y), torch.from_numpy(t))
    ref_out, ref_e = kernels.threshold_feedback_plain(torch.from_numpy(y), torch.from_numpy(t))
    assert torch.equal(out, ref_out) and torch.equal(e, ref_e)
    x, s = _quant_inputs(np.random.default_rng(2), 3, 300)
    q = kernels.quantdequant_int8(torch.from_numpy(x), torch.from_numpy(s))
    assert torch.equal(q, kernels.quantdequant_int8_plain(torch.from_numpy(x), torch.from_numpy(s)))
    assert kernels.threshold_feedback.launches == 0
    assert kernels.quantdequant_int8.launches == 0


@pytest.mark.parametrize("name", sorted(kernels.KERNELS))
def test_wrapper_never_falls_back_off_the_cpu(name):
    """A tensor that lies neither on the CPU nor on a card is refused, not
    computed by the plain version."""
    wrapper, _ = kernels.KERNELS[name]
    x = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(x, torch.empty((2,), device="meta"))
