"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA card and skip without one. They import neither
JAX nor fedtpu, so they also run where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which sets up JAX.) Their
inputs are the CPU tests' (``test_torch_kernels.py``): ties at the
threshold, -0.0, zero scales and halfway quotients, at smallcnn's widths.
"""

import numpy as np
import pytest
import torch

from fedtpu_torch.ops import kernels

# (rows, cols): smallcnn leaf widths at 4 and 64 clients, one row, one
# column, and widths that are not multiples of the kernels' 256-thread block.
SHAPES = [
    (4, 864), (4, 32), (4, 1280), (4, 10), (1, 1), (1, 700), (3, 257), (2, 1),
    (64, 524288), (64, 18432),
]


def _threshold_inputs(rng, rows, cols):
    y = rng.normal(size=(rows, cols)).astype(np.float32)
    y[0, 0] = -0.0
    t = np.abs(y[:, min(1, cols - 1)]).astype(np.float32)  # row 0: a tie
    t[1::2] = np.float32(0.5)
    if rows > 2:
        t[2] = 0.0
    return y, t


def _quant_inputs(rng, rows, cols):
    x = rng.normal(size=(rows, cols)).astype(np.float32)
    scale = (np.abs(x).max(axis=1) / np.float32(127.0)).astype(np.float32)
    if rows > 1:
        k = rng.integers(-130, 130, size=cols)
        x[1] = ((k + 0.5) * 0.25).astype(np.float32)  # x / s at k + 0.5
        scale[1] = 0.25
    if rows > 2:
        x[2] = 0.0
        scale[2] = 0.0
    return x, scale


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    torch.cuda.init()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols", SHAPES)
def test_threshold_feedback_kernel_bit_equal_on_card(cuda_device, rows, cols):
    y, t = _threshold_inputs(np.random.default_rng(cols), rows, cols)
    yd, td = torch.from_numpy(y).to(cuda_device), torch.from_numpy(t).to(cuda_device)
    before = kernels.threshold_feedback.launches
    out, e = kernels.threshold_feedback(yd, td)
    torch.cuda.synchronize()
    assert kernels.threshold_feedback.launches == before + 1
    ref_out, ref_e = kernels.threshold_feedback_plain(yd, td)
    assert torch.equal(out.view(torch.int32), ref_out.view(torch.int32))
    assert torch.equal(e.view(torch.int32), ref_e.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols", SHAPES)
def test_quantdequant_int8_kernel_bit_equal_on_card(cuda_device, rows, cols):
    x, s = _quant_inputs(np.random.default_rng(cols + 1), rows, cols)
    xd, sd = torch.from_numpy(x).to(cuda_device), torch.from_numpy(s).to(cuda_device)
    before = kernels.quantdequant_int8.launches
    out = kernels.quantdequant_int8(xd, sd)
    torch.cuda.synchronize()
    assert kernels.quantdequant_int8.launches == before + 1
    ref = kernels.quantdequant_int8_plain(xd, sd)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(kernels.KERNELS))
def test_wrapper_rejects_bad_operands_on_card(cuda_device, name):
    wrapper, _ = kernels.KERNELS[name]
    x = torch.zeros((4, 16), device=cuda_device)
    v = torch.ones((4,), device=cuda_device)
    with pytest.raises(TypeError):
        wrapper(x.double(), v.double())
    with pytest.raises(ValueError):
        wrapper(torch.zeros((16, 4), device=cuda_device).t(), v)  # not contiguous
    with pytest.raises(ValueError):
        wrapper(x, v[:3])
