"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA card and skip without one. They import neither
JAX nor fedtpu, so they also run where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which sets up JAX.) Their
inputs are the CPU tests' (``test_torch_kernels.py``, ``test_torch_flat.py``):
ties at the threshold, -0.0, zero scales and halfway quotients at smallcnn's
widths; -0.0, zeros and large magnitudes for the Hadamard rotation at the
rotq rows (smallcnn's [64, 2^20], MobileNet's [64, 2^22], ShuffleNetV2's
[64, 2^21]) and widths around its phase boundary; and a small MobileNet
round on the card against the same round on the CPU. The grouped kernels
(top-k threshold and int8) also take lists of leaves: the 83 of a
MobileNet round and the 170 of a ShuffleNetV2 one, empty and ragged
leaves, views off 16-byte alignment, and more leaves than one launch's
table holds; the top-k threshold also a leaf of 70,000 rows.
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


# (rows, h): the smallcnn rotq round's [clients, 2^20], the MobileNet rotq
# round's [64, 2^22] (1 GiB a call) and an [8, 2^22], the smallest width, widths around the kernel's 2^13-element tile (the widest
# one-phase row and the narrowest two-phase one), row counts that are not a
# multiple of the kernel's lag between phases, and a 2^21 row.
HADAMARD_SHAPES = [
    (64, 2**20), (64, 2**22), (8, 2**22), (3, 128), (1, 2**12), (5, 2**13),
    (64, 2**14), (3, 2**20), (65, 2**14), (1, 2**13), (2, 2**21),
]


def _hadamard_inputs(rng, rows, h):
    """Normal rows with a -0.0, zeros and large magnitudes mixed in (the
    sums then round at many places)."""
    y = rng.standard_normal((rows, h), dtype=np.float32)
    y[0, 0] = -0.0
    y[0, 1 : 1 + h // 8] = 0.0
    y[-1, :: max(h // 16, 1)] = np.float32(1e30)
    signs = (rng.integers(0, 2, size=h) * 2 - 1).astype(np.float32)
    return y, signs


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


def _quant_leaves(rng, shapes):
    """One ``_quant_inputs`` leaf per shape (zeros for an empty one), a NaN
    in the last column of every leaf of more than 3 columns."""
    leaves = []
    for rows, cols in shapes:
        if rows * cols == 0:
            leaves.append((np.zeros((rows, cols), np.float32), np.zeros(rows, np.float32)))
            continue
        x, s = _quant_inputs(rng, rows, cols)
        if cols > 3:
            x[0, -1] = np.nan
        leaves.append((x, s))
    return leaves


def _leaf_shapes(name="mobilenet", clients=64):
    from fedtpu_torch import models

    with torch.device("meta"):
        model = models.create(name, 10)
    return [(clients, p.numel()) for p in model.parameters()]


# Lists of K2 leaves, each one grouped call: leaves of every edge width
# (empty, one column, cols not a multiple of 4, 65,537 columns), and a list
# longer than one launch's table of leaves.
GROUPED_CASES = {
    "ragged": [(1, 1), (1, 700), (3, 257), (2, 1), (64, 1000), (5, 65537), (4, 10)],
    "mixed": [(0, 5), (3, 0), (2, 1), (3, 10), (0, 0), (2, 65537), (1, 3), (5, 7)],
    "longer_than_a_table": [(2, 1 + i % 37) for i in range(200)],
}


# name -> (grouped wrapper, plain version of one leaf, leaves a launch)
GROUPED = {
    "quantdequant_int8": (kernels.quantdequant_int8_grouped, kernels.quantdequant_int8_plain,
                          kernels.INT8_GROUP_CAPACITY),
    "threshold_feedback": (kernels.threshold_feedback_grouped, kernels.threshold_feedback_plain,
                           kernels.THRESHOLD_GROUP_CAPACITY),
}


def _grouped_on_card(cuda_device, leaves, misaligned=(), name="quantdequant_int8"):
    """The grouped kernel ``name`` on ``leaves`` (numpy pairs), the leaves
    at ``misaligned`` passed as views one float off 16-byte alignment:
    bit-equal to the plain version leaf by leaf, with one launch per table
    of leaves."""
    grouped, plain, capacity = GROUPED[name]
    counted = kernels.KERNELS[name][0]
    xs, ss = [], []
    for i, (x, s) in enumerate(leaves):
        xd = torch.from_numpy(x).to(cuda_device)
        if i in misaligned:
            buf = torch.zeros(x.size + 1, device=cuda_device)
            buf[1:] = xd.reshape(-1)
            xd = buf[1:].view(x.shape)
            assert xd.data_ptr() % 16
        xs.append(xd)
        ss.append(torch.from_numpy(s).to(cuda_device))
    before = counted.launches
    outs = grouped(xs, ss)
    torch.cuda.synchronize()
    nonempty = sum(x.numel() > 0 for x in xs)
    want = -(-nonempty // capacity)
    assert counted.launches == before + want
    per_leaf = list(zip(*outs)) if isinstance(outs, tuple) else [(o,) for o in outs]
    for x, s, got in zip(xs, ss, per_leaf):
        ref = plain(x, s)
        for g, r in zip(got, ref if isinstance(ref, tuple) else (ref,)):
            assert g.shape == x.shape
            assert torch.equal(g.view(torch.int32), r.view(torch.int32)), tuple(x.shape)
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GROUPED_CASES))
def test_quantdequant_int8_grouped_bit_equal_on_card(cuda_device, case):
    leaves = _quant_leaves(np.random.default_rng(len(case)), GROUPED_CASES[case])
    _grouped_on_card(cuda_device, leaves)


@pytest.mark.cuda
def test_quantdequant_int8_grouped_mobilenet_round_in_one_launch_on_card(cuda_device):
    """MobileNet's 83 leaves at 64 clients, as a per-leaf int8 round
    quantizes them: one launch."""
    shapes = _leaf_shapes()
    assert len(shapes) == 83
    _grouped_on_card(cuda_device, _quant_leaves(np.random.default_rng(83), shapes))


@pytest.mark.cuda
def test_quantdequant_int8_grouped_shufflenetv2_round_in_two_launches_on_card(cuda_device):
    """ShuffleNetV2's 170 leaves at 64 clients, as a per-leaf int8 round
    quantizes them: two launches (the table holds 90 leaves)."""
    shapes = _leaf_shapes("shufflenetv2")
    assert len(shapes) == 170
    leaves = _quant_leaves(np.random.default_rng(170), shapes)
    assert _grouped_on_card(cuda_device, leaves) == 2


@pytest.mark.cuda
def test_quantdequant_int8_grouped_takes_misaligned_views_on_card(cuda_device):
    """Leaves that start one float past 16-byte alignment (narrow, ragged
    and wide) beside aligned ones."""
    shapes = [(3, 4099), (1, 2), (2, 65537), (4, 10), (64, 1000), (1, 1)]
    leaves = _quant_leaves(np.random.default_rng(5), shapes)
    _grouped_on_card(cuda_device, leaves, misaligned=(0, 1, 2, 5))


def _threshold_leaves(rng, shapes):
    """One ``_threshold_inputs`` leaf per shape (zeros for an empty one), a
    NaN in the last column of every leaf of more than 3 columns."""
    leaves = []
    for rows, cols in shapes:
        if rows * cols == 0:
            leaves.append((np.zeros((rows, cols), np.float32), np.zeros(rows, np.float32)))
            continue
        y, t = _threshold_inputs(rng, rows, cols)
        if cols > 3:
            y[0, -1] = np.nan
        leaves.append((y, t))
    return leaves


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GROUPED_CASES))
def test_threshold_feedback_grouped_bit_equal_on_card(cuda_device, case):
    leaves = _threshold_leaves(np.random.default_rng(len(case) + 1), GROUPED_CASES[case])
    _grouped_on_card(cuda_device, leaves, name="threshold_feedback")


@pytest.mark.cuda
def test_threshold_feedback_grouped_takes_misaligned_views_on_card(cuda_device):
    shapes = [(3, 4099), (1, 2), (2, 65537), (4, 10), (64, 1000), (1, 1)]
    leaves = _threshold_leaves(np.random.default_rng(6), shapes)
    _grouped_on_card(cuda_device, leaves, misaligned=(0, 1, 2, 5), name="threshold_feedback")


@pytest.mark.cuda
def test_threshold_feedback_grouped_mobilenet_round_in_two_launches_on_card(cuda_device):
    """MobileNet's 83 leaves at 64 clients, as a per-leaf topk round splits
    them: two launches (the table holds 77 leaves)."""
    shapes = _leaf_shapes()
    leaves = _threshold_leaves(np.random.default_rng(84), shapes)
    assert _grouped_on_card(cuda_device, leaves, name="threshold_feedback") == 2


@pytest.mark.cuda
def test_threshold_feedback_grouped_shufflenetv2_round_in_three_launches_on_card(cuda_device):
    """ShuffleNetV2's 170 leaves at 64 clients, as a per-leaf topk round
    splits them: three launches."""
    shapes = _leaf_shapes("shufflenetv2")
    assert len(shapes) == 170
    leaves = _threshold_leaves(np.random.default_rng(171), shapes)
    assert _grouped_on_card(cuda_device, leaves, name="threshold_feedback") == 3


@pytest.mark.cuda
def test_threshold_feedback_takes_70000_rows_on_card(cuda_device):
    """No row lies on a grid axis: 70,000 rows (past 65,535) in one launch."""
    leaves = _threshold_leaves(np.random.default_rng(70), [(70_000, 3)])
    assert _grouped_on_card(cuda_device, leaves, name="threshold_feedback") == 1


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


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("rows,h", HADAMARD_SHAPES)
def test_hadamard_rotate_kernel_bit_equal_on_card(cuda_device, rows, h, inverse):
    y, signs = _hadamard_inputs(np.random.default_rng(h + rows), rows, h)
    yd, sd = torch.from_numpy(y).to(cuda_device), torch.from_numpy(signs).to(cuda_device)
    before = kernels.hadamard_rotate.launches
    out = kernels.hadamard_rotate(yd, sd, inverse=inverse)
    torch.cuda.synchronize()
    assert kernels.hadamard_rotate.launches == before + 1
    ref = kernels.hadamard_rotate_plain(yd, sd, inverse)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_hadamard_rotate_shufflenetv2_row_bit_equal_on_card(cuda_device, inverse):
    """ShuffleNetV2's rotq row: 1,263,854 params and 16,180 statistics
    padded to 2^21, at 64 clients."""
    y, signs = _hadamard_inputs(np.random.default_rng(21), 64, 2**21)
    yd, sd = torch.from_numpy(y).to(cuda_device), torch.from_numpy(signs).to(cuda_device)
    out = kernels.hadamard_rotate(yd, sd, inverse=inverse)
    ref = kernels.hadamard_rotate_plain(yd, sd, inverse)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,h", [(64, 2**20), (65, 2**14)])
def test_hadamard_rotate_repeats_its_bits_on_card(cuda_device, rows, h):
    """Blocks take their tiles in a different order on every call, from
    counters that are fresh for every call: the bits must not change."""
    y, signs = _hadamard_inputs(np.random.default_rng(h), rows, h)
    yd, sd = torch.from_numpy(y).to(cuda_device), torch.from_numpy(signs).to(cuda_device)
    first = kernels.hadamard_rotate(yd, sd)
    second = kernels.hadamard_rotate(yd, sd)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))
    ref = kernels.hadamard_rotate_plain(yd, sd)
    assert torch.equal(first.view(torch.int32), ref.view(torch.int32))


@pytest.mark.cuda
def test_hadamard_rotate_takes_operands_off_16_byte_alignment_on_card(cuda_device):
    """The kernel moves 16-byte vectors: the wrapper copies operands that
    start off that alignment, and the result does not change."""
    rows, h = 3, 2**14
    y, signs = _hadamard_inputs(np.random.default_rng(11), rows, h)
    ybuf = torch.zeros(rows * h + 1, device=cuda_device)
    sbuf = torch.zeros(h + 1, device=cuda_device)
    ybuf[1:] = torch.from_numpy(y.ravel()).to(cuda_device)
    sbuf[1:] = torch.from_numpy(signs).to(cuda_device)
    yd, sd = ybuf[1:].view(rows, h), sbuf[1:]
    assert yd.data_ptr() % 16 and sd.data_ptr() % 16
    for inverse in (False, True):
        out = kernels.hadamard_rotate(yd, sd, inverse=inverse)
        ref = kernels.hadamard_rotate_plain(yd, sd, inverse)
        assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


@pytest.mark.cuda
def test_hadamard_rotate_on_two_streams_at_once_on_card(cuda_device):
    """Two calls in flight together on two streams, each with its own
    counters, both match the plain version."""
    rng = np.random.default_rng(7)
    inputs = []
    for rows, h in [(64, 2**20), (8, 2**22)]:
        y, signs = _hadamard_inputs(rng, rows, h)
        inputs.append((torch.from_numpy(y).to(cuda_device), torch.from_numpy(signs).to(cuda_device)))
    streams = [torch.cuda.Stream(cuda_device) for _ in inputs]
    torch.cuda.synchronize()
    outs = []
    for stream, (y, signs) in zip(streams, inputs):
        with torch.cuda.stream(stream):
            outs.append(kernels.hadamard_rotate(y, signs, inverse=len(outs) == 1))
    torch.cuda.synchronize()
    for out, (y, signs), inverse in zip(outs, inputs, (False, True)):
        ref = kernels.hadamard_rotate_plain(y, signs, inverse)
        assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


@pytest.mark.cuda
def test_hadamard_rotate_pair_is_identity_on_card(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    y = torch.randn((64, 2**20), generator=g, device=cuda_device)
    signs = torch.randint(0, 2, (2**20,), generator=g, device=cuda_device).float() * 2 - 1
    back = kernels.hadamard_rotate(kernels.hadamard_rotate(y, signs), signs, inverse=True)
    torch.testing.assert_close(back, y, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_hadamard_rotate_rejects_bad_operands_on_card(cuda_device):
    y = torch.zeros((2, 256), device=cuda_device)
    signs = torch.ones((256,), device=cuda_device)
    with pytest.raises(ValueError, match="power-of-two"):
        kernels.hadamard_rotate(torch.zeros((2, 384), device=cuda_device), torch.ones((384,), device=cuda_device))
    with pytest.raises(ValueError, match="h >= 128"):
        kernels.hadamard_rotate(y[:, :64].contiguous(), signs[:64].contiguous())
    with pytest.raises(ValueError, match="signs"):
        kernels.hadamard_rotate(y, signs[:128])
    with pytest.raises(TypeError):
        kernels.hadamard_rotate(y.double(), signs.double())
    with pytest.raises(ValueError, match="contiguous"):
        kernels.hadamard_rotate(torch.zeros((256, 2), device=cuda_device).t(), signs)


@pytest.mark.cuda
@pytest.mark.parametrize("compression,layout", [("none", "per_leaf"), ("topk", "per_leaf"), ("rotq", "flat")])
def test_small_mobilenet_round_on_card_matches_cpu(cuda_device, compression, layout):
    """One MobileNet round (2 clients, batch 4, 2 steps) on the card and on
    the CPU from the same init, the global model in f64 on both (in f32 the
    two devices' summation orders part past any tolerance within a round:
    BatchNorm over 4-example batches leaves the gradient ill-conditioned).
    rotq takes the same numpy draws on both devices; its params are held to
    atol=2e-4, as in ``chip_smoke.py``: a last-bit difference of the f32
    row can move a rotated coordinate across a stochastic-rounding step,
    which moves every coordinate of the row by step / 2048."""
    from fedtpu_torch import DataConfig, FedConfig, Federation, RoundConfig
    from fedtpu_torch.core.round import init_state
    from fedtpu_torch.ops import compression as comp

    cfg = RoundConfig(
        model="mobilenet",
        data=DataConfig(dataset="cifar10", batch_size=4, partition="iid", augment=False),
        fed=FedConfig(num_clients=2, compression=compression, delta_layout=layout),
        steps_per_round=2,
    )
    rng = np.random.default_rng(2)
    data = (rng.standard_normal((16, 32, 32, 3), dtype=np.float32),
            rng.integers(0, 10, size=16).astype(np.int32))
    codec = comp.make_compressor(cfg.fed)
    if compression == "rotq":
        inner = codec

        def apply_flat(y, state, lay, round_idx=0):
            r = np.random.default_rng(round_idx)
            signs = torch.from_numpy((r.integers(0, 2, size=lay.padded) * 2 - 1).astype(np.float32))
            unif = torch.from_numpy(r.random((2, lay.padded), dtype=np.float32))
            return inner.apply_flat(y, state, lay, round_idx=round_idx,
                                    signs=signs.to(y.device), uniforms=unif.to(y.device))

        codec = codec._replace(apply_flat=apply_flat)
    cpu = Federation(cfg, seed=0, data=data, device="cpu", compressor=codec)
    gpu = Federation(cfg, seed=0, data=data, device=cuda_device, compressor=codec)
    init = dict(params=cpu.state.params, batch_stats=cpu.state.batch_stats, dtype=torch.float64)
    cpu.state = init_state(cpu.model, cfg, codec, **init)
    gpu.state = init_state(gpu.model, cfg, codec, **init)
    cpu.step(cpu.device_batch(0, offset=1))
    gpu.step(gpu.device_batch(0, offset=1))
    bad = total = 0
    params_atol = 2e-4 if compression == "rotq" else 1e-5
    for part, atol in (("params", params_atol), ("batch_stats", 1e-5)):
        for k, w in getattr(cpu.state, part).items():
            g = getattr(gpu.state, part)[k].cpu()
            assert g.dtype == torch.float64 and torch.isfinite(g).all(), k
            bad += int(((g - w).abs() > atol + 1e-4 * w.abs()).sum())
            total += w.numel()
    assert bad <= 0.001 * total, f"{bad} of {total} coordinates differ"


# ------------------------------------------------------ round options


@pytest.mark.cuda
@pytest.mark.parametrize("method,q", [("lower", 0.1), ("higher", 0.9), ("midpoint", 0.5)])
def test_nanquantile_on_card_bit_equal_to_cpu(cuda_device, method, q):
    """The sort-based quantile at MobileNet's widest leaf's rows (64
    clients, two of them dead as NaN rows) is the CPU's, bit for bit."""
    from fedtpu_torch.ops.quantile import nanquantile

    x = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 1_048_576), dtype=np.float32))
    x[[3, 40]] = float("nan")
    got = nanquantile(x.to(cuda_device), q, method).cpu()
    assert torch.equal(got.view(torch.int32), nanquantile(x, q, method).view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("aggregator", ["median", "trimmed_mean", "krum"])
def test_robust_combines_on_card_match_cpu(cuda_device, aggregator):
    """Bit-equal to the CPU's: the sort and the band's sum in client order
    are exact the same way on both, and Krum's Gram matrix is f64 whatever
    the TF32 flags say."""
    from fedtpu_torch.core import round as tround

    rng = np.random.default_rng(1)
    x = {"a": torch.from_numpy(rng.standard_normal((64, 3000), dtype=np.float32)),
         "b": torch.from_numpy(rng.standard_normal((64, 7, 5), dtype=np.float32))}
    w = torch.ones(64)
    w[[5, 9]] = 0.0
    on = lambda t: {k: v.to(cuda_device) for k, v in t.items()}
    if aggregator == "krum":
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            (got,) = tround._krum_over_clients((on(x),), w.to(cuda_device), 0.1)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        (want,) = tround._krum_over_clients((x,), w, 0.1)
    else:
        got = tround._robust_over_clients(on(x), w.to(cuda_device), aggregator, 0.1)
        want = tround._robust_over_clients(x, w, aggregator, 0.1)
    for k in x:
        assert torch.equal(got[k].cpu(), want[k]), k


@pytest.mark.cuda
def test_screen_rows_on_card_match_cpu(cuda_device):
    from fedtpu_torch.ops.flat import screen_rows

    rng = np.random.default_rng(2)
    rows = rng.standard_normal((1, 200_000), dtype=np.float32) + 0.5 * rng.standard_normal((64, 200_000), dtype=np.float32)
    rows[:8] *= -8.0  # boosted sign-flippers
    rows = torch.from_numpy(rows)
    w = torch.ones(64)
    keep_c, stats_c = screen_rows(rows, w, zmax=6.0, cos_min=-0.5)
    keep_g, stats_g = screen_rows(rows.to(cuda_device), w.to(cuda_device), zmax=6.0, cos_min=-0.5)
    assert torch.equal(keep_g.cpu(), keep_c) and not keep_c[:8].any() and keep_c[8:].all()
    for k in stats_c:
        np.testing.assert_allclose(stats_g[k].cpu().numpy(), stats_c[k].numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_small_mobilenet_option_round_on_card_matches_cpu(cuda_device, remat):
    """One f64 MobileNet round (2 clients, batch 4) with FedProx and bf16
    momentum, with and without remat, on the card against the CPU: the
    reference tolerance (atol=1e-5, rtol=1e-4 on all but 0.1%)."""
    from fedtpu_torch import DataConfig, FedConfig, Federation, OptimizerConfig, RoundConfig
    from fedtpu_torch.core.round import init_state

    cfg = RoundConfig(
        model="mobilenet", remat=remat, steps_per_round=2,
        data=DataConfig(dataset="cifar10", batch_size=4, partition="iid", augment=False),
        fed=FedConfig(num_clients=2, algorithm="fedprox", fedprox_mu=0.01),
        opt=OptimizerConfig(momentum_dtype="bfloat16"),
    )
    rng = np.random.default_rng(3)
    data = (rng.standard_normal((16, 32, 32, 3), dtype=np.float32), rng.integers(0, 10, size=16).astype(np.int32))
    cpu = Federation(cfg, seed=0, data=data, device="cpu")
    gpu = Federation(cfg, seed=0, data=data, device=cuda_device)
    init = dict(params=cpu.state.params, batch_stats=cpu.state.batch_stats, dtype=torch.float64)
    cpu.state = init_state(cpu.model, cfg, None, **init)
    gpu.state = init_state(gpu.model, cfg, None, **init)
    cpu.step(cpu.device_batch(0, offset=1))
    gpu.step(gpu.device_batch(0, offset=1))
    bad = total = 0
    for part in ("params", "batch_stats"):
        for k, w in getattr(cpu.state, part).items():
            g = getattr(gpu.state, part)[k].cpu()
            assert torch.isfinite(g).all(), k
            bad += int(((g - w).abs() > 1e-5 + 1e-4 * w.abs()).sum())
            total += w.numel()
    assert bad <= 0.001 * total, f"{bad} of {total} coordinates differ"
    assert all(v.dtype == torch.bfloat16 for v in gpu.state.opt_state.values())
