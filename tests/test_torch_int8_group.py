"""The grouped int8 kernel's CPU side (``fedtpu_torch.ops.kernels``): its
plain path against fedtpu's Pallas ``quantdequant_int8``, the plan that
splits a round's leaves into launches and tiles, and the per-leaf int8
codec through one grouped call against fedtpu's ``make_int8``.

The kernel itself runs only on the card (``test_torch_cuda.py``); here the
wrapper takes its plain version, as it does for every tensor on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedtpu.ops import compression as jcomp
from fedtpu.ops import pallas_kernels as pk
from fedtpu_torch.convert import from_flax, to_flax
from fedtpu_torch.ops import compression as tcomp
from fedtpu_torch.ops import kernels

TILE = kernels.INT8_TILE
CAP = kernels.INT8_GROUP_CAPACITY

# (rows, cols): every width a vector path has to cut (1, 3, 10: under one
# vector or not a multiple of 4; 257, 4097, 65,537: one element past a
# block's, a tile's and 16 tiles' worth), 1-5 rows.
RAGGED = [(1, 1), (2, 3), (3, 10), (4, 257), (5, 4097), (3, 65537)]


def _leaf(rng, rows, cols):
    """Normal values with a -0.0 and a NaN; row 1 (where there is one)
    quotients exactly at k + 0.5, row 2 all zero (scale 0), the last row
    (where there are four or more) scaled so that its quotients clip at
    +-127."""
    x = rng.normal(size=(rows, cols)).astype(np.float32)
    scale = (np.abs(x).max(axis=1) / np.float32(127.0)).astype(np.float32)
    if rows > 1:
        x[1] = ((rng.integers(-130, 130, size=cols) + 0.5) * 0.25).astype(np.float32)
        scale[1] = 0.25
    if rows > 2:
        x[2] = 0.0
        scale[2] = 0.0
    if rows > 3:
        scale[-1] = np.float32(np.abs(x[-1]).max() / 300.0)
    x[0, 0] = -0.0
    if cols > 2:
        x[0, 2] = np.nan
    return x, scale


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.int32)


def test_grouped_plain_path_bit_equal_to_pallas_leaf_by_leaf():
    rng = np.random.default_rng(0)
    leaves = [_leaf(rng, rows, cols) for rows, cols in RAGGED]
    assert any((np.abs(x / np.where(s > 0, s, 1)[:, None]) > 127).any() for x, s in leaves)
    kernels.reset_launch_counts()
    outs = kernels.quantdequant_int8_grouped(
        [torch.from_numpy(x) for x, _ in leaves], [torch.from_numpy(s) for _, s in leaves]
    )
    assert kernels.quantdequant_int8.launches == 0  # the CPU takes the plain path
    for (x, s), out in zip(leaves, outs):
        want = pk.quantdequant_int8(jnp.asarray(x), jnp.asarray(s), interpret=True)
        np.testing.assert_array_equal(_bits(out.numpy()), _bits(want), err_msg=str(x.shape))


def test_grouped_takes_empty_lists_and_leaves_and_checks_lengths():
    assert kernels.quantdequant_int8_grouped([], []) == []
    outs = kernels.quantdequant_int8_grouped([torch.zeros((3, 0))], [torch.zeros(3)])
    assert outs[0].shape == (3, 0)
    with pytest.raises(ValueError, match="2 leaves and 1 scales"):
        kernels.quantdequant_int8_grouped([torch.zeros((1, 1))] * 2, [torch.zeros(1)])
    with pytest.raises(ValueError, match="CUDA"):
        kernels.quantdequant_int8_grouped(
            [torch.empty((2, 8), device="meta")], [torch.empty((2,), device="meta")]
        )


def _covered(launch):
    """Every element index each leaf of a launch gets, in the kernel's
    order: tile 0's head, then each tile's whole vectors and tail."""
    seen = {}
    for leaf in launch:
        idx = list(range(leaf.head))
        tails = 0
        for t in range(leaf.tiles):
            start, stop = leaf.tile_span(t)
            whole = (stop - start) // 4 * 4
            idx += range(start, stop)
            tails += (stop - start) - whole
        seen[leaf.index] = (idx, tails)
    return seen


@pytest.mark.parametrize("offset", [0, 4, 8, 12])
def test_plan_covers_every_element_once(offset):
    sizes = [1, 2, 3, 4, 5, 10, 257, TILE - 1, TILE, TILE + 1, 3 * TILE + 7, 65537 * 3]
    plan = kernels._int8_group_plan(sizes, [offset] * len(sizes))
    assert len(plan) == 1
    covered = _covered(plan[0])
    for leaf in plan[0]:
        idx, tails = covered[leaf.index]
        assert sorted(idx) == list(range(sizes[leaf.index])), leaf
        assert len(idx) == len(set(idx))
        assert tails == leaf.tail  # only the last vector of the body is cut
        assert leaf.tiles == max(1, -(-(leaf.numel - leaf.head) // TILE))
        # After the head, x (and out) sit on a 16-byte boundary.
        assert leaf.head == leaf.numel or (offset + 4 * leaf.head) % 16 == 0


def test_plan_heads_and_tails():
    sizes = [0, 10, 1, 2, 4100, 8, 0, 5]
    offsets = [0, 0, 4, 4, 4, 8, 12, 12]
    plan = kernels._int8_group_plan(sizes, offsets)
    (launch,) = plan
    assert [leaf.index for leaf in launch] == [1, 2, 3, 4, 5, 7]  # empty leaves skipped
    got = {leaf.index: (leaf.head, leaf.tail, leaf.tiles) for leaf in launch}
    assert got == {
        1: (0, 2, 1),  # aligned, 10 = 2 vectors + 2
        2: (1, 0, 1),  # 3 floats to the boundary, but only one element
        3: (2, 0, 1),
        4: (3, 1, 2),  # 4100 = 3 + 1024 vectors + 1: two tiles
        5: (2, 2, 1),  # 8 bytes off: 2 + 1 vector + 2
        7: (1, 0, 1),  # 12 bytes off: 1 + 1 vector
    }


@pytest.mark.parametrize("count,launches", [(8, 1), (83, 1), (CAP, 1), (CAP + 1, 2), (200, -(-200 // CAP))])
def test_plan_splits_long_lists_by_table_capacity(count, launches):
    plan = kernels._int8_group_plan([7] * count)
    assert len(plan) == launches
    assert all(0 < len(launch) <= CAP for launch in plan)
    assert [leaf.index for launch in plan for leaf in launch] == list(range(count))


def test_capacity_fits_the_kernels_table():
    """The table must fit 4 KB of kernel parameters: three pointers and two
    int64 a leaf, an int32 first tile and an int8 head, and a count."""
    src = (kernels.CSRC_DIR / "quantdequant_int8.cu").read_text()
    assert f"constexpr int kMaxLeaves = {CAP};" in src
    assert 40 * CAP + 4 * (CAP + 1) + 4 + CAP <= 4096
    assert "kThreads * kVecs * 4;   // 4096 elements" in src and TILE == 4096


@pytest.mark.parametrize("skip", [0, 1, 2, 3])
def test_out_starts_at_the_offset_of_x(skip):
    buf = torch.zeros(64 + 3)
    x = buf[skip : skip + 64].view(4, 16)
    out = kernels._empty_at_offset_of(x)
    assert out.shape == x.shape and out.is_contiguous()
    assert out.data_ptr() % 16 == x.data_ptr() % 16


SHAPES = {
    "Conv_0": {"kernel": (3, 3, 3, 5), "bias": (5,)},
    "Dense_0": {"kernel": (7, 10), "bias": (10,)},
}


@pytest.mark.parametrize("ef", [True, False], ids=["feedback", "no_feedback"])
def test_per_leaf_int8_codec_one_grouped_call_bit_equal_to_fedtpu(ef):
    rng = np.random.default_rng(5)
    clients = 3
    deltas = {m: {k: (0.01 * rng.normal(size=(clients,) + s)).astype(np.float32) for k, s in leaves.items()}
              for m, leaves in SHAPES.items()}
    residual = {m: {k: (0.003 * rng.normal(size=(clients,) + s)).astype(np.float32) for k, s in leaves.items()}
                for m, leaves in SHAPES.items()}
    calls = []

    def spy(ys, scales):
        calls.append(len(ys))
        return kernels.quantdequant_int8_grouped(ys, scales)

    jc = jcomp.make_int8(error_feedback=ef)
    tc = tcomp.make_int8(error_feedback=ef, quantdequant=spy)
    j_out, j_new = jc.apply(jax.tree.map(jnp.asarray, deltas), jax.tree.map(jnp.asarray, residual) if ef else ())
    t_out, t_new = tc.apply(from_flax(deltas), from_flax(residual) if ef else ())
    assert calls == [4]  # one grouped call for the tree's four leaves
    pairs = [(t_out, j_out)] + ([(t_new, j_new)] if ef else [])
    for t_tree, j_tree in pairs:
        got = to_flax(t_tree)
        for m, leaves in SHAPES.items():
            for k in leaves:
                np.testing.assert_array_equal(_bits(got[m][k]), _bits(j_tree[m][k]), err_msg=f"{m}/{k}")
    if not ef:
        assert t_new == () and j_new == ()
