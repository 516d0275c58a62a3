"""The grouped top-k threshold kernel's CPU side (``fedtpu_torch.ops.kernels``):
its plain path against fedtpu's Pallas ``threshold_with_feedback``, the plan
that splits a round's leaves into launches and tiles at K1's table capacity,
and the per-leaf topk codec through one grouped call against fedtpu's
``make_topk``.

The kernel itself runs only on the card (``test_torch_cuda.py``); here the
wrapper takes its plain version, as it does for every tensor on the CPU.
"""

import functools
import re

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

TILE = kernels.GROUP_TILE
CAP = kernels.THRESHOLD_GROUP_CAPACITY

# (rows, cols): widths under one vector, not a multiple of 4, one past a
# block's and a tile's worth, and 65,537 columns; 1-5 rows.
MIXED = [(1, 1), (2, 3), (3, 10), (4, 257), (5, 4097), (3, 65537)]


def _leaf(rng, rows, cols):
    """Normal values with a -0.0 and a NaN; row 0's threshold tied with one
    of its values, odd rows' 0.5, row 2's 0 (every value kept)."""
    y = rng.normal(size=(rows, cols)).astype(np.float32)
    y[0, 0] = -0.0
    if cols > 2:
        y[0, 2] = np.nan
    t = np.abs(y[:, min(1, cols - 1)]).astype(np.float32)
    t[1::2] = np.float32(0.5)
    if rows > 2:
        t[2] = 0.0
    return y, t


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.int32)


def test_grouped_plain_path_bit_equal_to_pallas_leaf_by_leaf():
    rng = np.random.default_rng(0)
    leaves = [_leaf(rng, rows, cols) for rows, cols in MIXED]
    kernels.reset_launch_counts()
    outs, new_es = kernels.threshold_feedback_grouped(
        [torch.from_numpy(y) for y, _ in leaves], [torch.from_numpy(t) for _, t in leaves]
    )
    assert kernels.threshold_feedback.launches == 0  # the CPU takes the plain path
    for (y, t), out, new_e in zip(leaves, outs, new_es):
        want_out, want_e = pk.threshold_with_feedback(jnp.asarray(y), jnp.asarray(t), interpret=True)
        np.testing.assert_array_equal(_bits(out.numpy()), _bits(want_out), err_msg=str(y.shape))
        np.testing.assert_array_equal(_bits(new_e.numpy()), _bits(want_e), err_msg=str(y.shape))


def test_grouped_takes_empty_lists_and_leaves_and_checks_lengths():
    assert kernels.threshold_feedback_grouped([], []) == ([], [])
    outs, new_es = kernels.threshold_feedback_grouped([torch.zeros((3, 0))], [torch.zeros(3)])
    assert outs[0].shape == new_es[0].shape == (3, 0)
    with pytest.raises(ValueError, match="2 leaves and 1 thresholds"):
        kernels.threshold_feedback_grouped([torch.zeros((1, 1))] * 2, [torch.zeros(1)])
    with pytest.raises(ValueError, match="CUDA"):
        kernels.threshold_feedback_grouped(
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
            idx += range(start, stop)
            tails += (stop - start) % 4
        seen[leaf.index] = (idx, tails)
    return seen


@pytest.mark.parametrize("offset", [0, 4, 8, 12])
def test_plan_covers_every_element_once(offset):
    sizes = [1, 2, 3, 4, 5, 10, 257, TILE - 1, TILE, TILE + 1, 3 * TILE + 7, 70_000 * 3]
    plan = kernels._group_plan(sizes, [offset] * len(sizes), CAP)
    assert len(plan) == 1
    covered = _covered(plan[0])
    for leaf in plan[0]:
        idx, tails = covered[leaf.index]
        assert sorted(idx) == list(range(sizes[leaf.index])), leaf
        assert len(idx) == len(set(idx))
        assert tails == leaf.tail  # only the last vector of the body is cut
        assert leaf.tiles == max(1, -(-(leaf.numel - leaf.head) // TILE))
        # After the head, y (and out, new_e) sit on a 16-byte boundary.
        assert leaf.head == leaf.numel or (offset + 4 * leaf.head) % 16 == 0


def test_plan_heads_and_tails():
    sizes = [0, 10, 1, 2, 4100, 8, 0, 5]
    offsets = [0, 0, 4, 4, 4, 8, 12, 12]
    (launch,) = kernels._group_plan(sizes, offsets, CAP)
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


# The rounds' leaf counts (smallcnn, ResNet-18, MobileNet, densenet_cifar)
# and the table's edges.
@pytest.mark.parametrize("count,launches", [(8, 1), (62, 1), (CAP, 1), (CAP + 1, 2), (83, 2), (200, 3), (362, 5)])
def test_plan_splits_long_lists_by_table_capacity(count, launches):
    plan = kernels._group_plan([7] * count, None, CAP)
    assert len(plan) == launches
    assert all(0 < len(launch) <= CAP for launch in plan)
    assert [leaf.index for launch in plan for leaf in launch] == list(range(count))


def test_int8_plan_is_the_group_plan_at_its_capacity():
    sizes = [3, 0, 4100, 9] * 50
    offsets = [4, 0, 8, 12] * 50
    assert kernels._int8_group_plan(sizes, offsets) == kernels._group_plan(
        sizes, offsets, kernels.INT8_GROUP_CAPACITY)


def test_capacity_fits_the_kernels_table():
    """The table must fit 4 KB of kernel parameters: four pointers and two
    int64 a leaf (48 bytes), an int32 first tile and an int8 head (5), and
    a closing first tile and a count (8)."""
    src = (kernels.CSRC_DIR / "threshold_feedback.cu").read_text()
    (cap,) = re.findall(r"constexpr int kMaxLeaves = (\d+);", src)
    assert int(cap) == CAP
    assert 53 * CAP + 8 <= 4096 < 53 * (CAP + 1) + 8
    assert "kThreads * kVecs * 4;   // 4096 elements" in src and TILE == 4096


SHAPES = {
    "Conv_0": {"kernel": (3, 3, 3, 5), "bias": (5,)},
    "Dense_0": {"kernel": (7, 10), "bias": (10,)},
    "Dense_1": {"kernel": (10, 1), "bias": (1,)},  # the bias: a keep-all leaf
}


@pytest.fixture(params=["plain_jnp", "interpret"])
def pallas_mode(request, monkeypatch):
    """fedtpu's kernel through its default branch, or forced through the
    interpreted pallas_call for the length of one test."""
    if request.param == "interpret":
        monkeypatch.setattr(
            pk, "threshold_with_feedback", functools.partial(pk.threshold_with_feedback, interpret=True)
        )
    return request.param


@pytest.mark.parametrize("ef", [True, False], ids=["feedback", "no_feedback"])
def test_per_leaf_topk_codec_one_grouped_call_bit_equal_to_fedtpu(ef, pallas_mode):
    rng = np.random.default_rng(5)
    clients = 3
    deltas = {m: {k: (0.01 * rng.normal(size=(clients,) + s)).astype(np.float32) for k, s in leaves.items()}
              for m, leaves in SHAPES.items()}
    residual = {m: {k: (0.003 * rng.normal(size=(clients,) + s)).astype(np.float32) for k, s in leaves.items()}
                for m, leaves in SHAPES.items()}
    calls = []

    def spy(ys, ts):
        calls.append(sorted(y.shape[1] for y in ys))
        return kernels.threshold_feedback_grouped(ys, ts)

    jc = jcomp.make_topk(0.2, error_feedback=ef)
    tc = tcomp.make_topk(0.2, error_feedback=ef, threshold=spy)
    j_out, j_new = jc.apply(jax.tree.map(jnp.asarray, deltas), jax.tree.map(jnp.asarray, residual) if ef else ())
    t_out, t_new = tc.apply(from_flax(deltas), from_flax(residual) if ef else ())
    # With feedback, one grouped call for every leaf but the keep-all one;
    # without, no call (a plain masked select, as fedtpu's).
    assert calls == ([[5, 10, 10, 70, 135]] if ef else [])
    assert list(t_out) == list(from_flax(deltas))
    pairs = [(t_out, j_out)] + ([(t_new, j_new)] if ef else [])
    for t_tree, j_tree in pairs:
        got = to_flax(t_tree)
        for m, leaves in SHAPES.items():
            for k in leaves:
                np.testing.assert_array_equal(_bits(got[m][k]), _bits(j_tree[m][k]), err_msg=f"{m}/{k}")
    if not ef:
        assert t_new == () and j_new == ()
