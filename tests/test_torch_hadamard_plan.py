"""The plan of K3 (``kernels._hadamard_plan``) run on the CPU.

The CUDA kernel takes its phases, tiles, index maps and lag from this plan.
Here each phase's tiles are gathered by the plan's index map, their stages
run with the plain butterfly and scattered back, in torch: the result must
be bit-equal to ``fwht_plain`` (itself bit-equal to fedtpu's rotation in
``test_torch_flat.py``). The plan must run every stage once, in ascending
order, fit the kernel's tile, and keep its lag within its byte budget; the
kernel's ticket order must put every item after the items it waits on.
"""

import numpy as np
import pytest
import torch

from fedtpu_torch.ops import kernels
from test_torch_cuda import _hadamard_inputs

TILE = 1 << kernels.HADAMARD_TILE_LOG


def _tile_offsets(plan, phase):
    """``[tiles, 2^13]`` unit offsets of every tile's local indices."""
    _, _, c, seg = plan.phases[phase]
    local = torch.arange(TILE, dtype=torch.int64)
    within = ((local >> c) << seg) + (local & ((1 << c) - 1))
    bases = torch.tensor(
        [plan.tile_base(phase, i) for i in range(plan.tiles[phase])], dtype=torch.int64
    )
    return bases[:, None] + within[None, :]


def _butterfly_bit(x, b):
    """One stage of the plain butterfly over bit ``b`` of the last axis."""
    shape = x.shape
    x = x.reshape(*shape[:-1], shape[-1] >> (b + 1), 2, 1 << b)
    a, c = x[..., 0, :], x[..., 1, :]
    return torch.stack([a + c, a - c], dim=-2).reshape(shape)


def _run_plan(x):
    """fwht of ``x [rows, h]`` as the kernel's plan splits it."""
    rows, h = x.shape
    plan = kernels._hadamard_plan(h, rows)
    units = x.reshape(plan.units, plan.unit_len).clone()
    for p, (_, k, c, _) in enumerate(plan.phases):
        offs = _tile_offsets(plan, p)
        valid = offs < plan.unit_len
        tiles = torch.where(valid, units[:, offs.clamp(max=plan.unit_len - 1)], 0.0)
        for b in range(c, c + k):
            tiles = _butterfly_bit(tiles, b)
        units[:, offs[valid]] = tiles[:, valid]
    return units.reshape(rows, h)


@pytest.mark.parametrize(
    "rows,h", [(3, 2**m) for m in range(7, 17)] + [(1, 2**20), (1, 2**22)]
)
def test_plan_is_bit_equal_to_plain_butterfly(rows, h):
    y, _ = _hadamard_inputs(np.random.default_rng(h + rows), rows, h)
    x = torch.from_numpy(y)
    got = _run_plan(x)
    want = kernels.fwht_plain(x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("m", range(7, 24))
def test_plan_covers_every_stage_once_in_order_and_fits_the_tile(m):
    h = 2**m
    plan = kernels._hadamard_plan(h, 64)
    stages = [s for lo, k, _, _ in plan.phases for s in range(lo, lo + k)]
    assert stages == list(range(m))
    for p, (lo, k, c, seg) in enumerate(plan.phases):
        assert 1 <= k and c + k <= kernels.HADAMARD_TILE_LOG
        # A tile's stage s is local bit c + s - lo: 2^(s - lo) segments of
        # 2^seg elements, so seg = lo (or a contiguous tile from stage 0).
        assert (c, seg) == (0, 0) if p == 0 else seg == lo
        # 16-byte loads: four neighbouring local indices are neighbours in memory.
        assert c >= 2 or c == seg
        offs = _tile_offsets(plan, p).flatten()
        if len(plan.phases) > 1:  # the tiles partition the row
            assert torch.equal(offs.sort().values, torch.arange(plan.unit_len))
        else:
            assert torch.equal(offs[offs < plan.unit_len], torch.arange(plan.unit_len))
    if m <= kernels.HADAMARD_TILE_LOG:
        assert len(plan.phases) == 1 and plan.units == 1 and plan.unit_len == 64 * h
    else:
        assert plan.units == 64 and plan.lag >= 1
        # The rows between two phases stay within the budget, unless one row
        # alone is larger (then the lag is one row).
        assert plan.lag_bytes <= max(kernels.HADAMARD_LAG_BYTES, 4 * h)


def _tickets(plan):
    """The kernel's ticket order: (unit, phase, tile) per ticket, None for the
    tickets of a step that fall outside the units (hadamard_rotate.cu)."""
    first = np.concatenate([[0], np.cumsum(plan.tiles)[:-1]])
    per_step = sum(plan.tiles)
    steps = plan.units + plan.lag * (len(plan.phases) - 1)
    for tk in range(steps * per_step):
        step, within = divmod(tk, per_step)
        p = max(k for k in range(len(plan.phases)) if within >= first[k])
        u = step - p * plan.lag
        yield (u, p, within - first[p]) if 0 <= u < plan.units else None


@pytest.mark.parametrize("rows,h", [(1, 2**14), (3, 2**20), (65, 2**14), (2, 2**22), (2, 2**23)])
def test_ticket_order_puts_every_wait_behind_its_items(rows, h):
    plan = kernels._hadamard_plan(h, rows)
    released = {}
    seen = set()
    for item in _tickets(plan):
        if item is None:
            continue
        u, p, tile = item
        assert item not in seen
        seen.add(item)
        if p > 0:  # everything it waits on has a lower ticket
            assert released.get((u, p - 1), 0) == plan.tiles[p - 1]
        released[(u, p)] = released.get((u, p), 0) + 1
    assert len(seen) == plan.units * sum(plan.tiles)


def test_plan_array_is_what_the_kernel_reads():
    plan = kernels._hadamard_plan(2**20, 64)
    assert plan.lag == kernels.HADAMARD_LAG_BYTES // 2**22
    arr = plan.as_array()
    assert arr.dtype == np.int64
    assert arr.tolist() == [13, 2, plan.lag, 64, 2**20, 0, 13, 0, 0, 128, 13, 7, 6, 13, 128]
    # chip_smoke.py's no-reuse yardstick: the same plan with every row's
    # phase 0 ahead of any phase 1.
    assert plan._replace(lag=64).as_array()[2] == 64
