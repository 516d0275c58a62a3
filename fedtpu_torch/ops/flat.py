"""Flat delta layout: every parameter leaf in one contiguous row.

The port of ``fedtpu.ops.flat`` for what the round, the flat codecs and
update screening (:func:`screen_rows`) need. A client's update becomes one ``[P]`` row and the clients one
``[clients, P]`` f32 buffer, so a codec, its error feedback and the
weighted mean each run as one op over the whole model.

The row is fedtpu's row coordinate for coordinate, which the rotation of
the ``rotq`` codec (it mixes every coordinate of the row) and fedtpu's wire
records both depend on:

- leaves in flax's ``tree_flatten`` order: the path of module names, then
  the flax leaf name, sorted, so ``Conv_0/bias`` comes before
  ``Conv_0/kernel``;
- each weight in flax's layout (Conv kernels HWIO, Dense kernels
  ``[in, out]``), permuted from torch's by :mod:`fedtpu_torch.convert`'s
  tables;
- the row zero-padded to a multiple of ``LANE`` (128), or with
  ``pow2=True`` to the next power of two (the Hadamard rotation's width).

The pad region is zero on entry to every op here and every op keeps it so.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fedtpu_torch.convert import _TO_FLAX, _WEIGHT_TO_FLAX
from fedtpu_torch.ops.quantile import nanquantile

Tree = Dict[str, torch.Tensor]

LANE = 128


class FlatLayout(NamedTuple):
    """Where each leaf of a torch-named params dict lies in the flat row.

    Per leaf, in row order: its torch name and shape, its dtype, and the
    axis permutation that takes the stacked ``[clients, ...]`` torch leaf to
    flax's layout (``None`` for a leaf that is not permuted)."""

    names: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    perms: Tuple[Optional[Tuple[int, ...]], ...]
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]
    total: int  # real coordinates (sum of sizes)
    padded: int  # row length P >= total

    @property
    def num_leaves(self) -> int:
        return len(self.sizes)

    @property
    def pad(self) -> int:
        return self.padded - self.total


def next_pow2(n: int) -> int:
    """Smallest power of two >= max(n, 1)."""
    return 1 << max(n - 1, 0).bit_length()


def _flax_path(name: str) -> Tuple[str, ...]:
    *mods, leaf = name.split(".")
    return tuple(mods) + (_TO_FLAX[leaf],)


def flax_order(names) -> Tuple[str, ...]:
    """Torch leaf names in flax's ``tree_flatten`` order."""
    return tuple(sorted(names, key=_flax_path))


def make_layout(params: Tree, pow2: bool = False) -> FlatLayout:
    """Layout of a single (unstacked) torch-named params dict; only shapes
    and dtypes are read."""
    names = flax_order(params)
    shapes = tuple(tuple(params[k].shape) for k in names)
    sizes = tuple(math.prod(s) for s in shapes)
    total = sum(sizes)
    padded = max(LANE, math.ceil(max(total, 1) / LANE) * LANE)
    return FlatLayout(
        names=names,
        shapes=shapes,
        dtypes=tuple(params[k].dtype for k in names),
        perms=tuple(
            _WEIGHT_TO_FLAX[len(s) + 1] if k.endswith(".weight") else None
            for k, s in zip(names, shapes)
        ),
        offsets=tuple(int(o) for o in np.cumsum((0,) + sizes)[:-1]),
        sizes=sizes,
        total=total,
        padded=next_pow2(padded) if pow2 else padded,
    )


def pack_stacked(layout: FlatLayout, stacked: Tree) -> torch.Tensor:
    """``[clients, ...]`` dict -> ``[clients, padded]`` f32 buffer: each
    leaf copied once, already permuted to flax's layout, into its slice."""
    if len(stacked) != layout.num_leaves:
        raise ValueError(
            f"tree has {len(stacked)} leaves, layout expects {layout.num_leaves}"
        )
    first = stacked[layout.names[0]]
    n = first.shape[0]
    flat = torch.empty((n, layout.padded), dtype=torch.float32, device=first.device)
    for name, off, size, perm in zip(
        layout.names, layout.offsets, layout.sizes, layout.perms
    ):
        leaf = stacked[name]
        if perm is not None:
            leaf = leaf.permute(perm)
        flat[:, off : off + size].view((n,) + tuple(leaf.shape[1:])).copy_(leaf)
    flat[:, layout.total :].zero_()
    return flat


def _unpermute(perm: Tuple[int, ...]) -> Tuple[int, ...]:
    return tuple(int(i) for i in np.argsort(perm))


def unpack_stacked(layout: FlatLayout, flat: torch.Tensor) -> Tree:
    """Inverse of :func:`pack_stacked`: ``[clients, padded]`` -> stacked dict
    in torch's layout and the leaves' own dtypes (padding dropped)."""
    n = flat.shape[0]
    out = {}
    for name, shape, dt, perm, off, size in zip(
        layout.names, layout.shapes, layout.dtypes, layout.perms,
        layout.offsets, layout.sizes,
    ):
        leaf = flat[:, off : off + size]
        if perm is not None:
            flax_shape = tuple(((n,) + shape)[i] for i in perm)
            leaf = leaf.reshape(flax_shape).permute(_unpermute(perm))
        out[name] = leaf.reshape((n,) + shape).to(dt).contiguous()
    return out


def unpack(layout: FlatLayout, flat: torch.Tensor) -> Tree:
    """``[padded]`` row -> dict in torch's layout (padding dropped)."""
    return {k: v[0] for k, v in unpack_stacked(layout, flat[None]).items()}


def make_tree_layout(tree: Dict[str, Tree]) -> FlatLayout:
    """Layout of a ``{"params": {...}, "batch_stats": {...}}`` tree of
    torch-named leaves, the row of fedtpu's gRPC edge (its
    ``make_layout({"params": ..., "batch_stats": ...})``): a leaf is named
    ``"<collection>.<torch name>"``, so ``batch_stats`` leaves come first
    in flax's order."""
    return make_layout(
        {f"{col}.{name}": leaf for col, leaves in tree.items() for name, leaf in leaves.items()}
    )


def pack_tree(layout: FlatLayout, tree: Dict[str, Tree]) -> torch.Tensor:
    """One ``{"params", "batch_stats"}`` tree -> its ``[padded]`` f32 row in
    flax's order and layout (:func:`make_tree_layout`)."""
    stacked = {f"{col}.{name}": leaf[None] for col, leaves in tree.items() for name, leaf in leaves.items()}
    return pack_stacked(layout, stacked)[0]


def flax_tree(layout: FlatLayout, row: np.ndarray) -> dict:
    """A host row in the edge's order (:func:`make_tree_layout`) as the
    nested flax tree ``{"params": ..., "batch_stats": ...}`` of views into
    it, in flax's layout, both collections present."""
    out = {"params": {}, "batch_stats": {}}
    for name, shape, perm, off, size in zip(
        layout.names, layout.shapes, layout.perms, layout.offsets, layout.sizes
    ):
        col, *mods, leaf = name.split(".")
        if perm is not None:
            shape = tuple(((1,) + shape)[i] for i in perm)[1:]
        node = out[col]
        for mod in mods:
            node = node.setdefault(mod, {})
        node[_TO_FLAX[leaf]] = row[off : off + size].reshape(shape)
    return out


def to_flax_host(layout: FlatLayout, tree: Dict[str, Tree]) -> dict:
    """A ``{"params", "batch_stats"}`` tree of tensors as fedtpu's flax tree
    of f32 numpy arrays: packed in flax's layout on its device, copied to
    the host once."""
    return flax_tree(layout, pack_tree(layout, tree)[: layout.total].cpu().numpy())


def unpack_tree(
    layout: FlatLayout, row: torch.Tensor, collections=("params", "batch_stats")
) -> Dict[str, Tree]:
    """Inverse of :func:`pack_tree`: ``{collection: {torch name: leaf}}``
    in torch's layout, every one of ``collections`` present."""
    out: Dict[str, Tree] = {col: {} for col in collections}
    for name, leaf in unpack(layout, row).items():
        col, rest = name.split(".", 1)
        out.setdefault(col, {})[rest] = leaf
    return out


def segment_ids(layout: FlatLayout) -> np.ndarray:
    """``[padded]`` int64 map coordinate -> leaf index (row order); padding
    gets the extra segment ``num_leaves``."""
    ids = np.full((layout.padded,), layout.num_leaves, np.int64)
    for i, (off, size) in enumerate(zip(layout.offsets, layout.sizes)):
        ids[off : off + size] = i
    return ids


def topk_threshold(
    y: torch.Tensor, fraction: float, total: int
) -> Optional[torch.Tensor]:
    """Each row's keep threshold: the k-th largest ``|y|`` over the whole
    row, ``k = ceil(fraction * total)`` counted against the real (unpadded)
    coordinates; ``None`` when k covers them all. A library top-k, as
    fedtpu's ``lax.top_k`` sits outside its kernels."""
    k = max(1, int(math.ceil(fraction * total)))
    if k >= total:
        return None
    return torch.topk(y.abs(), k, dim=1).values[:, -1].contiguous()


def int8_scales(y: torch.Tensor, layout: FlatLayout) -> torch.Tensor:
    """``[clients, padded]`` per-coordinate int8 scale: each client's
    ``max|leaf| / 127`` of the leaf the coordinate belongs to, the per-leaf
    codec's scale exactly (a max does not depend on order). Built on the
    row's device by expanding each leaf's max over its slice: a gather by
    :func:`segment_ids` would copy the host array to the card every round,
    and that copy waits for the card."""
    a = y.abs()
    bounds = list(zip(layout.offsets, layout.sizes))
    if layout.pad:
        bounds.append((layout.total, layout.pad))
    maxes = [
        a[:, off : off + size].amax(dim=1, keepdim=True).expand(-1, size)
        for off, size in bounds
    ]
    return torch.cat(maxes, dim=1) / 127.0


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    return nanquantile(x, 0.5, "midpoint")


def screen_rows(
    rows: torch.Tensor,
    alive: torch.Tensor,
    norm_max: float = 0.0,
    zmax: float = 0.0,
    cos_min: float = -1.0,
):
    """fedtpu's update screening over a ``[clients, P]`` delta buffer:
    ``(keep [clients] bool, {"norm", "cos", "z"} f32 [clients])``.

    - ``norm``: each row's L2 norm, rejected above ``norm_max``;
    - ``cos``: the row's cosine against the sum of the other live rows'
      unit vectors (leave one out), rejected below ``cos_min``;
    - ``z``: ``0.6745 * (norm - median) / MAD`` over the live rows' norms,
      the MAD floored at 5% of the median, rejected above ``zmax``.

    A disarmed threshold (0, or -1 for ``cos_min``) rejects nothing, and
    with fewer than 3 live rows only ``norm_max`` applies. ``alive``
    (weights, > 0 is live) picks the rows the references are taken over;
    every row gets a verdict. The medians are ``jnp.nanmedian``'s (the mean
    of the two middle values). The dot product of the rows with the
    reference direction is an elementwise product and a sum in f32, never
    a matmul that TF32 could round."""
    rows = rows.float()
    live = alive.float() > 0
    live_f = live.float()
    norms = torch.sqrt(torch.clamp(torch.sum(rows * rows, dim=1), min=0.0))
    eps = 1e-12
    unit = rows / (norms + eps)[:, None]
    ref = torch.sum(unit * live_f[:, None], dim=0)
    del unit
    ref_sq = torch.clamp(torch.sum(ref * ref), min=0.0)
    d = torch.sum(rows * ref, dim=1)
    u = d / (norms + eps)
    loo_dot = d - live_f * norms
    loo_sq = torch.clamp(ref_sq - live_f * (2.0 * u - 1.0), min=0.0)
    cos = loo_dot / (norms * torch.sqrt(loo_sq) + eps)
    nan = torch.full_like(norms, float("nan"))
    norm_med = torch.nan_to_num(_nanmedian(torch.where(live, norms, nan)), nan=0.0)
    mad = torch.nan_to_num(
        _nanmedian(torch.where(live, torch.abs(norms - norm_med), nan)), nan=0.0
    )
    mad = torch.maximum(mad, 0.05 * norm_med)
    z = 0.6745 * (norms - norm_med) / (mad + eps)
    keep = torch.ones_like(live)
    if norm_max > 0:
        keep = keep & (norms <= norm_max)
    if zmax > 0:
        keep = keep & (z <= zmax)
    if cos_min > -1.0:
        keep = keep & (cos >= cos_min)
    few = norms <= norm_max if norm_max > 0 else torch.ones_like(keep)
    keep = torch.where(live.sum() >= 3, keep, few)
    return keep, {"norm": norms, "cos": cos, "z": z}


# ------------------------------------------------ fedtpu's sums over clients


def row_sum(rows: torch.Tensor) -> torch.Tensor:
    """``rows`` summed over the leading axis one row at a time in row order:
    the order of fedtpu's compiled axis-0 reduce on the CPU (up to 32 rows;
    XLA splits a longer reduce)."""
    acc = rows[0].clone()
    for r in rows[1:]:
        acc += r
    return acc


def fma_row_sum(rows: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``sum_i rows[i] * weights[i]`` in f32, one row at a time in row
    order, each product added with a single rounding: the fused
    multiply-add that fedtpu's compiled ``sum(rows * w, axis=0)`` makes on
    the CPU. Taken through f64, where the product of two f32 values is
    exact, so the one rounding is the f64 sum's then f32's (the two agree
    but for a tie, about once in 2^29 adds)."""
    w = weights.to(torch.float64)
    acc = torch.zeros(rows.shape[1:], dtype=torch.float32, device=rows.device)
    for i in range(rows.shape[0]):
        acc = (rows[i].to(torch.float64) * w[i] + acc.to(torch.float64)).to(torch.float32)
    return acc


def partial_reduce_rows(rows: torch.Tensor, weights: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fedtpu's ``partial_reduce_rows``: a cohort's ``[cohort, P]`` rows as
    ONE pre-weighted sum row and its weight sum, ``(sum_i rows_i * w_i,
    sum_i w_i)``. The division waits for the root
    (:func:`combine_partial_rows`), so for inputs whose f32 adds are exact
    any grouping into tiers gives the flat mean bit for bit."""
    return fma_row_sum(rows, weights.to(rows.dtype)), row_sum(weights)


def combine_partial_rows(sum_rows: torch.Tensor, weight_sums: torch.Tensor) -> torch.Tensor:
    """fedtpu's ``combine_partial_rows``: ``sum(sum_rows) / max(sum(
    weight_sums), 1e-9)`` over the ``[aggregators, P]`` partial sums, the
    hierarchy's one division."""
    total = torch.clamp(row_sum(weight_sums), min=1e-9)
    return row_sum(sum_rows) / total.to(sum_rows.dtype)
