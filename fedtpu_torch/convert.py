"""Carry variables between a flax tree and the port's torch models.

flax keeps nested ``{module: {... {leaf: array}}}`` trees, one per
collection (``params``, ``batch_stats``), with Conv kernels HWIO and Dense
kernels ``[in, out]``; torch keeps flat ``"module.sub.leaf"`` names, OIHW
and ``[out, in]``. The functions here convert either collection: a leaf's
torch name is its flax path joined by dots, ``kernel`` becomes ``weight``
(permuted) and every other leaf (``bias``, BatchNorm's ``scale``, and the
statistics ``mean`` and ``var``) keeps its name and layout. Leaves map one
to one, so a per-leaf codec sees the same sets of coordinates in both
packages.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from fedtpu_torch.transport.msgpack import Bfloat16Array

_TO_TORCH = {"kernel": "weight", "bias": "bias", "scale": "scale", "mean": "mean", "var": "var"}
_TO_FLAX = {v: k for k, v in _TO_TORCH.items()}


# Axis permutations by rank; ranks 5 and 3 are kernels stacked over a
# leading clients axis, which stays first.
_KERNEL_TO_TORCH = {
    4: (3, 2, 0, 1),     # HWIO -> OIHW
    2: (1, 0),           # [in, out] -> [out, in]
    5: (0, 4, 3, 1, 2),
    3: (0, 2, 1),
}
_WEIGHT_TO_FLAX = {
    4: (2, 3, 1, 0),     # OIHW -> HWIO
    2: (1, 0),
    5: (0, 3, 4, 2, 1),
    3: (0, 2, 1),
}


def _permute(a, table):
    """``a`` (a numpy array or a bf16 array's words) with its axes permuted."""
    if isinstance(a, Bfloat16Array):
        return Bfloat16Array(_permute(a.words, table))
    if a.ndim not in table:
        raise ValueError(f"unsupported kernel rank {a.ndim}")
    return a.transpose(table[a.ndim])


def _leaves(tree: Mapping, path: Tuple[str, ...] = ()):
    """``(path, leaf name, array)`` for every leaf of a nested flax tree."""
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, path + (key,))
        else:
            yield path, key, value


def host_array(t: torch.Tensor):
    """A tensor on the host as a numpy array, or a bf16 tensor as a
    :class:`~fedtpu_torch.transport.msgpack.Bfloat16Array` of its words
    (numpy has no bfloat16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return Bfloat16Array(t.view(torch.int16).numpy())
    return t.numpy()


def _tensor(a, device) -> torch.Tensor:
    """A numpy array, or a bf16 array's words, as a contiguous tensor."""
    if isinstance(a, Bfloat16Array):
        words = np.array(a.words, order="C").view(np.int16)  # a 0-d array stays 0-d
        return torch.tensor(words, device=device).view(torch.bfloat16)
    return torch.tensor(np.ascontiguousarray(a), device=device)


def from_flax(
    tree: Mapping, device: Optional[torch.device] = None
) -> Dict[str, torch.Tensor]:
    """A flax ``params`` or ``batch_stats`` tree -> ``{"Conv_0.weight":
    tensor, ...}`` (each leaf in its own dtype, contiguous, on ``device``
    or the CPU; a :class:`~fedtpu_torch.transport.msgpack.Bfloat16Array`
    becomes a bf16 tensor). Leaves stacked over a leading clients axis
    (deltas, residuals, momentum) convert the same way per client."""
    out = {}
    for path, leaf, value in _leaves(tree):
        a = value if isinstance(value, Bfloat16Array) else np.asarray(value)
        if not isinstance(a, Bfloat16Array) and a.dtype.name == "bfloat16":
            a = Bfloat16Array(a.view(np.uint16))  # a numpy extension type's bf16
        if leaf == "kernel":
            a = _permute(a, _KERNEL_TO_TORCH)
        out[".".join(path + (_TO_TORCH[leaf],))] = _tensor(a, device)
    return out


def to_flax(tensors: Mapping[str, torch.Tensor]) -> Dict[str, dict]:
    """Inverse of :func:`from_flax`: a nested tree of numpy arrays in
    flax's layout, a leading clients axis kept where there is one."""
    out: Dict[str, dict] = {}
    for name, t in tensors.items():
        *mods, leaf = name.split(".")
        a = host_array(t)
        if leaf == "weight":
            a = _permute(a, _WEIGHT_TO_FLAX)
        node = out
        for mod in mods:
            node = node.setdefault(mod, {})
        node[_TO_FLAX[leaf]] = (
            Bfloat16Array(np.array(a.words, order="C")) if isinstance(a, Bfloat16Array)
            else np.ascontiguousarray(a)
        )
    return out
