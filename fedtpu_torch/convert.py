"""Carry parameters between a flax tree and the port's torch models.

flax keeps ``{module: {"kernel", "bias"}}`` with Conv kernels HWIO and
Dense kernels ``[in, out]``; torch keeps ``"module.weight"`` OIHW and
``[out, in]``. Leaves map one to one (kernel and bias stay separate), so a
per-leaf codec sees the same sets of coordinates in both packages.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

_TO_TORCH = {"kernel": "weight", "bias": "bias"}
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


def _permute(a: np.ndarray, table) -> np.ndarray:
    if a.ndim not in table:
        raise ValueError(f"unsupported kernel rank {a.ndim}")
    return a.transpose(table[a.ndim])


def from_flax(
    params: Mapping[str, Mapping[str, np.ndarray]],
    device: Optional[torch.device] = None,
) -> Dict[str, torch.Tensor]:
    """flax ``params`` tree -> ``{"Conv_0.weight": tensor, ...}`` (f32,
    contiguous, on ``device`` or the CPU). Leaves stacked over a leading
    clients axis (deltas, residuals) convert the same way per client."""
    out = {}
    for mod, leaves in params.items():
        for leaf, value in leaves.items():
            a = np.asarray(value, np.float32)
            if leaf == "kernel":
                a = _permute(a, _KERNEL_TO_TORCH)
            out[f"{mod}.{_TO_TORCH[leaf]}"] = torch.tensor(
                np.ascontiguousarray(a), device=device
            )
    return out


def to_flax(params: Mapping[str, torch.Tensor]) -> Dict[str, Dict[str, np.ndarray]]:
    """Inverse of :func:`from_flax`: numpy arrays in flax's layout, a
    leading clients axis kept where there is one."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for name, t in params.items():
        mod, leaf = name.rsplit(".", 1)
        a = t.detach().cpu().numpy()
        if leaf == "weight":
            a = _permute(a, _WEIGHT_TO_FLAX)
        out.setdefault(mod, {})[_TO_FLAX[leaf]] = np.ascontiguousarray(a)
    return out
