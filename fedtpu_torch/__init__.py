"""fedtpu_torch: the PyTorch / CUDA port of fedtpu.

A package of its own beside ``fedtpu``: it imports ``torch`` and numpy,
never JAX or anything of ``fedtpu``. Its entry point,
:class:`fedtpu_torch.core.engine.Federation`, runs on a CUDA device unless
the caller asks for the CPU, as do the asynchronous engine
(:class:`fedtpu_torch.core.async_engine.AsyncFederation`) and the
standalone trainer (:class:`fedtpu_torch.core.solo.SoloTrainer`).
fedtpu's three TPU kernels (top-k with error feedback, int8, the Hadamard
rotation of ``rotq``) are hand-written CUDA kernels here
(:mod:`fedtpu_torch.ops.kernels`), built from ``fedtpu_torch/csrc`` with
``nvcc`` at first use.
"""

import importlib

# Resolved on first use, so that a host-only subpackage (``fedtpu_torch.obs``)
# imports without loading torch.
_EXPORTS = {
    "AsyncFederation": "fedtpu_torch.core.async_engine",
    "DataConfig": "fedtpu_torch.config",
    "FedConfig": "fedtpu_torch.config",
    "Federation": "fedtpu_torch.core.engine",
    "OptimizerConfig": "fedtpu_torch.config",
    "RoundConfig": "fedtpu_torch.config",
    "SoloTrainer": "fedtpu_torch.core.solo",
    "run_solo": "fedtpu_torch.core.solo",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
