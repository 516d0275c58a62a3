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

from fedtpu_torch.config import DataConfig, FedConfig, OptimizerConfig, RoundConfig
from fedtpu_torch.core.async_engine import AsyncFederation
from fedtpu_torch.core.engine import Federation
from fedtpu_torch.core.solo import SoloTrainer, run_solo

__all__ = [
    "AsyncFederation", "DataConfig", "FedConfig", "Federation", "OptimizerConfig", "RoundConfig",
    "SoloTrainer", "run_solo",
]
