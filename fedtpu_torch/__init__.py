"""fedtpu_torch: the PyTorch / CUDA port of fedtpu.

A package of its own beside ``fedtpu``: it imports ``torch`` and numpy,
never JAX or anything of ``fedtpu``. Its entry point,
:class:`fedtpu_torch.core.engine.Federation`, runs on a CUDA device unless
the caller asks for the CPU. The compressed round's two TPU kernels are
hand-written CUDA kernels here (:mod:`fedtpu_torch.ops.kernels`), built
from ``fedtpu_torch/csrc`` with ``nvcc`` at first use.
"""

from fedtpu_torch.config import DataConfig, FedConfig, OptimizerConfig, RoundConfig
from fedtpu_torch.core.engine import Federation

__all__ = ["DataConfig", "FedConfig", "Federation", "OptimizerConfig", "RoundConfig"]
