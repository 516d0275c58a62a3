"""Configuration of the PyTorch port.

An own copy of the fields of ``fedtpu.config`` that the ported round reads,
with the same names and defaults, so that one set of keyword arguments
builds the same run in both packages. Options the port does not run yet are
kept as fields and rejected by :func:`validate` with ``NotImplementedError``
naming the ROADMAP.md item that ports them: a setting is never silently
ignored.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Per-client local SGD with torch semantics (coupled weight decay,
    momentum kept per client across rounds)."""

    learning_rate: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 5e-4
    schedule: str = "constant"  # constant | cosine
    cosine_t_max: int = 200
    nesterov: bool = False
    momentum_dtype: str = "float32"  # float32 | bfloat16 (not ported)

    def lr_at(self, round_idx: int) -> float:
        """Learning rate for a round (a host-side float)."""
        if self.schedule == "constant":
            return float(self.learning_rate)
        if self.schedule != "cosine":
            raise ValueError(f"unknown schedule: {self.schedule!r}")
        t = min(round_idx, self.cosine_t_max)
        return self.learning_rate * 0.5 * (
            1.0 + math.cos(math.pi * t / self.cosine_t_max)
        )


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset, partition and device layout."""

    dataset: str = "cifar10"  # cifar10 | cifar100 | mnist | synthetic
    batch_size: int = 128
    eval_batch_size: int = 100
    partition: str = "round_robin"  # round_robin | iid | dirichlet (not ported)
    augment: bool = True
    augment_crop: bool = True
    seed: int = 0
    num_examples: Optional[int] = None
    device_layout: str = "presharded"  # presharded | gather (not ported)


@dataclasses.dataclass(frozen=True)
class ScreenConfig:
    """The three screening statistics of ``fedtpu.config.ScreenConfig``;
    any of them armed turns screening on, which the port does not run."""

    norm_max: float = 0.0
    zmax: float = 0.0
    cos_min: float = -1.0


def screening_enabled(screen: ScreenConfig) -> bool:
    return screen.norm_max > 0 or screen.zmax > 0 or screen.cos_min > -1.0


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """Federated topology and algorithm."""

    num_clients: int = 2
    num_rounds: int = 20
    local_epochs: int = 1
    algorithm: str = "fedavg"  # fedavg | fedprox (not ported)
    weighted: bool = True
    participation_fraction: float = 1.0
    participation_sampling: str = "uniform"  # uniform | loss (not ported)
    compression: str = "none"  # none | topk | int8 | rotq, randk (not ported)
    topk_fraction: float = 0.01
    error_feedback: bool = True
    delta_layout: str = "per_leaf"  # per_leaf | flat (not ported)
    server_optimizer: str = "none"  # none | momentum, adam, yogi (not ported)
    aggregator: str = "mean"  # mean | median, trimmed_mean, krum (not ported)
    dp_clip_norm: float = 0.0
    dp_noise_multiplier: float = 0.0
    screen: ScreenConfig = dataclasses.field(default_factory=ScreenConfig)
    compute_dtype: str = "float32"  # float32 | bfloat16_mixed
    megabatch_clients: int = 0


@dataclasses.dataclass(frozen=True)
class RoundConfig:
    """Everything one round needs."""

    model: str = "MobileNet"
    num_classes: int = 10
    opt: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    fed: FedConfig = dataclasses.field(default_factory=FedConfig)
    steps_per_round: int = 8
    dtype: str = "float32"  # activation dtype; params stay f32


def resolve_compute_dtype(cfg: RoundConfig) -> str:
    """Effective compute dtype name of the local step ("float32" |
    "bfloat16"): ``bfloat16_mixed`` wins, else the legacy ``dtype`` knob."""
    if cfg.fed.compute_dtype not in ("float32", "bfloat16_mixed"):
        raise ValueError(
            f"unknown compute_dtype {cfg.fed.compute_dtype!r}; "
            "have float32 | bfloat16_mixed"
        )
    if cfg.fed.compute_dtype == "bfloat16_mixed":
        return "bfloat16"
    if cfg.dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown dtype {cfg.dtype!r}; have float32 | bfloat16")
    return cfg.dtype


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error for a setting the port does not run yet, naming the
    ROADMAP.md item that ports it."""
    return NotImplementedError(
        f"{what} is not ported to fedtpu_torch yet (ROADMAP.md Queue 1, {item})"
    )


def validate(cfg: RoundConfig) -> RoundConfig:
    """Raise on a setting the port does not run, before any build work."""
    fed, data, opt = cfg.fed, cfg.data, cfg.opt
    resolve_compute_dtype(cfg)
    if fed.delta_layout == "flat":
        raise not_ported("delta_layout='flat'", "slice 2: flat layout + rotq")
    if fed.delta_layout != "per_leaf":
        raise ValueError(f"unknown delta_layout {fed.delta_layout!r}")
    if fed.compression in ("rotq", "randk"):
        raise not_ported(
            f"compression={fed.compression!r}", "slice 2: flat layout + rotq"
        )
    if fed.compression not in ("none", "topk", "int8"):
        raise ValueError(f"unknown compression {fed.compression!r}")
    if data.device_layout == "gather":
        raise not_ported("device_layout='gather'", "slice 3: gather layout")
    if data.device_layout != "presharded":
        raise ValueError(f"unknown device_layout {data.device_layout!r}")
    if fed.server_optimizer != "none":
        raise not_ported(
            f"server_optimizer={fed.server_optimizer!r}",
            "slice 4: server optimizers",
        )
    if fed.aggregator != "mean":
        raise not_ported(
            f"aggregator={fed.aggregator!r}", "slice 7: round options"
        )
    if fed.dp_clip_norm > 0 or fed.dp_noise_multiplier > 0:
        raise not_ported("differential privacy", "slice 7: round options")
    if screening_enabled(fed.screen):
        raise not_ported("update screening", "slice 7: round options")
    if fed.megabatch_clients:
        raise not_ported("megabatch_clients", "slice 7: round options")
    if fed.algorithm != "fedavg":
        raise not_ported(f"algorithm={fed.algorithm!r}", "slice 7: round options")
    if fed.participation_sampling != "uniform":
        raise not_ported(
            f"participation_sampling={fed.participation_sampling!r}",
            "slice 7: round options",
        )
    if data.partition == "dirichlet":
        raise not_ported("partition='dirichlet'", "slice 7: round options")
    if data.partition not in ("round_robin", "iid"):
        raise ValueError(f"unknown partition {data.partition!r}")
    if opt.momentum_dtype == "bfloat16":
        raise not_ported("momentum_dtype='bfloat16'", "slice 7: round options")
    if opt.momentum_dtype != "float32":
        raise ValueError(f"unknown momentum_dtype {opt.momentum_dtype!r}")
    return cfg
