"""Configuration of the PyTorch port.

An own copy of the fields of ``fedtpu.config`` that the ported round reads,
with the same names and defaults, so that one set of keyword arguments
builds the same run in both packages. :func:`validate` raises fedtpu's
``ValueError`` for a combination fedtpu forbids, and ``NotImplementedError``
naming the ROADMAP.md item that ports an option the port does not run yet
(the massive-cohort population, the models of slice 7, part 2): a setting
is never silently ignored.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
import math
from typing import Callable, Optional, Tuple

import numpy as np

from fedtpu_torch.sim.adversary import parse_attack


@functools.lru_cache(maxsize=None)
def _cosf() -> Callable[[float], float]:
    """The C library's f32 cosine, the one XLA's CPU backend calls for an
    f32 ``cos``; the correctly rounded cosine where there is no C library
    to load."""
    name = ctypes.util.find_library("m")
    if name:
        fn = ctypes.CDLL(name).cosf
        fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
        return fn
    return math.cos


ROTQ_BIT_WIDTHS = (1, 2, 4, 8)
SERVER_OPTIMIZERS = ("none", "momentum", "adam", "yogi")


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
    # HBM dtype of the per-client momentum buffers: the update is computed
    # in f32 either way, only the stored buffer is rounded.
    momentum_dtype: str = "float32"  # float32 | bfloat16

    def lr_at(self, round_idx: int) -> float:
        """Learning rate for a round: a host-side float that is an f32
        value, the rate fedtpu's compiled round computes.

        The cosine schedule is fedtpu's expression
        ``lr * 0.5 * (1 + cos(pi * t / t_max))`` in f32 on the int32 round
        ``t = min(round, t_max)``, as XLA compiles it on the CPU: the
        constants fold to ``t * f32(f32(pi) * f32(1 / t_max))``, the f32
        cosine is the C library's ``cosf`` (not correctly rounded
        everywhere, and neither ``torch.cos`` nor numpy's f32 cosine is the
        same function), then ``(cos + 1) * f32(lr * 0.5)``."""
        if self.schedule == "constant":
            return float(self.learning_rate)
        if self.schedule != "cosine":
            raise ValueError(f"unknown schedule: {self.schedule!r}")
        f32 = np.float32
        t = f32(min(int(round_idx), self.cosine_t_max))
        step = f32(f32(math.pi) * f32(1.0 / self.cosine_t_max))
        c = f32(_cosf()(float(f32(t * step))))
        return float(f32(f32(c + f32(1.0)) * f32(self.learning_rate * 0.5)))


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset, partition and device layout."""

    dataset: str = "cifar10"  # cifar10 | cifar100 | mnist | cifar10_hard | cifar100_hard | synthetic
    batch_size: int = 128
    eval_batch_size: int = 100
    partition: str = "round_robin"  # round_robin | iid | dirichlet
    dirichlet_alpha: float = 0.5
    augment: bool = True
    augment_crop: bool = True
    seed: int = 0
    num_examples: Optional[int] = None
    device_layout: str = "presharded"  # presharded | gather


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """``fedtpu.config.SimConfig``: the massive-cohort simulation and the
    seeded attackers.

    With ``population > 0``, :class:`fedtpu_torch.sim.SimFederation` keeps
    ``population`` clients as host rows and draws each round's cohort of
    ``FedConfig.num_clients`` seats from them: ``cohort_sampler`` is
    ``uniform`` or ``loss`` (in proportion to last-seen losses, the
    never-sampled at ``loss_prior``, or at the largest observed loss when it
    is negative); ``scenario`` partitions the population
    (:func:`fedtpu_torch.sim.scenario.make_partition`; empty: the
    ``DataConfig`` partition); ``availability`` and ``churn`` drive the
    seeded availability trace; ``seed`` is folded into the sampler's and
    the trace's seeds. ``malicious_fraction`` of the clients (of the
    population with one) are seeded attackers, chosen by ``(data.seed +
    seed + the attack's own seed)``; ``attack`` is the spec
    :func:`fedtpu_torch.sim.adversary.parse_attack` reads (``sign_flip``,
    ``scale:factor=F``, ``noise:std=S``, ``label_flip:offset=K``, with
    ``p=``, ``rounds=lo-hi``, ``collude=1`` and ``seed=``)."""

    population: int = 0
    cohort_sampler: str = "uniform"
    scenario: str = ""
    loss_prior: float = -1.0
    availability: float = 1.0
    churn: float = 0.0
    seed: int = 0
    malicious_fraction: float = 0.0
    attack: str = "sign_flip"


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """fedtpu's transient-fault handling of the gRPC edge
    (:mod:`fedtpu_torch.transport.retry`): an RPC whose status code is in
    ``transient_codes``, or whose reply fails the wire CRC, is tried again
    with exponential backoff and jitter, up to ``max_attempts`` in all;
    every other code fails on the first attempt. The per-RPC deadlines (in
    seconds) are fedtpu's."""

    max_attempts: int = 3
    backoff_s: float = 0.05
    backoff_multiplier: float = 2.0
    backoff_max_s: float = 2.0
    jitter: float = 0.2
    transient_codes: Tuple[str, ...] = (
        "UNAVAILABLE",
        "DEADLINE_EXCEEDED",
        "RESOURCE_EXHAUSTED",
        "ABORTED",
        "INTERNAL",
        "UNKNOWN",
    )
    start_train_timeout_s: float = 600.0
    send_model_timeout_s: float = 600.0
    fetch_model_timeout_s: float = 600.0
    probe_timeout_s: float = 1.0
    backup_ping_timeout_s: float = 2.0


def validate_retry_policy(rp: RetryPolicy) -> RetryPolicy:
    """fedtpu's ``validate_retry_policy``."""
    if rp.max_attempts < 1:
        raise ValueError(f"retry max_attempts must be >= 1, got {rp.max_attempts}")
    if rp.backoff_s < 0 or rp.backoff_max_s < 0:
        raise ValueError("retry backoff seconds must be >= 0")
    if rp.backoff_multiplier < 1.0:
        raise ValueError(
            f"retry backoff_multiplier must be >= 1, got {rp.backoff_multiplier}"
        )
    if not 0.0 <= rp.jitter <= 1.0:
        raise ValueError(f"retry jitter must be in [0, 1], got {rp.jitter}")
    return rp


@dataclasses.dataclass(frozen=True)
class ScreenConfig:
    """fedtpu's update screening: three per-row statistics of the flat
    ``[clients, P]`` deltas (:func:`fedtpu_torch.ops.flat.screen_rows`), each
    armed by its own threshold (0, or -1 for ``cos_min``, is off). The
    reputation fields serve fedtpu's distributed server; the engine reads
    only the thresholds, and all are validated as fedtpu validates them."""

    norm_max: float = 0.0
    zmax: float = 0.0
    cos_min: float = -1.0
    ewma: float = 0.5
    quarantine_at: float = 0.75
    release_at: float = 0.25
    evict_after: int = 0


def screening_enabled(screen: ScreenConfig) -> bool:
    """True when any screening statistic is armed."""
    return screen.norm_max > 0 or screen.zmax > 0 or screen.cos_min > -1.0


def validate_screen_config(screen: ScreenConfig) -> ScreenConfig:
    """fedtpu's ``validate_screen_config``."""
    if screen.norm_max < 0:
        raise ValueError(f"screen norm_max must be >= 0, got {screen.norm_max}")
    if screen.zmax < 0:
        raise ValueError(f"screen zmax must be >= 0, got {screen.zmax}")
    if not -1.0 <= screen.cos_min <= 1.0:
        raise ValueError(f"screen cos_min must be in [-1, 1], got {screen.cos_min}")
    if not 0.0 < screen.ewma <= 1.0:
        raise ValueError(f"screen ewma must be in (0, 1], got {screen.ewma}")
    if not 0.0 <= screen.release_at <= screen.quarantine_at <= 1.0:
        raise ValueError(
            "screen thresholds must satisfy 0 <= release_at <= "
            f"quarantine_at <= 1, got release_at={screen.release_at} "
            f"quarantine_at={screen.quarantine_at}"
        )
    if screen.evict_after < 0:
        raise ValueError(f"screen evict_after must be >= 0, got {screen.evict_after}")
    return screen


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """Federated topology and algorithm."""

    num_clients: int = 2
    num_rounds: int = 20
    local_epochs: int = 1
    algorithm: str = "fedavg"  # fedavg | fedprox
    fedprox_mu: float = 0.0
    weighted: bool = True
    participation_fraction: float = 1.0
    # uniform, or in proportion to each client's last training loss
    participation_sampling: str = "uniform"  # uniform | loss
    compression: str = "none"  # none | topk | int8 | rotq | randk (flat only)
    topk_fraction: float = 0.01
    error_feedback: bool = True
    delta_layout: str = "per_leaf"  # per_leaf | flat
    rotq_bits: int = 4  # 1 | 2 | 4 | 8
    server_optimizer: str = "none"  # none | momentum | adam | yogi
    server_lr: float = 1.0
    server_momentum: float = 0.9  # momentum's decay; adam's and yogi's b1
    server_beta2: float = 0.999
    server_eps: float = 1e-8
    aggregator: str = "mean"  # mean | median | trimmed_mean | krum
    trim_fraction: float = 0.1  # trimmed_mean's band; krum's assumed attackers
    dp_clip_norm: float = 0.0
    dp_noise_multiplier: float = 0.0
    sim: SimConfig = dataclasses.field(default_factory=SimConfig)
    screen: ScreenConfig = dataclasses.field(default_factory=ScreenConfig)
    compute_dtype: str = "float32"  # float32 | bfloat16_mixed
    # k > 0 trains each group of k clients as one [k * batch] forward
    megabatch_clients: int = 0
    # The gRPC edge's fields (fedtpu's names and defaults): the engine
    # ignores them, as fedtpu's does.
    # how the coordinator consumes replies: decoded per leaf and stacked
    # after the last one, or decoded into rows of one [clients, P] buffer
    server_pipeline: str = "auto"  # auto | barrier | stream
    # off | basic (the trainer's byte counts); trace is not ported
    telemetry: str = "basic"  # off | basic | trace
    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    # N > 0: the root of a two-tier topology whose seats front cohorts of N
    tier_fanout: int = 0
    # static | adaptive (a per-client codec learned from bytes x RTT)
    codec_policy: str = "static"
    # The coordinator's fault tolerance (fedtpu's names and defaults): the
    # fraction of the round's sampled clients that must reply for the
    # round to commit (0: whatever arrived), the backup's promotion
    # watchdog and the dead-client re-probe period, in seconds.
    round_quorum: float = 0.0
    ft_watchdog_timeout_s: float = 10.0
    ft_heartbeat_period_s: float = 1.0
    # run_async's reply-queue poll, in seconds (unchecked, as in fedtpu)
    async_poll_s: float = 1.0


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
    remat: bool = False  # per-block recompute (MobileNet, ResNet, PreAct-ResNet blocks)


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


AGGREGATORS = ("mean", "median", "trimmed_mean", "krum")


def validate_megabatch(fed: FedConfig) -> None:
    """fedtpu's ``validate_megabatch``."""
    k = fed.megabatch_clients
    if k < 0:
        raise ValueError(f"megabatch_clients must be >= 0, got {k}")
    if k and fed.num_clients % k:
        raise ValueError(
            f"megabatch_clients={k} must divide num_clients="
            f"{fed.num_clients}: the group regrouping is a static reshape "
            "of the [clients] axis"
        )


def validate_round_options(cfg: RoundConfig, compressed: bool) -> None:
    """fedtpu's checks of the round options (``make_round_step``), with its
    messages: a robust aggregator or DP with a codec, DP with example-count
    weights or another aggregator than the mean, ``trim_fraction`` outside
    ``[0, 0.5)``, a bad screen or megabatch setting. ``compressed``: the
    round runs a codec."""
    fed = cfg.fed
    if fed.aggregator not in AGGREGATORS:
        raise ValueError(
            f"unknown aggregator {fed.aggregator!r}; "
            "have mean | median | trimmed_mean | krum"
        )
    if screening_enabled(fed.screen):
        validate_screen_config(fed.screen)
    validate_megabatch(fed)
    if fed.aggregator != "mean":
        if compressed:
            raise ValueError(
                f"aggregator={fed.aggregator!r} cannot compose with "
                "delta compression: sparse deltas zero out coordinate-wise "
                "robust statistics. Use compression='none'."
            )
        if not 0.0 <= fed.trim_fraction < 0.5:
            raise ValueError(
                f"trim_fraction must be in [0, 0.5), got {fed.trim_fraction}"
            )
    if fed.dp_clip_norm > 0:
        if compressed:
            raise ValueError(
                "DP clipping cannot compose with delta compression: error "
                "feedback re-injects unclipped residual, voiding the "
                "sensitivity bound. Use compression='none'."
            )
        if fed.weighted:
            raise ValueError(
                "DP requires uniform weighting (FedConfig(weighted=False)): "
                "example-count weights change per-client sensitivity."
            )
        if fed.aggregator != "mean":
            raise ValueError(
                "DP noise std clip*sigma/n assumes the mean aggregator; "
                f"aggregator={fed.aggregator!r} has per-client "
                "sensitivity up to ~clip, so the accounting would be "
                "silently invalid. Use aggregator='mean'."
            )


def validate_sim_config(fed: FedConfig) -> None:
    """fedtpu's ``validate_sim_config``, with its messages: raise on
    inconsistent simulation settings, before any build work."""
    sim = fed.sim
    if not 0.0 <= sim.malicious_fraction < 1.0:
        raise ValueError(
            f"sim.malicious_fraction must be in [0, 1), got "
            f"{sim.malicious_fraction}"
        )
    if sim.malicious_fraction > 0:
        parse_attack(sim.attack)  # raises on a malformed spec
    if sim.population <= 0:
        return
    if sim.population < fed.num_clients:
        raise ValueError(
            f"sim.population={sim.population} < cohort "
            f"(num_clients={fed.num_clients}); the cohort is drawn FROM the "
            "population"
        )
    if sim.cohort_sampler not in ("uniform", "loss"):
        raise ValueError(
            f"unknown cohort_sampler {sim.cohort_sampler!r}; "
            "have uniform | loss"
        )
    if fed.participation_fraction != 1.0:
        raise ValueError(
            "sim.population and participation_fraction are mutually "
            "exclusive: the cohort sampler IS the participation model "
            "(set participation_fraction=1.0)"
        )
    if not 0.0 < sim.availability <= 1.0:
        raise ValueError(
            f"sim.availability must be in (0, 1], got {sim.availability}"
        )
    if not 0.0 <= sim.churn <= 1.0:
        raise ValueError(f"sim.churn must be in [0, 1], got {sim.churn}")


def validate(cfg: RoundConfig) -> RoundConfig:
    """Raise on a setting the port does not run or fedtpu forbids, before
    any build work."""
    fed, data, opt = cfg.fed, cfg.data, cfg.opt
    resolve_compute_dtype(cfg)
    if fed.delta_layout not in ("per_leaf", "flat"):
        raise ValueError(
            f"unknown delta_layout {fed.delta_layout!r}; have per_leaf | flat"
        )
    if fed.compression not in ("none", "topk", "int8", "rotq", "randk"):
        raise ValueError(f"unknown compression {fed.compression!r}")
    if fed.compression in ("rotq", "randk") and fed.delta_layout != "flat":
        raise ValueError(
            f"{fed.compression} is a flat-layout codec; set delta_layout='flat'"
        )
    if fed.compression == "rotq" and fed.rotq_bits not in ROTQ_BIT_WIDTHS:
        raise ValueError(
            f"rotq bits must be one of {ROTQ_BIT_WIDTHS}, got {fed.rotq_bits}"
        )
    if data.device_layout not in ("presharded", "gather"):
        raise ValueError(
            f"unknown device_layout {data.device_layout!r}; have presharded | gather"
        )
    if fed.server_optimizer not in SERVER_OPTIMIZERS:
        raise ValueError(
            f"unknown server_optimizer {fed.server_optimizer!r}; "
            f"have {' | '.join(SERVER_OPTIMIZERS)}"
        )
    if fed.algorithm not in ("fedavg", "fedprox"):
        raise ValueError(f"unknown algorithm {fed.algorithm!r}; have fedavg | fedprox")
    if fed.participation_sampling not in ("uniform", "loss"):
        raise ValueError(
            f"unknown participation_sampling {fed.participation_sampling!r}; "
            "have uniform | loss"
        )
    if data.partition not in ("round_robin", "iid", "dirichlet"):
        raise ValueError(f"unknown partition {data.partition!r}")
    if opt.momentum_dtype not in ("float32", "bfloat16"):
        raise ValueError(
            f"unknown momentum_dtype {opt.momentum_dtype!r}; have float32 | bfloat16"
        )
    validate_sim_config(fed)
    validate_round_options(cfg, compressed=fed.compression != "none")
    return cfg


def resolve_server_pipeline(fed: FedConfig) -> str:
    """fedtpu's ``resolve_server_pipeline``: ``"barrier"`` or ``"stream"``.
    Only the (weighted) mean without DP folds rows as they arrive; ``auto``
    streams on the flat delta layout."""
    if fed.server_pipeline not in ("auto", "barrier", "stream"):
        raise ValueError(
            f"unknown server_pipeline {fed.server_pipeline!r}; "
            "have auto | barrier | stream"
        )
    streamable = fed.aggregator == "mean" and fed.dp_clip_norm == 0
    if fed.server_pipeline == "stream":
        if fed.aggregator != "mean":
            raise ValueError(
                f"server_pipeline='stream' cannot compose with "
                f"aggregator={fed.aggregator!r}: median/trimmed_mean/krum "
                "are not per-coordinate sums, so they need every client "
                "row at once — use server_pipeline='barrier' (the stacked "
                "[clients, ...] path)."
            )
        if fed.dp_clip_norm > 0:
            raise ValueError(
                "server_pipeline='stream' cannot compose with DP clipping: "
                "DP-FedAvg clips each client's full delta before the "
                "combine, so rows cannot fold into a running aggregate — "
                "use server_pipeline='barrier'."
            )
        return "stream"
    if fed.server_pipeline == "barrier":
        return "barrier"
    return "stream" if (fed.delta_layout == "flat" and streamable) else "barrier"


def validate_tier_config(fed: FedConfig, face: str) -> None:
    """fedtpu's ``validate_tier_config``: a tier forwards pre-weighted sums,
    so it needs the mean, no DP, no screening and the streaming pipeline."""
    if fed.tier_fanout < 0:
        raise ValueError(f"tier_fanout must be >= 0, got {fed.tier_fanout}")
    if fed.aggregator != "mean":
        raise ValueError(
            f"hierarchical aggregation ({face}) requires aggregator='mean': "
            f"{fed.aggregator!r} needs every client row at the combine, "
            "but tiers forward only pre-weighted sums"
        )
    if fed.dp_clip_norm > 0:
        raise ValueError(
            f"hierarchical aggregation ({face}) cannot compose with DP "
            "clipping: per-client sensitivity bounds need individual rows "
            "at the root"
        )
    if screening_enabled(fed.screen):
        raise ValueError(
            f"hierarchical aggregation ({face}) cannot compose with update "
            "screening: screening statistics need individual client rows "
            "(screen at a future leaf tier instead)"
        )
    if resolve_server_pipeline(fed) != "stream":
        raise ValueError(
            f"hierarchical aggregation ({face}) requires the streaming "
            "pipeline: partial sums arrive as flat rows and fold through "
            "the [rows, P] stream buffer (server_pipeline='barrier' has "
            "no flat layout to decode them into)"
        )


def validate_coordinator(cfg: RoundConfig) -> RoundConfig:
    """:func:`validate_edge`, and the coordinator's own fields, with
    fedtpu's ``PrimaryServer`` messages: the round quorum, and the codec
    policy, whose ``adaptive`` may pick any lossy codec a round, so it
    needs what a static lossy codec needs and the flat layout its sketch
    codecs exist in. The tier fan-out is checked by :func:`validate_edge`
    (fedtpu's ``validate_tier_config``)."""
    validate_edge(cfg)
    fed = cfg.fed
    if not 0.0 <= fed.round_quorum <= 1.0:
        raise ValueError(f"round_quorum must be in [0, 1], got {fed.round_quorum}")
    if fed.codec_policy not in ("static", "adaptive"):
        raise ValueError(
            f"unknown codec_policy {fed.codec_policy!r}; have static | adaptive"
        )
    if fed.codec_policy == "adaptive":
        if fed.delta_layout != "flat":
            raise ValueError(
                "codec_policy='adaptive' requires delta_layout='flat': "
                "the sketch codecs it selects among (rotq/randk) only "
                "exist as flat records"
            )
        if fed.aggregator != "mean" or fed.dp_clip_norm > 0:
            raise ValueError(
                "codec_policy='adaptive' can select lossy codecs, so it "
                "needs aggregator='mean' and no DP clipping (the same "
                "constraints as a static lossy codec)"
            )
    return cfg


def validate_edge(cfg: RoundConfig) -> RoundConfig:
    """:func:`validate`, and the edge's own fields: the retry policy, the
    server pipeline, the tier fan-out and the telemetry mode."""
    validate(cfg)
    fed = cfg.fed
    validate_retry_policy(fed.retry)
    resolve_server_pipeline(fed)
    if fed.tier_fanout:
        validate_tier_config(fed, "tier")
    if fed.telemetry not in ("off", "basic", "trace"):
        raise ValueError(f"unknown telemetry {fed.telemetry!r}; have off | basic | trace")
    return cfg
