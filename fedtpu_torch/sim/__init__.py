"""Massive-cohort simulation and the host-side helpers it shares with the
engine: the port's own copy of ``fedtpu.sim``.

A host-resident :class:`Population` of ``N >> cohort`` clients, seeded
cohort samplers, composable non-IID scenarios, and :class:`SimFederation`,
which runs sampled cohorts through the resident engine with O(cohort)
device memory; beside them loss-proportional sampling weights and the
seeded attackers. :class:`SimFederation` is imported on first use: the
engine it extends imports this package's helpers.
"""

from fedtpu_torch.sim.population import Population
from fedtpu_torch.sim.samplers import (
    CohortSampler,
    LossProportionalSampler,
    UniformSampler,
    make_sampler,
)
from fedtpu_torch.sim.sampling import loss_weights
from fedtpu_torch.sim.scenario import (
    cohort_eval_indices,
    make_partition,
    parse_scenario,
)

__all__ = [
    "SimFederation",
    "Population",
    "CohortSampler",
    "UniformSampler",
    "LossProportionalSampler",
    "make_sampler",
    "loss_weights",
    "make_partition",
    "parse_scenario",
    "cohort_eval_indices",
]


def __getattr__(name: str):
    if name == "SimFederation":
        from fedtpu_torch.sim.engine import SimFederation

        return SimFederation
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
