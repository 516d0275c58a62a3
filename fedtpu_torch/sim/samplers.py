"""Per-round cohort samplers over a :class:`~fedtpu_torch.sim.population.
Population`: the port's own copy of ``fedtpu.sim.samplers``, the same
cohort sequences for the same seed.

Each round a sampler draws a ``cohort`` of the available clients, without
replacement, and returns the ids sorted: with ``population == cohort`` and
everyone available every round's cohort is the identity, no seat is ever
reset, and the sim engine is the resident engine bit for bit. When fewer
clients are available than the cohort has seats, the spare seats are
padded with id 0 and marked dead in the returned ``alive``. Seeded per
(sampler seed, round).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from fedtpu_torch.sim.population import Population
from fedtpu_torch.sim.sampling import loss_weights, round_rng


class CohortSampler:
    """Base: common availability handling + pad-to-cohort machinery."""

    name = "base"

    def __init__(self, seed: int = 0):
        self.seed = int(seed)

    def _probabilities(
        self, pop: Population, candidates: np.ndarray
    ) -> Optional[np.ndarray]:
        """Pick probabilities over the available candidates (None = uniform)."""
        return None

    def sample(
        self, pop: Population, round_idx: int, cohort: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Draw one round's cohort: ``(client_ids[cohort], alive[cohort])``,
        ids sorted ascending, ``alive`` False only for padded slots."""
        if cohort < 1 or cohort > pop.size:
            raise ValueError(
                f"cohort must be in [1, population={pop.size}], got {cohort}"
            )
        candidates = np.flatnonzero(pop.available_at(round_idx))
        rng = round_rng(self.seed, round_idx)
        if len(candidates) <= cohort:
            chosen = candidates
        else:
            p = self._probabilities(pop, candidates)
            chosen = rng.choice(candidates, size=cohort, replace=False, p=p)
        chosen = np.sort(chosen.astype(np.int64))
        alive = np.ones((cohort,), bool)
        if len(chosen) < cohort:
            pad = cohort - len(chosen)
            alive[len(chosen):] = False
            chosen = np.concatenate([chosen, np.zeros((pad,), np.int64)])
        return chosen, alive


class UniformSampler(CohortSampler):
    """Uniform without-replacement over the available population."""

    name = "uniform"


class LossProportionalSampler(CohortSampler):
    """Importance sampling proportional to each client's *last-seen*
    training loss (arXiv:2306.03240 flavor), routed through the population's
    sparse observation table: never-yet-sampled clients draw at the
    optimistic prior (``prior``; default the max observed loss) instead of a
    stale zero, so the worst-served clients are revisited *and* the
    never-visited are explored. Uniform until the first observation lands.
    """

    name = "loss"

    def __init__(self, seed: int = 0, prior: Optional[float] = None):
        super().__init__(seed)
        self.prior = prior

    def _probabilities(self, pop, candidates):
        return loss_weights(pop.last_seen_loss[candidates], prior=self.prior)


def make_sampler(
    name: str, seed: int = 0, prior: Optional[float] = None
) -> CohortSampler:
    """Sampler factory for ``SimConfig.cohort_sampler``."""
    if name == "uniform":
        return UniformSampler(seed)
    if name == "loss":
        return LossProportionalSampler(seed, prior=prior)
    raise ValueError(f"unknown cohort sampler {name!r}; have uniform | loss")
