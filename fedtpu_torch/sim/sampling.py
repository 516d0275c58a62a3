"""Sampling weights from sparse loss observations: the port's own copy of
``fedtpu.sim.sampling``, numpy only.

A client is observed only in the rounds it trains, so the rule for a
missing observation matters: a client never yet sampled draws at an
optimistic prior (the largest observed loss by default), never at a stale
zero, or a small first cohort would starve the others for good.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def loss_weights(
    observed: np.ndarray, prior: Optional[float] = None
) -> Optional[np.ndarray]:
    """Normalised sampling probabilities from last-seen training losses
    (``NaN`` where a client was never observed). ``None`` when nothing was
    observed yet (the caller then samples uniformly); else unobserved
    entries take ``prior`` (default: the largest observed loss), every
    entry gets a floor of 1e-8, and the vector is normalised, in f64 as
    fedtpu does it, so both packages draw the same masks."""
    obs = np.asarray(observed, np.float64)
    if obs.size == 0 or np.all(np.isnan(obs)):
        return None
    fill = float(np.nanmax(obs)) if prior is None or prior < 0 else float(prior)
    w = np.where(np.isnan(obs), fill, obs)
    w = np.maximum(w, 0.0) + 1e-8
    return w / w.sum()


def round_rng(seed: int, round_idx: int, salt: int = 0) -> np.random.Generator:
    """fedtpu's seeded per-round generator, ``seed * 7919 + round``, with a
    salt that keeps two consumers of one round apart (the cohort sampler
    and the availability trace)."""
    return np.random.default_rng((seed + salt * 1_000_003) * 7919 + round_idx)
