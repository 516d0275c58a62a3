"""The population: per-client truth when ``population >> cohort``.

The port's own copy of ``fedtpu.sim.population``, numpy only and bit-equal
to it. The engine sizes every per-client buffer (momentum, residuals, the
flat ``[clients, P]`` row) to the cohort; what must survive between a
client's cohort appearances lives here as host rows instead: its dataset
assignment, last-seen loss, availability and sampling bookkeeping,
O(population) numpy, while the device holds O(cohort).

Momentum and codec residuals deliberately do not persist per client: a
sampled cross-device client starts its local run fresh, so the engine
resets a seat's heavy state whenever the seat goes to another client
(:class:`fedtpu_torch.sim.engine.SimFederation`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from fedtpu_torch.sim.sampling import round_rng

# Salt for the availability trace's RNG stream (decorrelates it from the
# cohort sampler's draws over the same seed/round).
_AVAIL_SALT = 17


class Population:
    """Host-resident per-client state for a simulated client population.

    ``idx`` / ``mask``: the padded ``[population, shard_len]`` dataset
    assignment from :mod:`fedtpu_torch.data.partition` /
    :mod:`fedtpu_torch.sim.scenario`. Per-client tables (all ``[population]``):

    - ``last_seen_loss`` — f32, NaN until the client first trains; updated
      from the engine's on-device observations after each round/block.
      Feeds the loss-proportional cohort sampler through
      :func:`fedtpu_torch.sim.sampling.loss_weights` (optimistic prior for the
      never-sampled).
    - ``last_sampled_round`` — int64, -1 until first sampled.
    - ``times_sampled`` — int64 draw counter (`never_sampled()` is the
      exploration-debt gauge the obs plane exports).
    - availability — a seeded two-state Markov trace (`available_at`):
      P(up->down) = ``churn`` per round, P(down->up) chosen so the
      stationary up-fraction is ``availability``. ``churn=0`` freezes the
      initial Bernoulli(availability) draw; ``availability=1`` means always
      up. Deterministic in (seed, round): replaying a run replays its
      churn trace.
    """

    def __init__(
        self,
        idx: np.ndarray,
        mask: np.ndarray,
        *,
        seed: int = 0,
        availability: float = 1.0,
        churn: float = 0.0,
    ):
        if not 0.0 < availability <= 1.0:
            raise ValueError(
                f"availability must be in (0, 1], got {availability}"
            )
        if not 0.0 <= churn <= 1.0:
            raise ValueError(f"churn must be in [0, 1], got {churn}")
        self.idx = np.asarray(idx, np.int32)
        self.mask = np.asarray(mask, bool)
        if self.idx.shape != self.mask.shape or self.idx.ndim != 2:
            raise ValueError(
                f"idx/mask must be matching [population, shard_len] arrays, "
                f"got {self.idx.shape} vs {self.mask.shape}"
            )
        self.size = self.idx.shape[0]
        self.sizes = self.mask.sum(axis=1).astype(np.int64)
        self.seed = int(seed)
        self.availability = float(availability)
        self.churn = float(churn)
        n = self.size
        self.last_seen_loss = np.full((n,), np.nan, np.float32)
        self.last_sampled_round = np.full((n,), -1, np.int64)
        self.times_sampled = np.zeros((n,), np.int64)
        # Availability trace state, advanced lazily round-by-round.
        init_rng = round_rng(self.seed, -1, salt=_AVAIL_SALT)
        self._avail = (
            init_rng.random(n) < self.availability
            if self.availability < 1.0
            else np.ones((n,), bool)
        )
        self._avail_round = -1
        # Membership mask: True = current member. The availability trace
        # models TRANSIENT presence (a member that happens to be offline);
        # membership models the roster itself — evicted clients are never
        # sampled however their availability trace rolls, and mid-run
        # admits (`admit`) grow the population without touching the
        # engine's fixed cohort seats (the set_assignment values-only swap
        # maps whatever ids the sampler draws onto them).
        self._member = np.ones((n,), bool)

    # ---------------------------------------------------------- membership
    def admit(self, idx_row: np.ndarray, mask_row: np.ndarray) -> int:
        """Admit a NEW client mid-run: append its padded dataset-assignment
        row (same ``shard_len`` as the population's; shorter rows are
        zero-padded) and fresh bookkeeping. Returns the new client id —
        immediately eligible for cohort sampling."""
        shard_len = self.idx.shape[1]
        idx_row = np.asarray(idx_row, np.int32).reshape(-1)
        mask_row = np.asarray(mask_row, bool).reshape(-1)
        if idx_row.shape != mask_row.shape:
            raise ValueError("admit: idx/mask rows must match")
        if len(idx_row) > shard_len:
            raise ValueError(
                f"admit: shard of {len(idx_row)} exceeds the population's "
                f"shard_len {shard_len}"
            )
        pad = shard_len - len(idx_row)
        if pad:
            idx_row = np.concatenate([idx_row, np.zeros((pad,), np.int32)])
            mask_row = np.concatenate([mask_row, np.zeros((pad,), bool)])
        cid = self.size
        self.idx = np.concatenate([self.idx, idx_row[None]])
        self.mask = np.concatenate([self.mask, mask_row[None]])
        self.sizes = np.concatenate(
            [self.sizes, [int(mask_row.sum())]]
        ).astype(np.int64)
        self.last_seen_loss = np.concatenate(
            [self.last_seen_loss, [np.nan]]
        ).astype(np.float32)
        self.last_sampled_round = np.concatenate(
            [self.last_sampled_round, [-1]]
        ).astype(np.int64)
        self.times_sampled = np.concatenate(
            [self.times_sampled, [0]]
        ).astype(np.int64)
        self._avail = np.concatenate([self._avail, [True]])
        self._member = np.concatenate([self._member, [True]])
        self.size += 1
        return cid

    def evict(self, client_id: int) -> None:
        """Remove a client from the roster (its row and bookkeeping stay,
        so a later :meth:`readmit` returns it stale — with its last-seen
        loss — rather than fresh)."""
        self._member[int(client_id)] = False

    def readmit(self, client_id: int) -> None:
        """A stale rejoin: the client re-enters the roster with the
        bookkeeping it left with."""
        self._member[int(client_id)] = True

    def members(self) -> np.ndarray:
        return self._member.copy()

    # ------------------------------------------------------------ sampling
    def available_at(self, round_idx: int) -> np.ndarray:
        """The ``[population]`` availability mask for a round (advancing the
        Markov trace as needed; rounds may only move forward). Non-members
        are never available, whatever their trace state."""
        if self.churn <= 0.0:
            # No dynamics: the initial draw holds at every round.
            return self._avail & self._member
        if round_idx < self._avail_round:
            raise ValueError(
                f"availability trace cannot rewind: at round "
                f"{self._avail_round}, asked for {round_idx}"
            )
        a, c = self.availability, self.churn
        # Stationarity: up-fraction a is preserved when
        # a * P(up->down) == (1 - a) * P(down->up).
        p_up = min(1.0, c * a / max(1.0 - a, 1e-9)) if a < 1.0 else 1.0
        while self._avail_round < round_idx:
            self._avail_round += 1
            rng = round_rng(self.seed, self._avail_round, salt=_AVAIL_SALT)
            u = rng.random(self.size)
            self._avail = np.where(self._avail, u >= c, u < p_up)
        return self._avail & self._member

    def mark_sampled(self, client_ids: np.ndarray, round_idx: int) -> None:
        ids = np.asarray(client_ids, np.int64)
        self.times_sampled[ids] += 1
        self.last_sampled_round[ids] = round_idx

    def observe_loss(self, client_ids: np.ndarray, losses: np.ndarray) -> None:
        """Record fresh loss observations (non-finite entries are skipped —
        a slot that never actually trained must not write a stale value)."""
        ids = np.asarray(client_ids, np.int64)
        vals = np.asarray(losses, np.float32)
        ok = np.isfinite(vals)
        self.last_seen_loss[ids[ok]] = vals[ok]

    def never_sampled(self) -> int:
        """How many clients have never been in a cohort (exploration debt)."""
        return int(np.sum(self.times_sampled == 0))

    # -------------------------------------------------------------- gather
    def gather(
        self, client_ids: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Cohort-shaped ``(idx, mask, weights)`` rows for the engine's
        fixed-size buffers — the O(cohort) device view of the population."""
        ids = np.asarray(client_ids, np.int64)
        return (
            self.idx[ids],
            self.mask[ids],
            self.sizes[ids].astype(np.float32),
        )

    # ------------------------------------------------------------- metrics
    def heterogeneity_index(self, labels: np.ndarray) -> float:
        """Label-distribution heterogeneity in ``[0, 1]``: the mean total
        variation distance between each (non-empty) client's label
        distribution and the population's. 0 for IID splits, approaching 1
        for pathological single-class shards — the one-number scenario
        summary exported as ``fedtpu_sim_heterogeneity_index``."""
        labels = np.asarray(labels)
        num_classes = int(labels.max()) + 1
        global_hist = np.bincount(labels, minlength=num_classes).astype(
            np.float64
        )
        global_p = global_hist / max(global_hist.sum(), 1.0)
        # Vectorized per-client histograms: one bincount over
        # client*num_classes + label for the valid (client, example) pairs.
        owners = np.repeat(np.arange(self.size), self.idx.shape[1]).reshape(
            self.idx.shape
        )
        own_labels = labels[self.idx]
        flat = (owners * num_classes + own_labels)[self.mask]
        hists = np.bincount(
            flat, minlength=self.size * num_classes
        ).reshape(self.size, num_classes).astype(np.float64)
        totals = hists.sum(axis=1)
        nonempty = totals > 0
        if not nonempty.any():
            return 0.0
        p = hists[nonempty] / totals[nonempty, None]
        tv = 0.5 * np.abs(p - global_p[None, :]).sum(axis=1)
        return float(tv.mean())

    def stats(self) -> dict:
        """Snapshot for status boards / artifacts."""
        return {
            "population": self.size,
            "members": int(self._member.sum()),
            "shard_len": int(self.idx.shape[1]),
            "examples": int(self.sizes.sum()),
            "min_shard": int(self.sizes.min()),
            "max_shard": int(self.sizes.max()),
            "never_sampled": self.never_sampled(),
            "availability": self.availability,
            "churn": self.churn,
        }
