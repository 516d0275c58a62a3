"""SimFederation: the massive-cohort engine.

The port of ``fedtpu.sim.engine.SimFederation``. ``population`` simulated
clients go through the resident engine's fixed-size buffers: each round a
seeded sampler (:mod:`fedtpu_torch.sim.samplers`) draws a cohort of
``FedConfig.num_clients`` from the :class:`~fedtpu_torch.sim.population.
Population`, the cohort's assignment rows replace the engine's ``[cohort,
shard_len]`` ones (:meth:`Federation.set_assignment`, values only), and the
round runs through the engine's unchanged step. Device memory is O(cohort);
the only O(population) objects are host numpy tables.

A device slot is a seat, not a client. When a seat goes to another client
than last round, its momentum and codec residuals (each per-leaf residual
and the flat ``[cohort, P]`` row) go back to zero in one ``where`` over the
seat axis, as a cross-device client starts each appearance fresh; what
persists per client lives in the population. fedtpu also hands such a seat
a fresh threefry key (``fold_in`` of a base key and the client id); the
port has no per-seat key, since every draw of a round (augmentation,
dropout masks) comes from the engine's one generator, so a seat keeps
nothing of its last client there either, and parity tests inject fedtpu's
draws. With ``population == cohort`` under the uniform sampler the seat
map is the identity every round, no seat is reset, and the sim engine is
the resident :class:`Federation` bit for bit.

A block of :meth:`run_on_device` rounds draws one cohort, as fedtpu's
fused block does. fedtpu's ``status_snapshot`` and its ``fedtpu_sim_*``
gauges build on the engine's status board and the metrics registry, which
the port has not yet: :meth:`SimFederation.status_snapshot` raises, and no
gauge is kept.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from fedtpu_torch.config import RoundConfig, not_ported, validate_sim_config
from fedtpu_torch.core.engine import Federation
from fedtpu_torch.core.round import RoundDraws
from fedtpu_torch.data import datasets
from fedtpu_torch.sim import adversary
from fedtpu_torch.sim import scenario as scenario_lib
from fedtpu_torch.sim.population import Population
from fedtpu_torch.sim.samplers import make_sampler


def _default_scenario(cfg: RoundConfig) -> str:
    """The scenario when ``sim.scenario`` is empty: the DataConfig
    partition."""
    if cfg.data.partition == "dirichlet":
        return f"dirichlet:alpha={cfg.data.dirichlet_alpha}"
    return cfg.data.partition  # iid | round_robin


class SimFederation(Federation):
    """A population of clients, a cohort of seats (see the module doc)."""

    def __init__(
        self,
        cfg: RoundConfig,
        seed: int = 0,
        data: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        device=None,
        compressor=None,
        draws: Optional[RoundDraws] = None,
    ):
        validate_sim_config(cfg.fed)
        sim = cfg.fed.sim
        if sim.population <= 0:
            raise ValueError(
                "SimFederation needs FedConfig.sim.population > 0 "
                "(use Federation for the resident path)"
            )
        # The cohort's rows are swapped in as values, which only the gather
        # layout allows (presharded bakes the assignment into its rows).
        if cfg.data.device_layout != "gather":
            cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, device_layout="gather"))
        if data is None:
            images, labels = datasets.load(
                cfg.data.dataset, "train", seed=cfg.data.seed, num=cfg.data.num_examples
            )
            src = datasets.data_source(cfg.data.dataset, "train")
        else:
            images, labels = data
            src = "caller"

        spec = sim.scenario or _default_scenario(cfg)
        pop_idx, pop_mask = scenario_lib.make_partition(
            spec, labels, sim.population, seed=cfg.data.seed, batch_size=cfg.data.batch_size
        )
        # The seeded attackers are population clients: whichever cohort one
        # lands in, it attacks there. label_flip poisons their rows once;
        # the other kinds get a per-seat mask at every cohort install.
        self._pop_attackers = None
        if sim.malicious_fraction > 0:
            plan = adversary.parse_attack(sim.attack)
            self._pop_attackers = adversary.attacker_mask(
                sim.population, sim.malicious_fraction, cfg.data.seed + sim.seed + plan.seed
            )
            if plan.kind == "label_flip":
                labels = adversary.flip_labels(
                    labels, pop_idx, pop_mask, self._pop_attackers, plan.label_offset, cfg.num_classes
                )
        self.population = Population(
            pop_idx, pop_mask, seed=cfg.data.seed + sim.seed,
            availability=sim.availability, churn=sim.churn,
        )
        self.scenario_spec = spec
        self._sampler = make_sampler(
            sim.cohort_sampler, seed=cfg.data.seed + sim.seed,
            prior=None if sim.loss_prior < 0 else sim.loss_prior,
        )
        # Round 0's cohort, drawn before the engine is built over its rows.
        ids0, alive0 = self._sampler.sample(self.population, 0, cfg.fed.num_clients)
        super().__init__(
            cfg, seed=seed, data=(images, labels), device=device, compressor=compressor,
            assignment=self._cohort_assignment(ids0, alive0), draws=draws,
        )
        self._data_source = src
        self.alive = alive0.copy()
        self._cohort_ids = ids0
        self._slot_ids = np.where(alive0, ids0, -1)
        self._cohort_round = 0  # the round the installed cohort was drawn for
        self.population.mark_sampled(ids0[alive0], 0)
        self._refresh_attack_seats(ids0, alive0)
        self.heterogeneity = self.population.heterogeneity_index(labels)

    # ------------------------------------------------------------ installs
    def _cohort_assignment(self, ids: np.ndarray, alive: np.ndarray):
        """The cohort's rows; a padded dead seat gets an empty mask (no
        data, no steps) beside its dead flag."""
        idx, mask, _ = self.population.gather(ids)
        return idx, mask & alive[:, None]

    def _refresh_attack_seats(self, ids: np.ndarray, alive: np.ndarray) -> None:
        """The seated attackers of the installed cohort."""
        if self._pop_attackers is None or self._attack_plan is None:
            return
        seated = self._pop_attackers[ids] & alive
        if self._attack_plan.kind == "label_flip":
            self.attacker_clients = seated  # their rows are already poisoned
            return
        self._attack_seats = seated.astype(np.float32)
        self._attack_seats_dev = torch.tensor(self._attack_seats, device=self.device)

    def _refresh(self, fresh: np.ndarray, ids: np.ndarray) -> None:
        """Reset the momentum and codec residuals of the reassigned seats
        (one ``where`` over the seat axis a tensor) and install the
        population's last-seen losses as the engine's observations."""
        s = self._state
        fresh_t = torch.from_numpy(np.asarray(fresh, bool)).to(self.device)

        def reset(x: torch.Tensor) -> torch.Tensor:
            m = fresh_t.view((-1,) + (1,) * (x.ndim - 1))
            return torch.where(m, torch.zeros_like(x), x)

        comp = s.comp_state
        if isinstance(comp, torch.Tensor):
            comp = reset(comp)
        elif comp:
            comp = {k: reset(v) for k, v in comp.items()}
        self._state = s._replace(
            opt_state={k: reset(v) for k, v in s.opt_state.items()},
            comp_state=comp,
            last_client_loss=torch.from_numpy(
                self.population.last_seen_loss[ids].astype(np.float32)
            ).to(self.device),
        )

    def _install_cohort(self, round_idx: int) -> None:
        """Draw and install the cohort of ``round_idx``; nothing when it is
        installed already."""
        if round_idx == self._cohort_round:
            return
        ids, alive = self._sampler.sample(self.population, round_idx, self.cfg.fed.num_clients)
        self.population.mark_sampled(ids[alive], round_idx)
        slot_ids = np.where(alive, ids, -1)
        fresh = slot_ids != self._slot_ids
        self._cohort_ids, self._cohort_round = ids, round_idx
        self.alive = alive.copy()
        self._refresh_attack_seats(ids, alive)
        if fresh.any():
            idx, mask = self._cohort_assignment(ids, alive)
            _, _, w = self.population.gather(ids)
            self.set_assignment(idx, mask, weights=w * alive)
            self._refresh(fresh, ids)
            self._slot_ids = slot_ids
        # else the same cohort in the same seats: state, assignment and
        # weights are already this cohort's, and stay untouched.

    def _observe_back(self) -> None:
        """The block's loss observations into the population's table
        (finite values only: a seat that never trained keeps its client's
        last observation)."""
        losses = self._state.last_client_loss.cpu().numpy()
        live = self.alive
        self.population.observe_loss(self._cohort_ids[live], losses[live])

    # -------------------------------------------------------------- rounds
    def step(self, batch=None):
        if batch is None:
            self._install_cohort(self._state.round_idx)
        m = super().step(batch)
        if batch is None:
            self._observe_back()
        return m

    def run_on_device(self, num_rounds: int):
        # One cohort a block (see the module doc).
        self._install_cohort(self._state.round_idx)
        m = super().run_on_device(num_rounds)
        self._observe_back()
        return m

    # ---------------------------------------------------------------- eval
    def cohort_label_hist(self) -> np.ndarray:
        """The training-label histogram of the current cohort's live shards."""
        idx, mask, _ = self.population.gather(self._cohort_ids)
        mask = mask & self.alive[:, None]
        labels = np.asarray(self.labels)
        picked = labels[idx[mask]] if mask.any() else np.zeros(0, np.int64)
        return np.bincount(picked, minlength=int(labels.max()) + 1)

    def evaluate_cohort(
        self, images: np.ndarray, labels: np.ndarray, num: Optional[int] = None, seed: int = 0
    ):
        """Loss and accuracy on a test subset whose label mix matches the
        current cohort's training mix (:func:`fedtpu_torch.sim.scenario.
        cohort_eval_indices`)."""
        num = num or min(len(labels), 1000)
        sel = scenario_lib.cohort_eval_indices(
            labels, self.cohort_label_hist(), num, seed=self.cfg.data.seed + seed
        )
        return self.evaluate(np.asarray(images)[sel], np.asarray(labels)[sel])

    def status_snapshot(self) -> dict:
        raise not_ported(
            "SimFederation.status_snapshot and the fedtpu_sim_* gauges (the "
            "engine's status board and the metrics registry)", "slice 8, part 5",
        )
