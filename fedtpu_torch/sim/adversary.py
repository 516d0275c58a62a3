"""Seeded adversarial clients: the port's own copy of
``fedtpu.sim.adversary``.

Attack kinds (the ``SimConfig.attack`` spec, ``kind[:key=val,...]``):

- ``sign_flip``: submit the negated honest delta;
- ``scale:factor=F``: submit the honest delta times ``F`` (``F`` may be
  negative);
- ``noise:std=S``: add Gaussian noise of std ``S`` to the honest delta;
- ``label_flip:offset=K``: shift the attacker's training labels by ``K``
  classes (mod the class count), once, when the engine is built.

Shared options: ``p`` (a round's fire probability), ``rounds`` (``lo-hi``,
half open), ``collude=1`` (one shared fire draw and, for ``noise``, one
shared noise vector for the whole malicious set) and ``seed``.

Who attacks is a seeded numpy draw, bit-equal to fedtpu's. When an attack
fires is a function of ``(seed, round)``: fedtpu draws its Bernoulli
uniforms from JAX's PRNG, which torch cannot reproduce, so the port draws
them on the host from a ``torch.Generator`` seeded from ``(plan seed ^
0xAD5A17, round)`` (the same on every device, and the host mirror
:func:`fires_this_round` reads the same draws) and takes them injected for
parity checks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

ATTACK_KINDS = ("sign_flip", "scale", "noise", "label_flip")
FIRE_SEED = 0xAD5A17
NOISE_SEED = 0x4015E5


@dataclasses.dataclass(frozen=True)
class AttackPlan:
    """A parsed attack spec."""

    kind: str
    p: float = 1.0
    factor: float = 10.0
    std: float = 1.0
    label_offset: int = 1
    collude: bool = False
    rounds: Optional[Tuple[int, int]] = None
    seed: int = 0

    @property
    def coef(self) -> float:
        """The factor on the honest delta."""
        if self.kind == "sign_flip":
            return -1.0
        if self.kind == "scale":
            return self.factor
        return 1.0

    def validate(self) -> "AttackPlan":
        if self.kind not in ATTACK_KINDS:
            raise ValueError(
                f"unknown attack kind {self.kind!r}; have {'|'.join(ATTACK_KINDS)}"
            )
        if not 0.0 < self.p <= 1.0:
            raise ValueError(f"attack p must be in (0, 1], got {self.p}")
        if self.std < 0:
            raise ValueError(f"attack std must be >= 0, got {self.std}")
        if self.kind == "scale" and self.factor == 0.0:
            raise ValueError("attack scale factor must be nonzero")
        if self.kind == "label_flip" and self.label_offset == 0:
            raise ValueError("label_flip offset must be nonzero")
        return self


def parse_attack(spec: str) -> AttackPlan:
    """``kind[:key=val,...]`` -> a validated :class:`AttackPlan`, e.g.
    ``sign_flip``, ``scale:factor=20,p=0.5``, ``noise:std=2.0,collude=1``,
    ``label_flip:offset=3,rounds=10-50``."""
    spec = (spec or "").strip()
    if not spec:
        raise ValueError("empty attack spec")
    head, _, opt_str = spec.partition(":")
    fields: dict = {"kind": head.strip()}
    for opt in filter(None, (o.strip() for o in opt_str.split(","))):
        key, eq, val = opt.partition("=")
        if not eq:
            raise ValueError(f"attack option {opt!r} is not key=value")
        key, val = key.strip(), val.strip()
        if key == "p":
            fields["p"] = float(val)
        elif key == "factor":
            fields["factor"] = float(val)
        elif key == "std":
            fields["std"] = float(val)
        elif key == "offset":
            fields["label_offset"] = int(val)
        elif key == "collude":
            fields["collude"] = val not in ("0", "false", "False", "")
        elif key == "seed":
            fields["seed"] = int(val)
        elif key == "rounds":
            lo, dash, hi = val.partition("-")
            fields["rounds"] = (int(lo), int(hi)) if dash else (int(lo), int(lo) + 1)
        else:
            raise ValueError(
                f"unknown attack option {key!r} in {spec!r}; have "
                "p|factor|std|offset|collude|rounds|seed"
            )
    return AttackPlan(**fields).validate()


def choose_attackers(population: int, fraction: float, seed: int) -> np.ndarray:
    """``floor(fraction * population)`` sorted client ids drawn without
    replacement, a function of ``(population, fraction, seed)`` only."""
    k = int(np.floor(fraction * population))
    if k <= 0:
        return np.zeros((0,), np.int64)
    rng = np.random.default_rng(seed * 9973 + 0xBAD)
    return np.sort(rng.choice(population, size=k, replace=False)).astype(np.int64)


def attacker_mask(population: int, fraction: float, seed: int) -> np.ndarray:
    """``[population]`` bool, True for a malicious client."""
    mask = np.zeros((population,), bool)
    mask[choose_attackers(population, fraction, seed)] = True
    return mask


def flip_labels(
    labels: np.ndarray,
    idx: np.ndarray,
    mask: np.ndarray,
    attackers: np.ndarray,
    offset: int,
    num_classes: int,
) -> np.ndarray:
    """A copy of ``labels`` with the attackers' examples (their rows of the
    ``[clients, shard_len]`` partition) shifted by ``offset`` classes."""
    out = np.asarray(labels).copy()
    for c in np.flatnonzero(np.asarray(attackers, bool)):
        own = idx[c][mask[c]]
        if len(own):
            out[own] = (out[own] + offset) % num_classes
    return out


def fire_uniforms(plan: AttackPlan, round_idx: int, n: int) -> torch.Tensor:
    """The round's Bernoulli uniforms on the CPU: ``[n]``, or ``[]`` in
    colluding mode (one draw for the whole malicious set)."""
    g = torch.Generator().manual_seed(((plan.seed ^ FIRE_SEED) << 32) | (round_idx & 0xFFFFFFFF))
    return torch.rand(() if plan.collude else (n,), generator=g)


def attack_fire_mask(
    plan: AttackPlan,
    attack_seats: torch.Tensor,
    round_idx: int,
    uniforms: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``[n]`` bool on the seats' device: an attacker seat, inside the round
    window, and (for ``p < 1``) its uniform below ``p``. ``uniforms``
    replaces :func:`fire_uniforms`' draws."""
    fire = attack_seats.float() > 0
    if plan.rounds is not None:
        lo, hi = plan.rounds
        fire = fire & bool(lo <= round_idx < hi)
    if plan.p < 1.0:
        if uniforms is None:
            uniforms = fire_uniforms(plan, round_idx, fire.shape[0])
        fire = fire & (uniforms.to(fire.device) < plan.p)
    return fire


def fires_this_round(plan: AttackPlan, attack_seats: np.ndarray, round_idx: int) -> np.ndarray:
    """Host mirror of :func:`attack_fire_mask` (the same draws), for the
    per-round record without a read from the device."""
    seats = torch.from_numpy(np.asarray(attack_seats, np.float32))
    return attack_fire_mask(plan, seats, round_idx).numpy()
