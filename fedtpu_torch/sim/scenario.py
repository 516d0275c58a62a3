"""Scenario specs: composable non-IID population partitions.

The port's own copy of ``fedtpu.sim.scenario``, numpy only, each draw
fedtpu's (the same generator calls in the same order), so a spec, labels
and seed give the same partition in both packages. A spec is
``base[+modifier]...``, each stage ``name[:key=value[,key=value]...]``:

    "iid"
    "dirichlet:alpha=0.1"
    "pathological:shards=2"
    "label_skew:classes=3"
    "quantity_skew:power=1.5"
    "dirichlet:alpha=0.5+quantity_skew:power=1.2"

A base makes the padded ``[population, shard_len]`` assignment ``(idx,
mask)`` (``iid``, ``dirichlet`` and ``round_robin`` are the partitioners of
:mod:`fedtpu_torch.data.partition`); a modifier rewrites one.
``quantity_skew`` is both: as a base it carves a permutation of the
examples into power-law shards, as a modifier it subsamples each client's
shard to a power-law size, keeping its label mix.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from fedtpu_torch.data import partition
from fedtpu_torch.data.partition import _owner_to_shards

_BASES = ("iid", "dirichlet", "pathological", "label_skew", "quantity_skew",
          "round_robin")
_MODIFIERS = ("quantity_skew",)


def parse_scenario(spec: str) -> List[Tuple[str, Dict[str, float]]]:
    """``"a:k=v+b:k=v"`` -> ``[("a", {k: v}), ("b", {k: v})]`` (validated)."""
    stages: List[Tuple[str, Dict[str, float]]] = []
    for i, stage in enumerate(spec.strip().split("+")):
        stage = stage.strip()
        if not stage:
            raise ValueError(f"empty stage in scenario spec {spec!r}")
        name, _, argstr = stage.partition(":")
        name = name.strip()
        allowed = _BASES if i == 0 else _MODIFIERS
        if name not in allowed:
            raise ValueError(
                f"unknown scenario {'base' if i == 0 else 'modifier'} "
                f"{name!r} in {spec!r}; have "
                + " | ".join(allowed)
            )
        params: Dict[str, float] = {}
        if argstr:
            for kv in argstr.split(","):
                k, _, v = kv.partition("=")
                if not _ or not k.strip():
                    raise ValueError(
                        f"malformed option {kv!r} in scenario {spec!r} "
                        "(want key=value)"
                    )
                params[k.strip()] = float(v)
        stages.append((name, params))
    return stages


# ------------------------------------------------------------------ bases
def pathological(
    labels: np.ndarray,
    num_clients: int,
    shards_per_client: int = 2,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """The classic FedAvg "pathological non-IID" split: examples sorted by
    label, carved into ``num_clients * shards_per_client`` contiguous
    shards, each client dealt ``shards_per_client`` shards at random — so a
    client sees ~``shards_per_client`` classes (a shard can straddle one
    class boundary)."""
    labels = np.asarray(labels)
    if shards_per_client < 1:
        raise ValueError(f"shards_per_client must be >= 1, got {shards_per_client}")
    rng = np.random.default_rng(seed)
    by_label = np.argsort(labels, kind="stable")
    n_shards = num_clients * shards_per_client
    if n_shards > len(labels):
        raise ValueError(
            f"{n_shards} shards > {len(labels)} examples; lower "
            "shards_per_client or the population"
        )
    shard_of_pos = np.minimum(
        (np.arange(len(labels)) * n_shards) // len(labels), n_shards - 1
    )
    deal = rng.permutation(n_shards)  # shard s -> client deal[s] // spc
    owner = np.empty(len(labels), np.int64)
    owner[by_label] = deal[shard_of_pos] // shards_per_client
    return _owner_to_shards(owner, num_clients)


def label_skew(
    labels: np.ndarray,
    num_clients: int,
    classes_per_client: int = 2,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Each client holds examples from exactly ``classes_per_client``
    classes. Class sets come from a shuffled class deck (so every class has
    at least one holder whenever ``num_clients * classes_per_client >=
    num_classes``); each class's examples split evenly among its holders."""
    labels = np.asarray(labels)
    num_classes = int(labels.max()) + 1
    if not 1 <= classes_per_client <= num_classes:
        raise ValueError(
            f"classes_per_client must be in [1, {num_classes}], "
            f"got {classes_per_client}"
        )
    rng = np.random.default_rng(seed)
    # Deck of class ids, reshuffled per cycle, dealt classes_per_client per
    # client; a client re-draws duplicates from the running deck tail.
    need = num_clients * classes_per_client
    deck: List[int] = []
    while len(deck) < need + num_classes:
        deck.extend(rng.permutation(num_classes).tolist())
    holders: List[List[int]] = [[] for _ in range(num_classes)]
    pos = 0
    for c in range(num_clients):
        mine: List[int] = []
        while len(mine) < classes_per_client:
            k = deck[pos]
            pos += 1
            if k not in mine:
                mine.append(k)
        for k in mine:
            holders[k].append(c)
    owner = np.empty(len(labels), np.int64)
    for k in range(num_classes):
        idx_k = np.flatnonzero(labels == k)
        rng.shuffle(idx_k)
        who = holders[k] or [int(rng.integers(num_clients))]
        for j, part in enumerate(np.array_split(idx_k, len(who))):
            owner[part] = who[j]
    return _owner_to_shards(owner, num_clients)


def _power_profile(
    num_clients: int, power: float, rng: np.random.Generator
) -> np.ndarray:
    """Power-law size profile in (0, 1], randomly assigned to clients:
    client with rank r gets ``(r+1)^-power`` (rank 0 = the heavy head)."""
    if power < 0:
        raise ValueError(f"power must be >= 0, got {power}")
    prof = (np.arange(1, num_clients + 1, dtype=np.float64)) ** (-power)
    return prof[rng.permutation(num_clients)]


def quantity_skew(
    num_examples: int,
    num_clients: int,
    power: float = 1.5,
    min_size: int = 1,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Quantity-skew base: a random example permutation carved into
    power-law-sized shards — client sizes follow ``rank^-power`` (Zipf-ish
    heavy head, long tail of tiny clients), every client keeping at least
    ``min_size`` examples."""
    if num_clients * min_size > num_examples:
        raise ValueError(
            f"min_size={min_size} x {num_clients} clients > "
            f"{num_examples} examples"
        )
    rng = np.random.default_rng(seed)
    prof = _power_profile(num_clients, power, rng)
    spare = num_examples - num_clients * min_size
    extra = np.floor(prof / prof.sum() * spare).astype(np.int64)
    sizes = min_size + extra
    # Distribute the rounding remainder to the largest shares.
    for c in np.argsort(-prof)[: num_examples - int(sizes.sum())]:
        sizes[c] += 1
    perm = rng.permutation(num_examples)
    owner = np.empty(num_examples, np.int64)
    owner[perm] = np.repeat(np.arange(num_clients), sizes)
    return _owner_to_shards(owner, num_clients)


def apply_quantity_skew(
    idx: np.ndarray,
    mask: np.ndarray,
    power: float = 1.5,
    min_size: int = 1,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Quantity-skew modifier: keep each client's label mixture but
    subsample its shard to the power-law profile (client at rank r keeps
    ``~rank^-power`` of its examples, floored at ``min_size``) — composes
    label skew x quantity skew."""
    idx = np.asarray(idx)
    mask = np.asarray(mask, bool)
    rng = np.random.default_rng(seed)
    prof = _power_profile(idx.shape[0], power, rng)
    sizes = mask.sum(axis=1)
    keep = np.maximum(
        np.minimum(sizes, min_size), np.round(sizes * prof).astype(np.int64)
    )
    shards = []
    for c in range(idx.shape[0]):
        own = idx[c][mask[c]]
        if len(own) > keep[c]:
            own = np.sort(rng.choice(own, size=int(keep[c]), replace=False))
        shards.append(own.astype(np.int32))
    return partition._pad_shards(shards)


# ------------------------------------------------------------ entry point
def make_partition(
    spec: str,
    labels: np.ndarray,
    num_clients: int,
    seed: int = 0,
    batch_size: int = 128,
) -> Tuple[np.ndarray, np.ndarray]:
    """Build a population assignment from a scenario spec (see module
    docstring). ``batch_size`` only feeds the ``round_robin`` base."""
    labels = np.asarray(labels)
    stages = parse_scenario(spec)
    name, p = stages[0]
    if name == "iid":
        idx, mask = partition.iid(len(labels), num_clients, seed=seed)
    elif name == "dirichlet":
        idx, mask = partition.dirichlet(
            labels, num_clients, alpha=p.get("alpha", 0.5), seed=seed,
            min_size=int(p.get("min_size", 1)),
        )
    elif name == "pathological":
        idx, mask = pathological(
            labels, num_clients, shards_per_client=int(p.get("shards", 2)),
            seed=seed,
        )
    elif name == "label_skew":
        idx, mask = label_skew(
            labels, num_clients, classes_per_client=int(p.get("classes", 2)),
            seed=seed,
        )
    elif name == "quantity_skew":
        idx, mask = quantity_skew(
            len(labels), num_clients, power=p.get("power", 1.5),
            min_size=int(p.get("min", 1)), seed=seed,
        )
    else:  # round_robin — validated by parse_scenario
        idx, mask = partition.round_robin(len(labels), num_clients, batch_size)
    for name, p in stages[1:]:
        # parse_scenario restricts modifiers to quantity_skew today.
        idx, mask = apply_quantity_skew(
            idx, mask, power=p.get("power", 1.5),
            min_size=int(p.get("min", 1)), seed=seed + 1,
        )
    return idx, mask


# ------------------------------------------------------- per-cohort eval
def cohort_eval_indices(
    eval_labels: np.ndarray,
    label_hist: np.ndarray,
    num: int,
    seed: int = 0,
) -> np.ndarray:
    """Eval-set indices whose label mixture matches a cohort's.

    Under label/quantity skew the global test set no longer reflects what
    any given cohort was trained on; this draws ``num`` test examples (per
    class, without replacement, capped by per-class supply) proportional to
    ``label_hist`` — the cohort's training-label histogram — so
    "per-cohort eval" measures the model on the slice of the task the
    cohort actually represents.
    """
    eval_labels = np.asarray(eval_labels)
    hist = np.asarray(label_hist, np.float64)
    if hist.sum() <= 0:
        raise ValueError("cohort label histogram is empty")
    rng = np.random.default_rng(seed)
    want = np.floor(hist / hist.sum() * num).astype(np.int64)
    # Remainder to the largest classes.
    for k in np.argsort(-hist)[: num - int(want.sum())]:
        want[k] += 1
    picks = []
    for k in np.flatnonzero(want):
        pool = np.flatnonzero(eval_labels == k)
        if len(pool) == 0:
            continue
        take = min(int(want[k]), len(pool))
        picks.append(rng.choice(pool, size=take, replace=False))
    if not picks:
        raise ValueError("eval set holds none of the cohort's classes")
    return np.sort(np.concatenate(picks))
