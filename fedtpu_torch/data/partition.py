"""Client data partitioners, numpy only.

Same assignment rules as ``fedtpu.data.partition`` (round_robin, iid and
Dirichlet label skew), and its host batch builder: a dense
``[num_clients, shard_len]`` matrix of example indices plus a validity mask,
so every downstream shape is static.
"""

from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np


def _pad_shards(shards, pad_value=0) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a list of 1-D index arrays to equal length; return (idx, mask)."""
    n = max(len(s) for s in shards)
    idx = np.full((len(shards), n), pad_value, dtype=np.int32)
    mask = np.zeros((len(shards), n), dtype=bool)
    for c, s in enumerate(shards):
        idx[c, : len(s)] = s
        mask[c, : len(s)] = True
    return idx, mask


def round_robin(
    num_examples: int, num_clients: int, batch_size: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Batch ``i`` of the full batches goes to client ``(i + 1) % num_clients``
    (the reference's pre-increment shard rule)."""
    num_batches = num_examples // batch_size
    shards = [[] for _ in range(num_clients)]
    for i in range(num_batches):
        r = (i + 1) % num_clients
        shards[r].extend(range(i * batch_size, (i + 1) * batch_size))
    return _pad_shards([np.asarray(s, dtype=np.int32) for s in shards])


def iid(
    num_examples: int, num_clients: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform random equal split."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_examples).astype(np.int32)
    shards = np.array_split(perm, num_clients)
    return _pad_shards(shards)


def _owner_to_shards(owner: np.ndarray, num_clients: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(idx, mask)`` from an ``owner[example] = client`` map: each
    client's row holds its example ids in ascending order."""
    owner = np.asarray(owner, np.int64)
    counts = np.bincount(owner, minlength=num_clients)
    order = np.argsort(owner, kind="stable")
    L = max(int(counts.max()), 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(owner)) - np.repeat(starts, counts)
    idx = np.zeros((num_clients, L), dtype=np.int32)
    mask = np.zeros((num_clients, L), dtype=bool)
    idx[owner[order], pos] = order.astype(np.int32)
    mask[owner[order], pos] = True
    return idx, mask


def dirichlet(
    labels: np.ndarray,
    num_clients: int,
    alpha: float = 0.5,
    seed: int = 0,
    min_size: int = 1,
    min_size_action: str = "topup",
) -> Tuple[np.ndarray, np.ndarray]:
    """Label skew: per class, the clients' shares ~ Dirichlet(alpha), drawn
    as fedtpu draws them (the same generator calls in the same order), and
    redrawn up to 100 times until every client holds ``min_size``
    examples. A deficit left after that raises (``min_size_action=
    'raise'``) or is topped up with a warning (``'topup'``): each short
    client takes the highest example id of the largest client until it has
    ``min_size``."""
    if min_size_action not in ("topup", "raise"):
        raise ValueError(
            f"unknown min_size_action {min_size_action!r}; have topup | raise"
        )
    labels = np.asarray(labels)
    num_classes = int(labels.max()) + 1
    rng = np.random.default_rng(seed)
    owner = np.empty(len(labels), np.int64)
    for _ in range(100):
        for k in range(num_classes):
            idx_k = np.where(labels == k)[0]
            rng.shuffle(idx_k)
            props = rng.dirichlet([alpha] * num_clients)
            cuts = (np.cumsum(props) * len(idx_k)).astype(int)[:-1]
            # Client c takes the positions in [cuts[c-1], cuts[c]).
            owner[idx_k] = np.searchsorted(cuts, np.arange(len(idx_k)), side="right")
        counts = np.bincount(owner, minlength=num_clients)
        if counts.min() >= min_size:
            break
    counts = np.bincount(owner, minlength=num_clients)
    if counts.min() < min_size:
        deficit = int(np.sum(np.maximum(min_size - counts, 0)))
        if min_size_action == "raise":
            raise ValueError(
                f"dirichlet(alpha={alpha}) could not satisfy "
                f"min_size={min_size} after 100 resamples "
                f"({int((counts < min_size).sum())} clients short by "
                f"{deficit} examples total)"
            )
        warnings.warn(
            f"dirichlet(alpha={alpha}) left {int((counts < min_size).sum())} "
            f"client(s) below min_size={min_size} after 100 resamples; "
            f"deterministically topping up {deficit} example(s) from the "
            "largest client(s)",
            stacklevel=2,
        )
        for c in np.flatnonzero(counts < min_size):
            while counts[c] < min_size:
                donor = int(np.argmax(counts))
                moved = np.flatnonzero(owner == donor)[-1]
                owner[moved] = c
                counts[donor] -= 1
                counts[c] += 1
    return _owner_to_shards(owner, num_clients)


def make_client_batches(
    images: np.ndarray,
    labels: np.ndarray,
    idx: np.ndarray,
    mask: np.ndarray,
    batch_size: int,
    steps_per_round: int,
    seed: int = 0,
    shuffle: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One round's host arrays ``(x [clients, steps, batch, ...], y
    [clients, steps, batch], step_mask [clients, steps])``: each client's
    shard, permuted by a numpy generator seeded ``seed`` when ``shuffle``,
    tiled to ``steps * batch`` examples; a client with no data gets zeros
    and masked steps."""
    num_clients = idx.shape[0]
    need = steps_per_round * batch_size
    xs, ys, ms = [], [], []
    rng = np.random.default_rng(seed)
    for c in range(num_clients):
        own = idx[c][mask[c]]
        if shuffle and len(own):
            own = rng.permutation(own)
        if len(own) == 0:
            xs.append(np.zeros((need,) + images.shape[1:], images.dtype))
            ys.append(np.zeros((need,), labels.dtype))
            ms.append(np.zeros((steps_per_round,), bool))
            continue
        reps = int(np.ceil(need / len(own)))
        take = np.tile(own, reps)[:need]
        xs.append(images[take])
        ys.append(labels[take])
        ms.append(np.ones((steps_per_round,), bool))
    x = np.stack(xs).reshape((num_clients, steps_per_round, batch_size) + images.shape[1:])
    y = np.stack(ys).reshape((num_clients, steps_per_round, batch_size))
    return x, y, np.stack(ms)


def shard_sizes(mask: np.ndarray) -> np.ndarray:
    """Per-client example counts (the weights for weighted FedAvg)."""
    return mask.sum(axis=1).astype(np.float32)
