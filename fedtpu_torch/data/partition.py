"""Client data partitioners, numpy only.

Same assignment rules as ``fedtpu.data.partition``: a dense
``[num_clients, shard_len]`` matrix of example indices plus a validity mask,
so every downstream shape is static.
"""

from __future__ import annotations

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


def shard_sizes(mask: np.ndarray) -> np.ndarray:
    """Per-client example counts (the weights for weighted FedAvg)."""
    return mask.sum(axis=1).astype(np.float32)
