"""Device-resident data in the presharded layout.

The port of the presharded half of ``fedtpu.data.device``: the dataset is
reorganised once at upload into ``[clients, 2*L, features]`` rows (each
client's shard cycled to ``L`` and stored twice), so a round's batches are
one contiguous window per client at a rotation offset shared by all
clients. Nothing is copied back to the host per round.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def preshard_arrays(images, labels, idx, mask) -> Tuple[np.ndarray, np.ndarray]:
    """``(xs_c [clients, 2L, features] f32, ys_c [clients, 2L] int32)``
    from the ``[clients, L]`` assignment; clients with empty shards get
    zero rows (their steps are masked by the caller)."""
    images = np.asarray(images, np.float32).reshape(len(images), -1)
    labels = np.asarray(labels, np.int32)
    idx = np.asarray(idx)
    mask = np.asarray(mask, bool)
    n, L = idx.shape
    xs = np.zeros((n, L, images.shape[1]), np.float32)
    ys = np.zeros((n, L), np.int32)
    for c in range(n):
        own = idx[c][mask[c]]
        if len(own):
            cyc = own[np.arange(L) % len(own)]
            xs[c] = images[cyc]
            ys[c] = labels[cyc]
    return (
        np.concatenate([xs, xs], axis=1),
        np.concatenate([ys, ys], axis=1),
    )


def round_offset(shard_len: int, shuffle: bool, seed: int, round_idx: int) -> int:
    """This round's rotation offset in ``[0, shard_len)``: 0 unshuffled
    (the shard head, as fedtpu's ``_round_offset``), else a draw from a
    host generator keyed by ``(seed, round_idx)``, so any round's offset is
    reproducible without replaying the rounds before it. fedtpu draws it
    from JAX's PRNG instead; parity tests pass fedtpu's offset explicitly."""
    if not shuffle:
        return 0
    g = torch.Generator().manual_seed(seed * 1_000_003 + round_idx)
    return int(torch.randint(0, shard_len, (), generator=g))


def presharded_window(
    images: torch.Tensor,
    labels: torch.Tensor,
    off: int,
    steps: int,
    batch_size: int,
    shape: Optional[Tuple[int, ...]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One round's ``(x [n, steps, batch, *shape], y [n, steps, batch])``
    from the presharded ``images [n, 2L, F]`` / ``labels [n, 2L]`` at
    rotation offset ``off``: a contiguous window when ``steps * batch <= L``,
    else the epoch window tiled to length (several local epochs)."""
    n, L2 = labels.shape
    L = L2 // 2
    if not 0 <= off < L:
        raise ValueError(f"rotation offset {off} outside [0, {L})")
    need = steps * batch_size
    if need <= L:
        x = images[:, off:off + need]
        y = labels[:, off:off + need]
    else:
        reps = -(-need // L)
        x = images[:, off:off + L].repeat((1, reps) + (1,) * (images.ndim - 2))
        y = labels[:, off:off + L].repeat(1, reps)
        x, y = x[:, :need], y[:, :need]
    tail = tuple(shape) if images.ndim == 3 else tuple(images.shape[2:])
    return x.reshape((n, steps, batch_size) + tail), y.reshape(n, steps, batch_size)
