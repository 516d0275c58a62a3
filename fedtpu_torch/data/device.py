"""Device-resident data, in fedtpu's two layouts.

The port of ``fedtpu.data.device``. Nothing is copied back to the host per
round.

- ``"presharded"``: the dataset is reorganised once at upload into
  ``[clients, 2*L, features]`` rows (each client's shard cycled to ``L``
  and stored twice), so a round's batches are one contiguous window per
  client at a rotation offset shared by all clients ("shuffle once,
  rotate per round").
- ``"gather"``: the dataset stays ``[N, features]`` and each round gathers
  its batches by index (:func:`round_take_indices`): a fresh permutation
  of every client's shard each round, and no 2x copy of the data. With
  shuffling off the two layouts give the same batches.
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


def round_take_indices(
    idx: torch.Tensor,
    mask: torch.Tensor,
    need: int,
    keys: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-client gather indices for one round: ``take [clients, need]``.

    ``idx``/``mask``: the padded ``[clients, shard_len]`` assignment of
    :mod:`fedtpu_torch.data.partition`. Each client's row cycles through its
    own shard, in shard order without ``keys`` (the reference's unshuffled
    loader), else in the order that sorts the uniform ``keys [clients,
    shard_len]``, padding slots keyed ``+inf`` so that they sort last.
    Shards shorter than ``need`` wrap around; empty shards give index 0
    rows, whose steps the caller masks. The sort is stable, as
    ``jnp.argsort`` is, so ties (the padding's ``+inf`` keys among them)
    keep their slot order and fedtpu's keys give fedtpu's indices.
    """
    lengths = torch.clamp(mask.sum(dim=1), min=1)
    if keys is None:
        ordered = idx
    else:
        keys = torch.where(mask, keys, torch.full_like(keys, float("inf")))
        order = torch.argsort(keys, dim=1, stable=True)
        ordered = torch.take_along_dim(idx, order, dim=1)
    pos = torch.arange(need, device=idx.device)[None, :] % lengths[:, None]
    return torch.take_along_dim(ordered, pos, dim=1)


def round_keys(shape: Tuple[int, ...], seed: int, round_idx: int, device) -> torch.Tensor:
    """This round's uniform sort keys for :func:`round_take_indices`, drawn
    on ``device`` by a generator keyed by ``(seed, round_idx)``, so any
    round's permutation is reproducible without replaying the rounds before
    it. fedtpu draws them from JAX's PRNG instead; parity tests pass
    fedtpu's keys explicitly."""
    g = torch.Generator(device).manual_seed(seed * 1_000_003 + round_idx)
    return torch.rand(shape, generator=g, device=device)


def gather_window(
    images: torch.Tensor,
    labels: torch.Tensor,
    take: torch.Tensor,
    steps: int,
    batch_size: int,
    shape: Optional[Tuple[int, ...]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One round's ``(x [n, steps, batch, *shape], y [n, steps, batch])``
    gathered from the flat ``images [N, F]`` (or ``[N, *shape]``) and
    ``labels [N]`` by ``take [n, steps * batch]``."""
    n = take.shape[0]
    tail = tuple(shape) if images.ndim == 2 else tuple(images.shape[1:])
    x = images[take].reshape((n, steps, batch_size) + tail)
    y = labels[take].reshape(n, steps, batch_size)
    return x, y
