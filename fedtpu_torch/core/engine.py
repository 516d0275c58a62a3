"""The federated training engine: the port of ``fedtpu.core.engine.Federation``.

Builds the model, data, partition and round step from a
:class:`fedtpu_torch.config.RoundConfig` and drives rounds on one device.
The dataset goes to the device once, in the compute dtype and the layout
``DataConfig.device_layout`` names (:mod:`fedtpu_torch.data.device`):
presharded, where each round takes one window per client, or gather, where
each round gathers its batches by index. A presharded layout that would
store more than twice the balanced footprint falls back to gather with a
warning, as fedtpu's engine does. The engine runs on CUDA unless the caller
names another device: without a card and without ``device="cpu"`` it
raises, it never falls back to the CPU.
"""

from __future__ import annotations

import time
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from fedtpu_torch import models
from fedtpu_torch.config import RoundConfig, resolve_compute_dtype, validate
from fedtpu_torch.core.client import batch_eval_arrays, make_eval_fn
from fedtpu_torch.core.round import (
    FederatedState,
    RoundBatch,
    RoundMetrics,
    init_state,
    make_round_step,
)
from fedtpu_torch.data import datasets, device as device_data, partition
from fedtpu_torch.ops.compression import Compressor, make_compressor


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fedtpu_torch runs on a CUDA device and none is available; pass "
            "device='cpu' explicitly to run the plain CPU path"
        )
    return dev


class Federation:
    """Synchronous FedAvg over simulated clients on one device."""

    def __init__(
        self,
        cfg: RoundConfig,
        seed: int = 0,
        data: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        device=None,
        compressor: Optional[Compressor] = None,
    ):
        """``data``: ``(images, labels)`` instead of loading
        ``cfg.data.dataset``. ``compressor``: a codec instead of the one
        ``cfg.fed.compression`` names."""
        validate(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        shape, n_classes = datasets.dataset_info(cfg.data.dataset)
        if cfg.num_classes != n_classes:
            raise ValueError(
                f"cfg.num_classes={cfg.num_classes} but dataset "
                f"'{cfg.data.dataset}' has {n_classes} classes"
            )
        if compressor is None:
            compressor = make_compressor(cfg.fed)
        self._steps = cfg.steps_per_round * max(1, cfg.fed.local_epochs)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.model = models.create(cfg.model, cfg.num_classes, shape)
        self.model.to(self.device)

        if data is None:
            images, labels = datasets.load(
                cfg.data.dataset, "train", seed=cfg.data.seed, num=cfg.data.num_examples
            )
        else:
            images, labels = data
        self.images, self.labels = images, labels
        n = cfg.fed.num_clients
        if cfg.data.partition == "round_robin":
            idx, mask = partition.round_robin(len(images), n, cfg.data.batch_size)
        else:
            idx, mask = partition.iid(len(images), n, seed=cfg.data.seed)
        self.client_idx, self.client_mask = idx, mask
        self.weights = torch.tensor(partition.shard_sizes(mask), device=self.device)
        self._has_data = torch.tensor(mask.any(axis=1), device=self.device)

        self.state: FederatedState = init_state(self.model, cfg, compressor)
        self._round_step = make_round_step(self.model, cfg, compressor)
        self._shuffle = cfg.data.partition != "round_robin"
        self.layout = cfg.data.device_layout
        footprint = 2 * n * idx.shape[1]
        if self.layout == "presharded" and footprint > 4 * len(images):
            # clients * 2L rows, L the longest shard: a skewed partition
            # would store far more than the balanced case's twice the data.
            warnings.warn(
                f"device_layout='presharded' would store "
                f"{footprint / len(images):.1f}x the dataset (skewed "
                f"partition: max shard {idx.shape[1]} of {len(images)} "
                f"examples x {n} clients); falling back to 'gather'",
                stacklevel=2,
            )
            self.layout = "gather"
        self._device_data = None
        self._generator = torch.Generator(self.device).manual_seed(seed)
        self._evaluate = make_eval_fn(self.model)
        self.alive = np.ones((n,), bool)
        self._alive_dev = None  # (mask bytes, device tensor)
        self.history = []

    # ------------------------------------------------------------- data
    def _ensure_device_data(self):
        """``(images, labels)`` on the device in the compute dtype:
        presharded ``[clients, 2L, F]`` rows, or the flat ``[N, F]`` set
        with the assignment ``(idx, mask)`` for the gather layout."""
        if self._device_data is None:
            store = getattr(torch, resolve_compute_dtype(self.cfg))
            if self.layout == "presharded":
                xs, ys = device_data.preshard_arrays(
                    self.images, self.labels, self.client_idx, self.client_mask
                )
                assign = ()
            else:
                xs = np.asarray(self.images, np.float32).reshape(len(self.images), -1)
                ys = np.asarray(self.labels, np.int32)
                assign = (
                    torch.from_numpy(np.asarray(self.client_idx, np.int64)).to(self.device),
                    torch.from_numpy(self.client_mask).to(self.device),
                )
            self._device_data = (
                torch.from_numpy(xs).to(self.device).to(store),
                torch.from_numpy(ys).to(self.device),
            ) + assign
        return self._device_data

    def _alive_for_round(self, round_idx: int) -> np.ndarray:
        """Alive clients, subsampled to ``participation_fraction`` with the
        same seeded numpy draw as fedtpu."""
        alive = self.alive.copy()
        frac = self.cfg.fed.participation_fraction
        if frac < 1.0:
            rng = np.random.default_rng(self.cfg.data.seed * 7919 + round_idx)
            live = np.flatnonzero(alive)
            k = max(1, int(round(frac * len(live))))
            keep = rng.choice(live, size=k, replace=False)
            alive = np.zeros_like(alive)
            alive[keep] = True
        return alive

    def _alive_tensor(self, round_idx: int) -> torch.Tensor:
        # Re-upload only when the mask changes: a host-to-device copy from
        # pageable memory waits for the device.
        alive = self._alive_for_round(round_idx)
        key = alive.tobytes()
        if self._alive_dev is None or self._alive_dev[0] != key:
            self._alive_dev = (key, torch.tensor(alive, device=self.device))
        return self._alive_dev[1]

    def device_batch(
        self,
        round_idx: int,
        offset: Optional[int] = None,
        keys: Optional[torch.Tensor] = None,
    ) -> RoundBatch:
        """Round ``round_idx``'s batch from the device-resident data.
        ``offset`` overrides the presharded layout's rotation offset,
        ``keys`` the gather layout's ``[clients, shard_len]`` sort keys."""
        data = self._ensure_device_data()
        shape, batch = tuple(self.images.shape[1:]), self.cfg.data.batch_size
        if self.layout == "presharded":
            images, labels = data
            if offset is None:
                offset = device_data.round_offset(
                    labels.shape[1] // 2, self._shuffle, self.cfg.data.seed, round_idx
                )
            x, y = device_data.presharded_window(
                images, labels, offset, self._steps, batch, shape
            )
        else:
            images, labels, idx, mask = data
            if keys is None and self._shuffle:
                keys = device_data.round_keys(
                    tuple(idx.shape), self.cfg.data.seed, round_idx, self.device
                )
            take = device_data.round_take_indices(
                idx, mask, self._steps * batch,
                None if keys is None else keys.to(self.device),
            )
            x, y = device_data.gather_window(images, labels, take, self._steps, batch, shape)
        n = self.cfg.fed.num_clients
        return RoundBatch(
            x=x,
            y=y,
            step_mask=self._has_data[:, None].expand(n, self._steps),
            weights=self.weights,
            alive=self._alive_tensor(round_idx),
        )

    # ----------------------------------------------------------- rounds
    def step(self, batch: Optional[RoundBatch] = None) -> RoundMetrics:
        """One round, on ``batch`` or on the device-resident data."""
        if batch is None:
            batch = self.device_batch(self.state.round_idx)
        self.state, metrics = self._round_step(self.state, batch, self._generator)
        return metrics

    def run_on_device(self, num_rounds: int) -> RoundMetrics:
        """``num_rounds`` rounds with no host sync between them; metrics
        come back stacked ``[num_rounds, ...]`` on the device."""
        if num_rounds < 1:
            raise ValueError(f"num_rounds must be >= 1, got {num_rounds}")
        per_round = [self.step() for _ in range(num_rounds)]
        return RoundMetrics(*(torch.stack(f) for f in zip(*per_round)))

    def run(self, num_rounds: Optional[int] = None) -> RoundMetrics:
        """Rounds with a per-round record in ``self.history`` (reading the
        metrics syncs with the device each round)."""
        if num_rounds is None:
            num_rounds = self.cfg.fed.num_rounds
        metrics = None
        for _ in range(num_rounds):
            t0 = time.perf_counter()
            r = self.state.round_idx
            metrics = self.step()
            self.history.append({
                "round": r,
                "loss": float(metrics.loss),
                "acc": float(metrics.accuracy),
                "active": float(metrics.num_active),
                "round_s": time.perf_counter() - t0,
            })
        return metrics

    # ------------------------------------------------------------- eval
    def evaluate(self, images: np.ndarray, labels: np.ndarray) -> Tuple[float, float]:
        """Loss and accuracy of the global model on ``(images, labels)``."""
        xs, ys = batch_eval_arrays(images, labels, self.cfg.data.eval_batch_size)
        loss, acc = self._evaluate(
            self.state.params,
            self.state.batch_stats,
            torch.from_numpy(np.asarray(xs, np.float32)).to(self.device),
            torch.from_numpy(np.asarray(ys, np.int64)).to(self.device),
        )
        return float(loss), float(acc)

    def set_alive(self, client: int, alive: bool) -> None:
        """Mark a simulated client dead or alive."""
        self.alive[client] = alive
