"""Standalone training of one model on the whole dataset: the port of
``fedtpu.core.solo``, the reference's single-node path (``src/main.py``:
train, test with best-accuracy checkpointing, ``--resume``).

One model, SGD with torch semantics (:mod:`fedtpu_torch.core.optim`, the
federated clients' update, the learning rate by epoch), cross-entropy in
f32 and BatchNorm's statistics carried from step to step; each epoch is
``n // batch`` steps over a shuffled order, each test epoch saves a
checkpoint when the test accuracy improves. The checkpoint is fedtpu's
file (``wire.encode(..., compress=True)`` of ``params``, ``batch_stats``,
``momentum``, ``epoch`` and ``best_acc`` in flax names): it holds no
generator state, so each package resumes from the other's file. fedtpu
draws the epoch's order, the crops and a model's dropout from threefry
keys, which torch cannot reproduce: the port draws them from its own
generator, and an epoch takes fedtpu's order injected for a parity check.
Runs on CUDA unless ``device`` names another.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from fedtpu_torch import models
from fedtpu_torch.config import RoundConfig, not_ported
from fedtpu_torch.convert import from_flax, to_flax
from fedtpu_torch.core import optim
from fedtpu_torch.core.client import batch_eval_arrays, make_eval_fn
from fedtpu_torch.data import datasets
from fedtpu_torch.data.augment import augment_batch
from fedtpu_torch.models.common import draw_masks, mask_specs
from fedtpu_torch.ops.losses import softmax_ce_int_labels
from fedtpu_torch.transport import wire
from fedtpu_torch.utils.metrics import MetricsLogger

Tree = Dict[str, torch.Tensor]


class SoloTrainer:
    """Single-model SGD trainer with best-accuracy checkpointing.

    >>> t = SoloTrainer(cfg, checkpoint_path="checkpoint/model.fckpt")
    >>> for epoch in range(200):
    ...     t.train_epoch()
    ...     t.test_epoch()   # saves when best
    """

    def __init__(
        self,
        cfg: RoundConfig,
        seed: int = 0,
        checkpoint_path: Optional[str] = None,
        resume: bool = False,
        mesh=None,
        device=None,
        data: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        test_data: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    ):
        """``data`` / ``test_data``: ``(images, labels)`` instead of loading
        ``cfg.data.dataset``'s train / test split (several trainers in one
        process can share one copy), as :class:`~fedtpu_torch.transport.
        trainer.LocalTrainer` takes them."""
        from fedtpu_torch.core.engine import resolve_device

        if mesh is not None:
            raise not_ported("SoloTrainer(mesh=...), batch data parallelism over a device mesh",
                             "slice 8, part 6")
        self.cfg = cfg
        self.device = resolve_device(device)
        shape, _ = datasets.dataset_info(cfg.data.dataset)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.model = models.create(cfg.model, cfg.num_classes, shape, remat=cfg.remat)
        self.model.to(self.device)
        if data is None:
            data = datasets.load(cfg.data.dataset, "train", seed=cfg.data.seed, num=cfg.data.num_examples)
        if test_data is None:
            test_data = datasets.load(cfg.data.dataset, "test", seed=cfg.data.seed, num=cfg.data.num_examples)
        self.images, self.labels = data
        self.test_images, self.test_labels = test_data
        self.params: Tree = {k: p.detach().clone() for k, p in self.model.named_parameters()}
        self.batch_stats: Tree = {k: b.detach().clone() for k, b in self.model.named_buffers()}
        mom_dtype = getattr(torch, cfg.opt.momentum_dtype)
        self.opt_state: Tree = {k: torch.zeros_like(p, dtype=mom_dtype) for k, p in self.params.items()}
        self.generator = torch.Generator(self.device).manual_seed(seed + 1)
        self.epoch = 0
        self.best_acc = 0.0
        self.checkpoint_path = checkpoint_path
        self._data = None  # the train set on the device, uploaded at the first epoch
        self._train_step = self._make_train_step()
        self._evaluate = make_eval_fn(self.model)
        if resume and checkpoint_path and os.path.exists(checkpoint_path):
            self.load_checkpoint(checkpoint_path)

    # ------------------------------------------------------------- training
    def _make_train_step(self):
        """``step(params, stats, momentum, x, y, epoch) -> (params, stats,
        momentum, loss, acc)``: one SGD step on one batch in the params'
        dtype, the crop and flip (CIFAR) and a model's keep masks drawn from
        the trainer's generator."""
        cfg, model = self.cfg, self.model
        use_augment = cfg.data.augment and cfg.data.dataset in ("cifar10", "cifar100")
        specs = mask_specs(model)

        def step(params, stats, momentum, x, y, epoch):
            if use_augment:
                x = augment_batch(x, generator=self.generator)
            masks = draw_masks(specs, (x.shape[0],), self.generator, x.device) if specs else {}
            kwargs = {"train": True, "masks": masks} if masks else {"train": True}
            # Plain autograd on one model: the same gradient as torch.func's
            # grad, bit for bit, at half the host time a step.
            leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
            logits, new_stats = functional_call(model, (leaves, stats), (x,), kwargs)
            logits = logits.float()
            ce = softmax_ce_int_labels(logits, y).mean()
            grads = dict(zip(leaves, torch.autograd.grad(ce, list(leaves.values()))))
            acc = (logits.detach().argmax(-1) == y).float().mean()
            with torch.no_grad():
                params, momentum = optim.apply(params, grads, momentum, cfg.opt.lr_at(epoch), cfg.opt)
            new_stats = {k: v.detach() for k, v in new_stats.items()}
            return params, new_stats, momentum, ce.detach(), acc

        return step

    def _device_data(self):
        if self._data is None:
            dtype = next(iter(self.params.values())).dtype
            self._data = (
                torch.from_numpy(np.asarray(self.images)).to(self.device, dtype),
                torch.from_numpy(np.asarray(self.labels, np.int64)).to(self.device),
            )
        return self._data

    def train_epoch(self, order=None) -> Tuple[float, float]:
        """One epoch: ``n // batch`` steps over a shuffled order (``order``,
        a permutation of the train set, injected; else drawn from the
        trainer's generator). Returns the mean loss and accuracy over its
        steps, read from the device once."""
        bs = self.cfg.data.batch_size
        images, labels = self._device_data()
        n = images.shape[0]
        if order is None:
            order = torch.randperm(n, generator=self.generator, device=self.device)
        else:
            order = torch.as_tensor(np.asarray(order, np.int64)).to(self.device)
        losses, accs = [], []
        for i in range(n // bs):
            take = order[i * bs : (i + 1) * bs]
            self.params, self.batch_stats, self.opt_state, loss, acc = self._train_step(
                self.params, self.batch_stats, self.opt_state, images[take], labels[take], self.epoch
            )
            losses.append(loss)
            accs.append(acc)
        self.epoch += 1
        loss_acc = torch.stack([torch.stack(losses), torch.stack(accs)]).double().cpu().numpy()
        return float(np.mean(loss_acc[0])), float(np.mean(loss_acc[1]))

    # ------------------------------------------------------------------ eval
    def test_epoch(self) -> Tuple[float, float]:
        """Evaluate on the test set; save a checkpoint when the accuracy
        beats the best so far."""
        xs, ys = batch_eval_arrays(self.test_images, self.test_labels, self.cfg.data.eval_batch_size)
        dtype = next(iter(self.params.values())).dtype
        loss, acc = self._evaluate(
            self.params,
            self.batch_stats,
            torch.from_numpy(np.asarray(xs)).to(self.device, dtype),
            torch.from_numpy(np.asarray(ys, np.int64)).to(self.device),
        )
        loss, acc = float(loss), float(acc)
        if acc > self.best_acc:
            self.best_acc = acc
            if self.checkpoint_path:
                self.save_checkpoint(self.checkpoint_path)
        return loss, acc

    # ------------------------------------------------------------ checkpoint
    def _state_tree(self) -> dict:
        """fedtpu's checkpoint tree: flax names and layouts on the host."""
        return {
            "params": to_flax(self.params),
            "batch_stats": to_flax(self.batch_stats),
            "momentum": to_flax(self.opt_state),
            "epoch": np.asarray(self.epoch, np.int32),
            "best_acc": np.asarray(self.best_acc, np.float32),
        }

    def save_checkpoint(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(wire.encode(self._state_tree(), compress=True))
        os.replace(tmp, path)

    def load_checkpoint(self, path: str) -> None:
        """Resume the weights, statistics, momentum, epoch and best
        accuracy from a checkpoint file (either package's)."""
        with open(path, "rb") as fh:
            tree = wire.decode(fh.read(), self._state_tree())

        def like(old: Tree, flax_tree) -> Tree:
            new = from_flax(flax_tree, device=self.device)
            return {k: new[k].to(old[k].dtype) for k in old}

        self.params = like(self.params, tree["params"])
        self.batch_stats = like(self.batch_stats, tree["batch_stats"])
        self.opt_state = like(self.opt_state, tree["momentum"])
        self.epoch = int(tree["epoch"])
        self.best_acc = float(tree["best_acc"])


def run_solo(
    cfg: RoundConfig,
    epochs: int,
    seed: int = 0,
    checkpoint_path: Optional[str] = None,
    resume: bool = False,
    logger: Optional[MetricsLogger] = None,
    mesh=None,
    device=None,
) -> SoloTrainer:
    """``epochs`` train and test epochs of a :class:`SoloTrainer`, each
    logged to ``logger``."""
    trainer = SoloTrainer(cfg, seed=seed, checkpoint_path=checkpoint_path, resume=resume, mesh=mesh, device=device)
    for _ in range(epochs):
        tr_loss, tr_acc = trainer.train_epoch()
        te_loss, te_acc = trainer.test_epoch()
        if logger is not None:
            logger.log(
                trainer.epoch,
                train_loss=tr_loss,
                train_acc=tr_acc,
                test_loss=te_loss,
                test_acc=te_acc,
                best_acc=trainer.best_acc,
            )
    return trainer
