"""Per-client local training, every client at once.

The port of ``fedtpu.core.client``. fedtpu writes one client's local epoch
as a ``lax.scan`` and vmaps it over the clients axis; here the clients axis
is a leading tensor dimension throughout: parameters and momentum are
``[clients, ...]`` stacks, one ``torch.func.vmap`` of ``grad`` computes
every client's gradient for a step, and a Python loop walks the local
steps. A masked step (ragged shard, dead client) leaves a client's params
and momentum exactly as they were, through ``torch.where``.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call, grad, vmap

from fedtpu_torch.config import RoundConfig, resolve_compute_dtype
from fedtpu_torch.core import optim
from fedtpu_torch.data.augment import augment_batch
from fedtpu_torch.ops.losses import softmax_ce_int_labels

Tree = Dict[str, torch.Tensor]


class ClientOutput(NamedTuple):
    params: Tree          # [clients, ...] locally updated weights
    opt_state: Tree       # [clients, ...] momentum buffers
    loss: torch.Tensor    # [clients] mean cross-entropy over live steps
    accuracy: torch.Tensor


def _where_rows(live: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    return torch.where(live.view((-1,) + (1,) * (new.ndim - 1)), new, old)


def make_local_update(model: nn.Module, cfg: RoundConfig) -> Callable[..., ClientOutput]:
    """Build ``local_update(global_params, momentum, xs, ys, step_mask, lr,
    generator=None) -> ClientOutput`` over all clients:
    ``xs [clients, steps, batch, h, w, c]``, ``ys [clients, steps, batch]``,
    ``step_mask [clients, steps]`` bool, ``momentum`` the ``[clients, ...]``
    buffers. ``generator`` draws the crop and flip when augmentation is on.

    With ``dtype='bfloat16'`` the f32 master params and the inputs are cast
    at use, so the forward runs in bf16 and the gradients come out f32
    through the cast, as ``fedtpu.core.client`` does.
    """
    compute_dtype = getattr(torch, resolve_compute_dtype(cfg))
    use_augment = cfg.data.augment and cfg.data.dataset in ("cifar10", "cifar100")

    def loss_fn(params: Tree, x: torch.Tensor, y: torch.Tensor):
        if compute_dtype != torch.float32:
            params = {k: p.to(compute_dtype) for k, p in params.items()}
        logits = functional_call(model, params, (x,)).float()
        ce = softmax_ce_int_labels(logits, y).mean()
        acc = (logits.argmax(-1) == y).float().mean()
        return ce, (ce.detach(), acc)

    per_client_grad = vmap(grad(loss_fn, has_aux=True))

    def local_update(
        global_params: Tree,
        momentum: Tree,
        xs: torch.Tensor,
        ys: torch.Tensor,
        step_mask: torch.Tensor,
        lr: float,
        generator: Optional[torch.Generator] = None,
    ) -> ClientOutput:
        n, steps = step_mask.shape
        params = {k: p.expand((n,) + tuple(p.shape)) for k, p in global_params.items()}
        ces, accs, lives = [], [], []
        for s in range(steps):
            x = xs[:, s].to(compute_dtype)
            if use_augment:
                flat = x.reshape((-1,) + tuple(x.shape[2:]))
                x = augment_batch(
                    flat, crop=cfg.data.augment_crop, generator=generator
                ).reshape(x.shape)
            grads, (ce, acc) = per_client_grad(params, x, ys[:, s])
            new_params, new_momentum = optim.apply(params, grads, momentum, lr, cfg.opt)
            live = step_mask[:, s]
            params = {k: _where_rows(live, new_params[k], params[k]) for k in params}
            momentum = {k: _where_rows(live, new_momentum[k], momentum[k]) for k in momentum}
            live_f = live.float()
            ces.append(ce * live_f)
            accs.append(acc * live_f)
            lives.append(live_f)
        denom = torch.clamp(torch.stack(lives).sum(0), min=1.0)
        return ClientOutput(
            params=params,
            opt_state=momentum,
            loss=torch.stack(ces).sum(0) / denom,
            accuracy=torch.stack(accs).sum(0) / denom,
        )

    return local_update


def batch_eval_arrays(images, labels, batch_size: int):
    """Shape an eval set into ``[num_batches, batch, ...]`` numpy arrays,
    dropping the ragged tail; raises when the set is below one batch."""
    nb = len(images) // batch_size
    if nb == 0:
        raise ValueError(
            f"eval set of {len(images)} examples is smaller than "
            f"eval_batch_size={batch_size}"
        )
    xs = np.asarray(images[: nb * batch_size]).reshape((nb, batch_size) + images.shape[1:])
    ys = np.asarray(labels[: nb * batch_size]).reshape((nb, batch_size))
    return xs, ys


def make_eval_fn(model: nn.Module) -> Callable[[Tree, torch.Tensor, torch.Tensor], tuple]:
    """``evaluate(params, xs, ys) -> (mean_loss, accuracy)`` as 0-d tensors
    over ``xs [num_batches, batch, ...]``, in f32."""

    @torch.no_grad()
    def evaluate(params: Tree, xs: torch.Tensor, ys: torch.Tensor):
        loss_sum = torch.zeros((), device=xs.device)
        correct = torch.zeros((), device=xs.device)
        for x, y in zip(xs, ys):
            logits = functional_call(model, params, (x.float(),)).float()
            loss_sum += softmax_ce_int_labels(logits, y).sum()
            correct += (logits.argmax(-1) == y).float().sum()
        n = ys.numel()
        return loss_sum / n, correct / n

    return evaluate
