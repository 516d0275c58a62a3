"""Per-client local training, every client at once.

The port of ``fedtpu.core.client``. fedtpu writes one client's local epoch
as a ``lax.scan`` and vmaps it over the clients axis; here the clients axis
is a leading tensor dimension throughout: parameters and momentum are
``[clients, ...]`` stacks, one ``torch.func.vmap`` of ``grad`` computes
every client's gradient for a step, and a Python loop walks the local
steps. BatchNorm's running statistics ride along as ``[clients, ...]``
stacks too: the model returns each step's new statistics (the calling
convention of :mod:`fedtpu_torch.models.common`), which come out of
``grad`` as aux outputs. A masked step (ragged shard, dead client) leaves
a client's params, statistics and momentum exactly as they were, through
``torch.where``.

With ``algorithm='fedprox'`` the loss carries FedProx's proximal term
``0.5 * mu * ||w - anchor||^2``, the anchor being the round's global
params (an un-batched input of the vmapped gradient), or in the
asynchronous engine's per-client form each client's own pull snapshot;
the reported loss stays the cross-entropy. With ``megabatch_clients=k``
(:func:`make_local_update_mega`) each group of k clients trains as one
``[k * batch]`` forward on one shared trajectory, broadcast back to its
members.

A model whose train mode draws random numbers (EfficientNet-B0's
drop-connect and dropout) takes its keep masks as inputs, a tree by
module path of bool tensors ``[clients, steps, batch, ...]``
(``[groups, steps, k * batch, ...]`` in megabatch groups): injected by
the caller, or drawn at the start of the local update, outside ``vmap``,
from the step's seeded ``generator`` on the round's device
(:func:`fedtpu_torch.models.common.draw_masks`). fedtpu draws them from
threefry keys, which torch cannot reproduce: a parity check injects
fedtpu's. A model without random modules gets no masks.
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
from fedtpu_torch.models.common import draw_masks, mask_specs
from fedtpu_torch.ops.losses import softmax_ce_int_labels

Tree = Dict[str, torch.Tensor]


class ClientOutput(NamedTuple):
    params: Tree          # [clients, ...] locally updated weights
    batch_stats: Tree     # [clients, ...] locally updated BN running stats
    opt_state: Tree       # [clients, ...] momentum buffers
    loss: torch.Tensor    # [clients] mean cross-entropy over live steps
    accuracy: torch.Tensor


def _where_rows(live: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    return torch.where(live.view((-1,) + (1,) * (new.ndim - 1)), new, old)


def make_local_update(
    model: nn.Module, cfg: RoundConfig, per_client: bool = False
) -> Callable[..., ClientOutput]:
    """Build ``local_update(global_params, global_stats, momentum, xs, ys,
    step_mask, lr, generator=None, masks=None, anchor=None) -> ClientOutput``
    over all clients: ``xs [clients, steps, batch, h, w, c]``, ``ys
    [clients, steps, batch]``, ``step_mask [clients, steps]`` bool,
    ``momentum`` the ``[clients, ...]`` buffers, ``global_stats`` the global
    BN statistics (``{}`` for a model without any). ``generator`` draws the
    model's keep masks (unless ``masks`` brings them, ``[clients, steps,
    batch, ...]`` by module path) and, when augmentation is on, the crop and
    flip.

    With ``per_client=True`` (the asynchronous engine's form, fedtpu's
    ``vmap`` with ``in_axes=(0, 0, 0, 0, 0, 0, 0, None, 0)``) every client
    starts from its own ``[clients, ...]`` params and statistics, and
    FedProx's anchor is ``anchor``, each client's own ``[clients, ...]``
    pull snapshot; otherwise every client starts from the global model,
    which is also the anchor.

    With ``dtype='bfloat16'`` the f32 master params and the inputs are cast
    at use, so the forward runs in bf16 and the gradients come out f32
    through the cast, as ``fedtpu.core.client`` does. The statistics stay
    f32. With ``dtype='float32'`` the step computes in the params' dtype:
    f32, or f64 for a reference run.
    """
    forward = _make_forward(model, cfg)
    mu = _fedprox_mu(cfg)
    use_augment = _use_augment(cfg)
    compute_dtype = getattr(torch, resolve_compute_dtype(cfg))
    specs = mask_specs(model)

    def loss_fn(params: Tree, stats: Tree, anchor: Tree, x: torch.Tensor, y: torch.Tensor, masks: Tree):
        logits, new_stats = forward(params, stats, x, masks)
        ce = softmax_ce_int_labels(logits, y).mean()
        loss = ce + _proximal(params, anchor, mu) if mu > 0.0 else ce
        acc = (logits.argmax(-1) == y).float().mean()
        return loss, (new_stats, ce.detach(), acc)

    per_client_grad = vmap(
        grad(loss_fn, has_aux=True), in_dims=(0, 0, 0 if per_client else None, 0, 0, 0)
    )

    def local_update(
        global_params: Tree,
        global_stats: Tree,
        momentum: Tree,
        xs: torch.Tensor,
        ys: torch.Tensor,
        step_mask: torch.Tensor,
        lr: float,
        generator: Optional[torch.Generator] = None,
        masks: Optional[Tree] = None,
        anchor: Optional[Tree] = None,
    ) -> ClientOutput:
        n, steps = step_mask.shape
        masks = _round_masks(specs, masks, tuple(ys.shape), generator, ys.device)
        if per_client:
            params, stats = global_params, global_stats
        else:
            anchor = global_params
            params = {k: p.expand((n,) + tuple(p.shape)) for k, p in global_params.items()}
            stats = {k: s.expand((n,) + tuple(s.shape)) for k, s in global_stats.items()}
        ces, accs, lives = [], [], []
        for s in range(steps):
            x = xs[:, s].to(compute_dtype)
            if use_augment:
                x = _augment(x, cfg, generator)
            step_masks = {k: m[:, s] for k, m in masks.items()}
            grads, (new_stats, ce, acc) = per_client_grad(params, stats, anchor, x, ys[:, s], step_masks)
            new_params, new_momentum = optim.apply(params, grads, momentum, lr, cfg.opt)
            live = step_mask[:, s]
            params = {k: _where_rows(live, new_params[k], params[k]) for k in params}
            stats = {k: _where_rows(live, new_stats[k], stats[k]) for k in stats}
            momentum = {k: _where_rows(live, new_momentum[k], momentum[k]) for k in momentum}
            live_f = live.float()
            ces.append(ce * live_f)
            accs.append(acc * live_f)
            lives.append(live_f)
        denom = torch.clamp(torch.stack(lives).sum(0), min=1.0)
        return ClientOutput(
            params=params,
            batch_stats=stats,
            opt_state=momentum,
            loss=torch.stack(ces).sum(0) / denom,
            accuracy=torch.stack(accs).sum(0) / denom,
        )

    return local_update


def _fedprox_mu(cfg: RoundConfig) -> float:
    return cfg.fed.fedprox_mu if cfg.fed.algorithm == "fedprox" else 0.0


def _use_augment(cfg: RoundConfig) -> bool:
    return cfg.data.augment and cfg.data.dataset in ("cifar10", "cifar100")


def _round_masks(specs, masks: Optional[Tree], lead, generator, device) -> Tree:
    """A round's keep masks ``lead + shape`` by module path (``lead`` the
    labels' ``[clients, steps, batch]``): ``masks`` on ``device``, checked
    against the model's ``specs``, or drawn from ``generator``; ``{}`` for a
    model without random modules."""
    if not specs:
        return {}
    if masks is None:
        return draw_masks(specs, lead, generator, device)
    want = {k: tuple(lead) + tuple(spec.shape) for k, spec in specs.items()}
    got = {k: tuple(m.shape) for k, m in masks.items()}
    if got != want:
        raise ValueError(f"keep masks {got} do not match the model's {want}")
    return {k: m.to(device=device, dtype=torch.bool) for k, m in masks.items()}


def _make_forward(model: nn.Module, cfg: RoundConfig):
    """``forward(params, stats, x, masks) -> (f32 logits, new_stats)`` in
    train mode, in the compute dtype; ``masks`` the model's keep masks for
    this batch (``{}`` for a model without random modules)."""
    compute_dtype = getattr(torch, resolve_compute_dtype(cfg))

    def forward(params: Tree, stats: Tree, x: torch.Tensor, masks: Tree):
        if compute_dtype != torch.float32:
            params = {k: p.to(compute_dtype) for k, p in params.items()}
        else:
            # flax's layers compute in the promotion of the input's and the
            # params' dtypes: f64 params (a reference run) take f64 inputs.
            x = x.to(torch.promote_types(x.dtype, next(iter(params.values())).dtype))
        kwargs = {"train": True, "masks": masks} if masks else {"train": True}
        logits, new_stats = functional_call(model, (params, stats), (x,), kwargs)
        return logits.float(), new_stats

    return forward


def _proximal(params: Tree, anchor: Tree, mu: float) -> torch.Tensor:
    """FedProx's ``0.5 * mu * ||params - anchor||^2`` over every leaf, each
    leaf's squares summed in f32 as fedtpu's ``tree_sq_norm`` sums them."""
    sq = sum(torch.sum(torch.square((params[k] - anchor[k]).float())) for k in params)
    return 0.5 * mu * sq


def _augment(x: torch.Tensor, cfg: RoundConfig, generator) -> torch.Tensor:
    """Crop and flip ``[clients, batch, ...]`` images, as one batch."""
    flat = x.reshape((-1,) + tuple(x.shape[2:]))
    return augment_batch(flat, crop=cfg.data.augment_crop, generator=generator).reshape(x.shape)


def make_local_update_mega(model: nn.Module, cfg: RoundConfig, k: int) -> Callable[..., ClientOutput]:
    """:func:`make_local_update` with ``megabatch_clients=k``: the same
    call and output, computed per group of k clients (clients ``0..k-1``
    form group 0) as fedtpu's ``make_local_update_mega`` and
    ``_megabatch_wrap`` compute it.

    Each step, a group's ``k * batch`` examples go through one forward
    under one set of params; the loss is the mean cross-entropy over the
    examples of the members whose step is live (weights 1 or 0), and the
    group steps when any member is live. The group's momentum starts from
    the mean of its members' buffers (accumulated in f32). Afterwards the
    group's params, statistics and momentum are broadcast to its members; a
    member that never trained this round keeps the global params and
    statistics and its own momentum. A member's loss and accuracy are
    measured on its own examples under the group's model. At k=1 every
    array is bit-identical to the per-client path's. At k>1, BatchNorm's
    statistics are shared over the ``k * batch`` examples, and a model's
    keep masks are the group's, ``[groups, steps, k * batch, ...]``."""
    forward = _make_forward(model, cfg)
    mu = _fedprox_mu(cfg)
    use_augment = _use_augment(cfg)
    compute_dtype = getattr(torch, resolve_compute_dtype(cfg))
    specs = mask_specs(model)

    def loss_fn(params, stats, anchor, x, y, exw, masks):
        logits, new_stats = forward(params, stats, x, masks)
        per = softmax_ce_int_labels(logits, y)  # [k * batch]
        loss = torch.sum(per * exw) / torch.clamp(torch.sum(exw), min=1.0)
        if mu > 0.0:
            loss = loss + _proximal(params, anchor, mu)
        correct = (logits.argmax(-1) == y).float()
        ce_m = per.detach().reshape(k, -1).mean(1)
        acc_m = correct.reshape(k, -1).mean(1)
        return loss, (new_stats, ce_m, acc_m)

    group_grad = vmap(grad(loss_fn, has_aux=True), in_dims=(0, 0, None, 0, 0, 0, 0))

    def local_update(
        global_params: Tree,
        global_stats: Tree,
        momentum: Tree,
        xs: torch.Tensor,
        ys: torch.Tensor,
        step_mask: torch.Tensor,
        lr: float,
        generator: Optional[torch.Generator] = None,
        masks: Optional[Tree] = None,
    ) -> ClientOutput:
        n, steps = step_mask.shape
        g = n // k
        batch = ys.shape[2]
        masks = _round_masks(specs, masks, (g, steps, k * batch), generator, ys.device)

        def group(t: torch.Tensor) -> torch.Tensor:
            return t.reshape((g, k) + tuple(t.shape[1:]))

        params = {kk: p.expand((g,) + tuple(p.shape)) for kk, p in global_params.items()}
        stats = {kk: s.expand((g,) + tuple(s.shape)) for kk, s in global_stats.items()}
        mom = {kk: group(m).float().mean(1).to(m.dtype) for kk, m in momentum.items()}
        member_mask = group(step_mask)  # [G, k, steps]
        ces, accs, lives = [], [], []
        for s in range(steps):
            x = xs[:, s].to(compute_dtype)
            if use_augment:
                x = _augment(x, cfg, generator)
            x = x.reshape((g, k * batch) + tuple(x.shape[2:]))
            y = ys[:, s].reshape(g, k * batch)
            live_m = member_mask[:, :, s]
            live_f = live_m.float()
            exw = live_f[:, :, None].expand(g, k, batch).reshape(g, k * batch)
            step_masks = {kk: m[:, s] for kk, m in masks.items()}
            grads, (new_stats, ce_m, acc_m) = group_grad(params, stats, global_params, x, y, exw, step_masks)
            new_params, new_mom = optim.apply(params, grads, mom, lr, cfg.opt)
            live = live_m.any(1)
            params = {kk: _where_rows(live, new_params[kk], params[kk]) for kk in params}
            stats = {kk: _where_rows(live, new_stats[kk], stats[kk]) for kk in stats}
            mom = {kk: _where_rows(live, new_mom[kk], mom[kk]) for kk in mom}
            ces.append(ce_m * live_f)
            accs.append(acc_m * live_f)
            lives.append(live_f)
        denom = torch.clamp(torch.stack(lives).sum(0), min=1.0)
        trained = step_mask.any(1)

        def bcast(t: torch.Tensor) -> torch.Tensor:
            return t[:, None].expand((g, k) + tuple(t.shape[1:])).reshape((n,) + tuple(t.shape[1:]))

        def members(tree: Tree, fallback: Tree) -> Tree:
            return {kk: _where_rows(trained, bcast(v), fallback[kk]) for kk, v in tree.items()}

        expand = lambda tree: {kk: v.expand((n,) + tuple(v.shape)) for kk, v in tree.items()}
        return ClientOutput(
            params=members(params, expand(global_params)),
            batch_stats=members(stats, expand(global_stats)),
            opt_state=members(mom, momentum),
            loss=(torch.stack(ces).sum(0) / denom).reshape(n),
            accuracy=(torch.stack(accs).sum(0) / denom).reshape(n),
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


def make_eval_fn(model: nn.Module) -> Callable[..., tuple]:
    """``evaluate(params, batch_stats, xs, ys) -> (mean_loss, accuracy)``
    as 0-d tensors over ``xs [num_batches, batch, ...]``, in f32 (f64 for
    f64 params), with BatchNorm reading the running statistics
    ``batch_stats``."""

    @torch.no_grad()
    def evaluate(params: Tree, batch_stats: Tree, xs: torch.Tensor, ys: torch.Tensor):
        loss_sum = torch.zeros((), device=xs.device)
        correct = torch.zeros((), device=xs.device)
        dtype = torch.promote_types(torch.float32, next(iter(params.values())).dtype)
        for x, y in zip(xs, ys):
            logits = functional_call(model, (params, batch_stats), (x.to(dtype),)).float()
            loss_sum += softmax_ce_int_labels(logits, y).sum()
            correct += (logits.argmax(-1) == y).float().sum()
        n = ys.numel()
        return loss_sum / n, correct / n

    return evaluate
