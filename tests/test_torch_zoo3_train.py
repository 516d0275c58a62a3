"""The zoo's part 2b in train mode against fedtpu, in f64; its grouped
convolutions under the round's ``vmap(grad)``; and the dropout stream
EfficientNet-B0's train mode reads.

- One train step per family (fedtpu under ``jax.enable_x64``): logits,
  new statistics and the loss gradient within ``rtol=1e-8``, ``atol=1e-8
  * max|x|`` over the compared tree, as ``test_torch_zoo2_train.py`` holds
  part 2a. Images are those of ``chip_smoke.py``'s small card rounds:
  32x32 for EfficientNet-B0, 16x16 for DLA and SimpleDLA, 8x8 for the
  RegNets and PNASNets, batch 4. EfficientNet's step takes fedtpu's keep
  masks for its key (``torch_zoo.fedtpu_masks``), so its drop-connect and
  dropout draw the same examples and entries in both packages.
- torch's ``vmap`` folds the clients into a grouped convolution's group
  count. Two clients' ``vmap(grad)`` of ``pnasnetb`` (a stride-2
  ``SepConv`` has two outputs a group) and ``regnetx_200mf`` (group width
  8) equal each client's own ``grad`` within ``rtol=1e-12`` in f64.
- The masks through the client step (``core/client.py``): all-ones masks
  keep every entry (the step equals one whose drops divide by ``keep``
  without a mask) and a model at rates 0 draws none (its step equals one
  whose drops are the identity), bit for bit; the default draws follow
  the generator's seed and equal the same draws injected; eval mode draws
  nothing, and train mode without its masks raises; the megabatch step
  takes masks of its group shape, and at k=1 equals the per-client step.
"""

import jax
import numpy as np
import pytest
import torch

from fedtpu import models as jmodels
from fedtpu.ops.losses import softmax_ce_int_labels as j_ce
from fedtpu_torch import DataConfig, FedConfig, Federation, RoundConfig
from fedtpu_torch import models as tmodels
from fedtpu_torch.convert import from_flax
from fedtpu_torch.core import client
from fedtpu_torch.core import optim
from fedtpu_torch.models import common, efficientnet
from fedtpu_torch.ops.losses import softmax_ce_int_labels as t_ce
from torch_zoo import fedtpu_masks, flax_variables, one_torch_thread  # noqa: F401 (an autouse fixture)

# (model, image size): one of each family, batch 4.
TRAIN_CASES = [
    ("efficientnetb0", (32, 32, 3)),
    ("regnety_400mf", (8, 8, 3)),
    ("pnasnetb", (8, 8, 3)),
    ("dla", (16, 16, 3)),
    ("simpledla", (16, 16, 3)),
]
BATCH = 4


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _close(got, want, what):
    scale = max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(
            got[k].numpy(), w.numpy(), rtol=1e-8, atol=1e-8 * scale, err_msg=f"{what} {k}"
        )


@pytest.mark.parametrize("name,size", TRAIN_CASES, ids=lambda v: str(v))
def test_train_step_matches_fedtpu_in_f64(name, size):
    params, stats = flax_variables(name, 10, size, seed=4)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(BATCH,) + size)
    y = rng.integers(0, 10, size=BATCH).astype(np.int32)
    jmodel = jmodels.create(name, num_classes=10)
    model = tmodels.create(name, 10, size)
    kwargs = {"train": True}
    with jax.enable_x64(True):
        key = jax.random.PRNGKey(11)
        jstats = _f64(stats)

        def loss(p):
            logits, upd = jmodel.apply(
                {"params": p, "batch_stats": jstats}, x, train=True, mutable=["batch_stats"],
                rngs={"dropout": key},
            )
            return j_ce(logits, y).mean(), (logits, upd["batch_stats"])

        (_, (jlogits, jnew)), jgrad = jax.jit(jax.value_and_grad(loss, has_aux=True))(_f64(params))
        jlogits, jnew, jgrad = jax.tree.map(np.asarray, (jlogits, jnew, jgrad))
        if common.mask_specs(model):
            masks = fedtpu_masks(model, BATCH, [key])
            kwargs["masks"] = {k: torch.from_numpy(m[0]) for k, m in masks.items()}
    if name == "efficientnetb0":
        # The draws drop something: a block's branch and head entries.
        assert not all(m.all() for m in kwargs["masks"].values())
    tstats = from_flax(_f64(stats))

    def tloss(p):
        logits, new = torch.func.functional_call(model, (p, tstats), (torch.from_numpy(x),), kwargs)
        return t_ce(logits, torch.from_numpy(y)).mean(), (logits.detach(), new)

    tgrad, (tlogits, tnew) = torch.func.grad(tloss, has_aux=True)(from_flax(_f64(params)))
    assert tlogits.dtype == torch.float64
    _close({"logits": tlogits}, {"logits": torch.tensor(jlogits)}, "train-mode")
    assert tnew.keys() == from_flax(jnew).keys()
    _close(tnew, from_flax(jnew), "statistics")
    assert tgrad.keys() == from_flax(jgrad).keys()
    _close(tgrad, from_flax(jgrad), "gradient")


def _loss_fn(model):
    def loss(p, s, x, y):
        logits, new = torch.func.functional_call(model, (p, s), (x,), {"train": True})
        return torch.nn.functional.cross_entropy(logits, y), new

    return loss


@pytest.mark.parametrize("name,size", [("pnasnetb", (8, 8, 3)), ("regnetx_200mf", (8, 8, 3))])
def test_grouped_convolutions_under_vmap_match_each_clients_grad(name, size):
    """``vmap`` runs two clients' grouped convolutions as one with twice
    the groups: its gradients and statistics are each client's own."""
    model = tmodels.create(name, 10, size)
    g = torch.Generator().manual_seed(1)
    params = {k: (v.detach() + 0.01 * torch.randn((2,) + v.shape, generator=g)).double()
              for k, v in model.named_parameters()}
    stats = {k: b.expand((2,) + b.shape).double() for k, b in model.named_buffers()}
    x = torch.randn((2, BATCH) + size, generator=g).double()
    y = torch.randint(0, 10, (2, BATCH), generator=g)
    grad = torch.func.grad(_loss_fn(model), has_aux=True)
    batched = torch.func.vmap(grad)(params, stats, x, y)
    for c in range(2):
        alone = grad({k: v[c] for k, v in params.items()}, {k: v[c] for k, v in stats.items()}, x[c], y[c])
        for part in (0, 1):
            assert batched[part].keys() == alone[part].keys()
            scale = max(float(v.abs().max()) for v in alone[part].values())
            for k, v in alone[part].items():
                np.testing.assert_allclose(batched[part][k][c].numpy(), v.numpy(), rtol=1e-12,
                                           atol=1e-12 * scale, err_msg=f"client {c} {k}")


# ------------------------------------------------------ the dropout stream

CLIENTS, STEPS, SIZE = 4, 2, (8, 8, 3)


def _cfg(megabatch=0):
    return RoundConfig(
        model="efficientnetb0", steps_per_round=STEPS,
        data=DataConfig(batch_size=BATCH, eval_batch_size=8, partition="iid", augment=False),
        fed=FedConfig(num_clients=CLIENTS, megabatch_clients=megabatch),
    )


def _inputs():
    g = torch.Generator().manual_seed(3)
    xs = torch.randn((CLIENTS, STEPS, BATCH) + SIZE, generator=g)
    ys = torch.randint(0, 10, (CLIENTS, STEPS, BATCH), generator=g)
    step_mask = torch.ones((CLIENTS, STEPS), dtype=torch.bool)
    step_mask[1, 1] = False
    return xs, ys, step_mask


def _update(model, cfg=None, make=client.make_local_update, **kw):
    """One local update of every client from ``model``'s own weights."""
    cfg = cfg or _cfg()
    params = {k: v.detach() for k, v in model.named_parameters()}
    stats = {k: v.detach() for k, v in model.named_buffers()}
    args = (model, cfg) if make is client.make_local_update else (model, cfg, cfg.fed.megabatch_clients)
    update = make(*args)
    return update(params, stats, optim.init(params, CLIENTS, cfg.opt), *_inputs(), 0.1, **kw)


def _assert_same(a, b):
    for part in ("params", "batch_stats", "opt_state"):
        for k, v in getattr(a, part).items():
            assert torch.equal(v, getattr(b, part)[k]), f"{part} {k}"
    assert torch.equal(a.loss, b.loss)


def _ones(model, lead=(CLIENTS, STEPS, BATCH)):
    return {k: torch.ones(tuple(lead) + tuple(s.shape), dtype=torch.bool)
            for k, s in model.mask_specs().items()}


def test_masks_that_keep_everything_and_rates_of_0(monkeypatch):
    """All-ones masks select nothing away: the step equals the one whose
    drop-connect and dropout divide by ``keep`` with no mask. A model at
    rates 0 draws no masks: its step equals the one at the default rates
    whose drops are the identity. Both bit for bit."""
    torch.manual_seed(0)
    model = tmodels.create("efficientnetb0", 10, SIZE)
    ones = _update(model, masks=_ones(model))
    monkeypatch.setattr(efficientnet, "drop", lambda y, mask, keep: y / torch.full((), keep, dtype=y.dtype))
    _assert_same(_update(model, masks=_ones(model)), ones)
    monkeypatch.setattr(efficientnet, "drop", lambda y, mask, keep: y)
    identity = _update(model, masks=_ones(model))
    plain = efficientnet.EfficientNet(dropout_rate=0.0, drop_connect_rate=0.0, image_size=SIZE)
    plain.load_state_dict(model.state_dict())
    assert common.mask_specs(plain) == {}
    _assert_same(_update(plain), identity)
    assert not torch.equal(identity.params["Dense_0.weight"], ones.params["Dense_0.weight"])


def test_default_draws_follow_the_generators_seed():
    """Without injected masks the step draws them, first, from its
    generator: the same seed gives the same step and the same masks
    injected give it too; another seed another step."""
    torch.manual_seed(0)
    model = tmodels.create("efficientnetb0", 10, SIZE)
    seeded = lambda s: torch.Generator().manual_seed(s)
    a = _update(model, generator=seeded(5))
    _assert_same(_update(model, generator=seeded(5)), a)
    injected = common.draw_masks(model.mask_specs(), (CLIENTS, STEPS, BATCH), seeded(5))
    assert not all(bool(m.all()) for m in injected.values())
    _assert_same(_update(model, masks=injected), a)
    other = _update(model, generator=seeded(6))
    assert not torch.equal(other.params["Dense_0.weight"], a.params["Dense_0.weight"])


def test_eval_draws_nothing():
    """Evaluation and eval mode take no masks and leave every generator
    where it was; train mode without its masks raises."""
    rng = np.random.default_rng(0)
    data = (rng.normal(size=(32,) + SIZE).astype(np.float32), rng.integers(0, 10, 32).astype(np.int32))
    fed = Federation(_cfg(), seed=0, data=data, device="cpu")
    state, global_state = fed._generator.get_state(), torch.random.get_rng_state()
    fed.evaluate(*data)
    fed.model(torch.from_numpy(data[0][:2]))
    assert torch.equal(fed._generator.get_state(), state)
    assert torch.equal(torch.random.get_rng_state(), global_state)
    with pytest.raises(ValueError, match="keep masks"):
        fed.model(torch.from_numpy(data[0][:2]), train=True)


def test_megabatch_takes_masks_of_its_group_shape():
    """k=2: masks ``[groups, steps, 2 * batch, ...]``, per-client ones
    refused; k=1 equals the per-client step on the same masks."""
    torch.manual_seed(0)
    model = tmodels.create("efficientnetb0", 10, SIZE)
    g = torch.Generator().manual_seed(7)
    group = common.draw_masks(model.mask_specs(), (CLIENTS // 2, STEPS, 2 * BATCH), g)
    out = _update(model, _cfg(2), client.make_local_update_mega, masks=group)
    assert all(bool(torch.isfinite(v).all()) for v in out.params.values())
    with pytest.raises(ValueError, match="keep masks"):
        _update(model, _cfg(2), client.make_local_update_mega, masks=_ones(model))
    per_client = common.draw_masks(model.mask_specs(), (CLIENTS, STEPS, BATCH), g)
    _assert_same(_update(model, _cfg(1), client.make_local_update_mega, masks=per_client),
                 _update(model, masks=per_client))
