"""The zoo's part 2a in train mode against fedtpu, in f64, and its grouped
convolutions under the round's ``vmap(grad)``.

- One train step per family (fedtpu under ``jax.enable_x64``): logits,
  new statistics and the loss gradient within ``rtol=1e-8``, ``atol=1e-8
  * max|x|`` over the compared tree, as ``test_torch_zoo_train.py`` holds
  part 1. Images are those of ``chip_smoke.py``'s small card rounds:
  16x16 for MobileNetV2 and the ShuffleNets, 8x8 for the rest, batch 4, so
  the last map holds at least 4 values a channel.
- ``senet18`` with ``remat=True``: two clients' gradients and statistics
  under ``vmap(grad)`` equal the plain model's bit for bit.
- torch's ``vmap`` folds the clients into a grouped convolution's group
  count. Two clients' ``vmap(grad)`` of ``resnext29_32x4d`` (32 groups of
  4 channels) and ``shufflenetg3`` (grouped 1x1s, 3 groups of 18 to 80
  channels) equal each client's own ``grad`` within ``rtol=1e-12`` in f64.
"""

import jax
import numpy as np
import pytest
import torch

from fedtpu import models as jmodels
from fedtpu.ops.losses import softmax_ce_int_labels as j_ce
from fedtpu_torch import models as tmodels
from fedtpu_torch.convert import from_flax
from fedtpu_torch.ops.losses import softmax_ce_int_labels as t_ce
from torch_zoo import flax_variables, one_torch_thread  # noqa: F401 (an autouse fixture)

# (model, image size): one of each family, batch 4.
TRAIN_CASES = [
    ("mobilenetv2", (16, 16, 3)),
    ("googlenet", (8, 8, 3)),
    ("resnext29_2x64d", (8, 8, 3)),
    ("senet18", (8, 8, 3)),
    ("dpn26", (8, 8, 3)),
    ("shufflenetg2", (16, 16, 3)),
    ("shufflenetv2", (16, 16, 3)),
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
    with jax.enable_x64(True):
        jstats = _f64(stats)

        def loss(p):
            logits, upd = jmodel.apply(
                {"params": p, "batch_stats": jstats}, x, train=True, mutable=["batch_stats"]
            )
            return j_ce(logits, y).mean(), (logits, upd["batch_stats"])

        (_, (jlogits, jnew)), jgrad = jax.jit(jax.value_and_grad(loss, has_aux=True))(_f64(params))
        jlogits, jnew, jgrad = jax.tree.map(np.asarray, (jlogits, jnew, jgrad))
    model = tmodels.create(name, 10, size)
    tstats = from_flax(_f64(stats))

    def tloss(p):
        logits, new = torch.func.functional_call(model, (p, tstats), (torch.from_numpy(x),), {"train": True})
        return t_ce(logits, torch.from_numpy(y)).mean(), (logits.detach(), new)

    tgrad, (tlogits, tnew) = torch.func.grad(tloss, has_aux=True)(from_flax(_f64(params)))
    assert tlogits.dtype == torch.float64
    _close({"logits": tlogits}, {"logits": torch.tensor(jlogits)}, "train-mode")
    assert tnew.keys() == from_flax(jnew).keys()
    _close(tnew, from_flax(jnew), "statistics")
    assert tgrad.keys() == from_flax(jgrad).keys()
    _close(tgrad, from_flax(jgrad), "gradient")


def _two_clients(model, size, dtype=torch.float32, seed=0):
    """Two clients' params (the model's own, perturbed), statistics and
    batches."""
    g = torch.Generator().manual_seed(seed)
    params = {k: (v.detach() + 0.01 * torch.randn((2,) + v.shape, generator=g)).to(dtype)
              for k, v in model.named_parameters()}
    stats = {k: b.expand((2,) + b.shape).to(dtype) for k, b in model.named_buffers()}
    x = torch.randn((2, BATCH) + size, generator=g).to(dtype)
    y = torch.randint(0, 10, (2, BATCH), generator=g)
    return params, stats, x, y


def _loss_fn(model):
    def loss(p, s, x, y):
        logits, new = torch.func.functional_call(model, (p, s), (x,), {"train": True})
        return torch.nn.functional.cross_entropy(logits, y), new

    return loss


def test_senet_remat_gradients_equal_the_plain_ones_bit_for_bit():
    """Two clients' gradients and statistics under ``vmap(grad)``, as the
    round takes them, with and without per-block recompute; the names do
    not change."""
    size = (8, 8, 3)
    plain = tmodels.create("senet18", 10, size)
    remat = tmodels.create("senet18", 10, size, remat=True)
    assert remat.remat and [n for n, _ in remat.named_parameters()] == [
        n for n, _ in plain.named_parameters()
    ]
    inputs = _two_clients(plain, size)
    out = {label: torch.func.vmap(torch.func.grad(_loss_fn(m), has_aux=True))(*inputs)
           for label, m in (("plain", plain), ("remat", remat))}
    for part in (0, 1):
        want = out["plain"][part]
        assert out["remat"][part].keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(out["remat"][part][k], v), k


@pytest.mark.parametrize("name,size", [("resnext29_32x4d", (8, 8, 3)), ("shufflenetg3", (16, 16, 3))])
def test_grouped_convolutions_under_vmap_match_each_clients_grad(name, size):
    """``vmap`` runs two clients' grouped convolutions as one with twice
    the groups: its gradients and statistics are each client's own."""
    model = tmodels.create(name, 10, size)
    params, stats, x, y = _two_clients(model, size, torch.float64, seed=1)
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
