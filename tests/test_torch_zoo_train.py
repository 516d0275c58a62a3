"""The zoo's BatchNorm models in train mode against fedtpu, in f64.

ResNet, PreAct-ResNet, VGG and DenseNet carry 16 to 120 BatchNorms: in f32
their train-mode logits drift through that many normalizations over small
batches, so, as ``test_torch_mobilenet.py`` holds MobileNet, the logits,
the new statistics and one step's loss gradient are compared in f64
(fedtpu under ``jax.enable_x64``) within ``rtol=1e-8`` and ``atol=1e-8 *
max|x|`` over the compared tree (a conv bias before a train-mode BatchNorm
has a gradient of exactly 0, which both compute as rounding noise): the
same function, to rounding. Widths are the models' own; images are small
(the global pool makes the size free), but the last map holds at least 4
values a channel (a BatchNorm over 2 values is so ill-conditioned that f64
summation orders part by 1e-7), and VGG runs at 64x64, where its last map
is 2x2 and the flatten order shows.
``remat=True`` gradients and statistics equal the plain ones bit for bit.
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
from torch_zoo import flax_variables

# (model, classes, image size, batch)
TRAIN_CASES = [
    ("resnet18", 100, (8, 8, 3), 4),
    ("resnet50", 100, (16, 16, 3), 2),
    ("preactresnet18", 10, (8, 8, 3), 4),
    ("vgg11", 10, (64, 64, 3), 2),
    ("densenet_cifar", 10, (16, 16, 3), 2),
]


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _close(got, want, what):
    scale = max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(
            got[k].numpy(), w.numpy(), rtol=1e-8, atol=1e-8 * scale, err_msg=f"{what} {k}"
        )


@pytest.mark.parametrize("name,classes,size,batch", TRAIN_CASES, ids=lambda v: str(v))
def test_train_step_matches_fedtpu_in_f64(name, classes, size, batch):
    params, stats = flax_variables(name, classes, size, seed=4)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(batch,) + size)
    y = rng.integers(0, classes, size=batch).astype(np.int32)
    jmodel = jmodels.create(name, num_classes=classes)
    with jax.enable_x64(True):
        jstats = _f64(stats)

        def loss(p):
            logits, upd = jmodel.apply(
                {"params": p, "batch_stats": jstats}, x, train=True, mutable=["batch_stats"]
            )
            return j_ce(logits, y).mean(), (logits, upd["batch_stats"])

        (_, (jlogits, jnew)), jgrad = jax.jit(jax.value_and_grad(loss, has_aux=True))(_f64(params))
        jlogits, jnew, jgrad = jax.tree.map(np.asarray, (jlogits, jnew, jgrad))
    model = tmodels.create(name, classes, size)
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


@pytest.mark.parametrize("name", ["resnet18", "preactresnet18"])
def test_remat_gradients_equal_the_plain_ones_bit_for_bit(name):
    """Two clients' gradients under ``vmap(grad)``, as the round takes
    them, with and without per-block recompute; the names do not change."""
    plain = tmodels.create(name, 10, (8, 8, 3))
    remat = tmodels.create(name, 10, (8, 8, 3), remat=True)
    assert remat.remat and [n for n, _ in remat.named_parameters()] == [
        n for n, _ in plain.named_parameters()
    ]
    g = torch.Generator().manual_seed(0)
    params = {k: v.detach() + 0.01 * torch.randn((2,) + v.shape, generator=g) for k, v in plain.named_parameters()}
    stats = {k: b.expand((2,) + b.shape) for k, b in plain.named_buffers()}
    x = torch.randn(2, 4, 8, 8, 3, generator=g)
    y = torch.randint(0, 10, (2, 4), generator=g)
    out = {}
    for label, model in (("plain", plain), ("remat", remat)):
        def loss(p, s, x, y, model=model):
            logits, new = torch.func.functional_call(model, (p, s), (x,), {"train": True})
            return torch.nn.functional.cross_entropy(logits, y), new

        out[label] = torch.func.vmap(torch.func.grad(loss, has_aux=True))(params, stats, x, y)
    for part in (0, 1):
        want = out["plain"][part]
        assert out["remat"][part].keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(out["remat"][part][k], v), k


