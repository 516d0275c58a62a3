"""The port's BatchNorm and MobileNet against fedtpu; MobileNet rounds are
held in ``test_torch_mobilenet_rounds.py``.

Inputs come from one numpy seed and go through both packages; fedtpu's
MobileNet is initialised once per module (``torch_mobilenet.
flax_mobilenet``; its init and its compiles are what this file spends its
time on). Tolerances:

- BatchNorm alone, f32: output and new running statistics within
  ``atol=1e-6`` (the statistics are sums in another order); bf16: within
  one bf16 ulp (``rtol=2**-8``); eval mode within ``atol=1e-6`` (XLA's
  CPU ``rsqrt`` is not correctly rounded, torch's is).
- MobileNet at full width, 2 x 4 examples of 32x32: P = 3,217,226 in 83
  leaves; ``convert`` round-trips ``params`` and ``batch_stats`` exactly;
  logits within ``atol=1e-5`` in eval mode, within ``atol=2e-4,
  rtol=1e-4`` in train mode (27 batch normalizations over as few as 16
  values a channel amplify the last-bit differences of the statistics),
  new statistics within ``atol=1e-5, rtol=1e-4``; the flat row is
  fedtpu's bit for bit; one f64 step's gradient within ``rtol=1e-8``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedtpu.models.common import batch_norm as j_batch_norm
from fedtpu.ops import flat as jflat
from fedtpu.ops.losses import softmax_ce_int_labels as j_ce
from fedtpu_torch import config as tconfig
from fedtpu_torch import models as tmodels
from fedtpu_torch.convert import from_flax, to_flax
from fedtpu_torch.core import round as tround
from fedtpu_torch.core.engine import Federation as TFederation
from fedtpu_torch.models import common
from fedtpu_torch.models.common import BatchNorm
from fedtpu_torch.ops import flat as tflat
from fedtpu_torch.ops.losses import softmax_ce_int_labels as t_ce
from torch_mobilenet import BATCH, CLIENTS, _configs, _f64, flax_mobilenet  # noqa: F401 (a fixture)
from torch_zoo import one_torch_thread  # noqa: F401 (an autouse fixture)

MOBILENET_P = 3_217_226


# ------------------------------------------------------------ BatchNorm


def _bn_case(dtype, train, c=24):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 6, 5, c)).astype(np.float32)
    params = {
        "scale": (1 + 0.2 * rng.normal(size=c)).astype(np.float32),
        "bias": (0.1 * rng.normal(size=c)).astype(np.float32),
    }
    stats = {
        "mean": (0.1 * rng.normal(size=c)).astype(np.float32),
        "var": rng.uniform(0.5, 2.0, size=c).astype(np.float32),
    }
    mod = j_batch_norm(train)
    jvars = {
        "params": jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), params),
        "batch_stats": stats,
    }
    xj = jnp.asarray(x).astype(dtype)
    if train:
        want, upd = mod.apply(jvars, xj, mutable=["batch_stats"])
        want_stats = jax.tree.map(np.asarray, upd["batch_stats"])
    else:
        want, want_stats = mod.apply(jvars, xj), None
    tdt = getattr(torch, dtype)
    tvars = {k: torch.from_numpy(v).to(tdt) for k, v in params.items()}
    tvars.update({k: torch.from_numpy(v) for k, v in stats.items()})
    sink = {} if train else None
    got = torch.func.functional_call(
        BatchNorm(c), tvars, (torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2), sink)
    ).permute(0, 2, 3, 1)
    assert got.dtype == tdt
    return got.float().detach().numpy(), np.asarray(want.astype(jnp.float32)), sink, want_stats


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batch_norm_f32_matches_fedtpu(train):
    got, want, stats, want_stats = _bn_case("float32", train)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    if train:
        assert sorted(stats) == ["mean", "var"]
        for k in stats:
            np.testing.assert_allclose(stats[k].numpy(), want_stats[k], atol=1e-6, rtol=0)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batch_norm_bf16_matches_fedtpu(train):
    """The normalize runs in bf16 (the output is bf16); the statistics stay
    f32."""
    got, want, stats, want_stats = _bn_case("bfloat16", train)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=2**-8)
    if train:
        for k in stats:
            assert stats[k].dtype == torch.float32
            np.testing.assert_allclose(stats[k].numpy(), want_stats[k], atol=1e-6, rtol=0)


def _plain_train_norm(x, scale, bias):
    """Train-mode BatchNorm as plain autograd ops (what ``_TrainNorm``'s
    hand-written backward replaces)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean((0, 2, 3))
    raw = torch.square(xf).mean((0, 2, 3)) - torch.square(mean)
    var = torch.maximum(raw, torch.zeros_like(raw))
    return common._normalize(x, mean, var, scale, bias)


@pytest.mark.parametrize("dtype,rtol", [
    (torch.float64, 1e-12), (torch.float32, 1e-6), (torch.bfloat16, 2e-2),
])
def test_batch_norm_backward_matches_the_plain_ops(dtype, rtol):
    """Under ``vmap(grad)``, as the round takes it: the hand-written
    backward against autograd of the plain ops (bf16: the plain ops reduce
    in bf16, the backward in f32, so they agree to bf16's precision)."""
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(3, 4, 6, 5, 7, generator=g) * 2 + 0.5).to(dtype)
    w = torch.randn(3, 4, 6, 5, 7, generator=g).to(dtype)
    scale = (1 + 0.2 * torch.randn(3, 6, generator=g)).to(dtype)
    bias = (0.1 * torch.randn(3, 6, generator=g)).to(dtype)
    out = {}
    for name, fn in (("function", lambda *t: common._TrainNorm.apply(*t)[0]), ("plain", _plain_train_norm)):
        def loss(x, s, b, w, fn=fn):
            return (fn(x, s, b).double() * w.double()).sum()

        out[name] = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)))(x, scale, bias, w)
        assert torch.equal(fn(x[0], scale[0], bias[0]), _plain_train_norm(x[0], scale[0], bias[0]))
    for got, want in zip(out["function"], out["plain"]):
        assert got.dtype == want.dtype == dtype
        err = float((got.double() - want.double()).norm() / want.double().norm())
        assert err <= rtol, err


def test_batch_norm_writes_no_buffer_in_train_mode():
    bn = BatchNorm(3)
    stats = {}
    bn(torch.randn(2, 3, 4, 4), stats)
    assert torch.equal(bn.mean, torch.zeros(3)) and torch.equal(bn.var, torch.ones(3))
    assert not torch.equal(stats["mean"], bn.mean)


# ------------------------------------------------------------ MobileNet


def test_mobilenet_leaves_match_fedtpu(flax_mobilenet):
    _, params, stats = flax_mobilenet
    model = tmodels.create("mobilenet", 10)
    got = {k: tuple(v.shape) for k, v in model.named_parameters()}
    assert sum(int(np.prod(s)) for s in got.values()) == MOBILENET_P
    assert len(got) == len(jax.tree.leaves(params)) == 83
    assert {k: tuple(v.shape) for k, v in from_flax(params).items()} == got
    got_stats = {k: tuple(v.shape) for k, v in model.named_buffers()}
    assert {k: tuple(v.shape) for k, v in from_flax(stats).items()} == got_stats
    assert model.DepthwiseSeparable_12.Conv_0.weight.shape == (1024, 1, 3, 3)


@pytest.mark.parametrize("collection", ["params", "batch_stats"])
def test_convert_round_trips_mobilenet_exactly(flax_mobilenet, collection):
    tree = flax_mobilenet[1 if collection == "params" else 2]
    back = to_flax(from_flax(tree))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for (path, a), b in zip(
        jax.tree_util.tree_leaves_with_path(tree), jax.tree.leaves(back)
    ):
        np.testing.assert_array_equal(b, a, err_msg=jax.tree_util.keystr(path))


def test_mobilenet_remat_names_its_roadmap_item():
    """remat, once an unported item of ROADMAP.md, is ported: the config
    validates and the model recomputes its blocks under the same names."""
    tconfig.validate(tconfig.RoundConfig(model="mobilenet", remat=True))
    model = tmodels.create("mobilenet", 10, remat=True)
    assert model.remat
    assert [n for n, _ in model.named_parameters()] == [
        n for n, _ in tmodels.create("mobilenet", 10).named_parameters()
    ]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_mobilenet_forward_matches_fedtpu(flax_mobilenet, train):
    jmodel, params, stats = flax_mobilenet
    x = np.random.default_rng(2).normal(size=(BATCH, 32, 32, 3)).astype(np.float32)
    variables = {"params": params, "batch_stats": stats}
    model = tmodels.create("mobilenet", 10)
    tvars = (from_flax(params), from_flax(stats))
    with torch.no_grad():
        out = torch.func.functional_call(model, tvars, (torch.from_numpy(x),), {"train": train})
    if not train:
        want = jmodel.apply(variables, x, train=False)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5, rtol=0)
        return
    want, upd = jmodel.apply(variables, x, train=True, mutable=["batch_stats"])
    logits, new_stats = out
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=2e-4, rtol=1e-4)
    want_stats = from_flax(jax.tree.map(np.asarray, upd["batch_stats"]))
    assert new_stats.keys() == want_stats.keys()
    for k, v in want_stats.items():
        np.testing.assert_allclose(new_stats[k].numpy(), v.numpy(), atol=1e-5, rtol=1e-4, err_msg=k)


def test_mobilenet_step_gradient_matches_fedtpu_in_f64(flax_mobilenet):
    """One train-mode step's loss gradient and new statistics in f64 (fedtpu
    under ``jax.enable_x64``): the same function to rounding, 1e-8."""
    jmodel, params, stats = flax_mobilenet
    rng = np.random.default_rng(5)
    x = rng.normal(size=(BATCH, 32, 32, 3))
    y = rng.integers(0, 10, size=BATCH).astype(np.int32)
    with jax.enable_x64(True):
        jstats = _f64(stats)

        def loss(p):
            logits, upd = jmodel.apply(
                {"params": p, "batch_stats": jstats}, x, train=True, mutable=["batch_stats"]
            )
            return j_ce(logits, y).mean(), upd["batch_stats"]

        (_, jnew), jgrad = jax.jit(jax.value_and_grad(loss, has_aux=True))(_f64(params))
        jgrad, jnew = jax.tree.map(np.asarray, (jgrad, jnew))
    model = tmodels.create("mobilenet", 10)
    tstats = from_flax(_f64(stats))

    def tloss(p):
        logits, new = torch.func.functional_call(
            model, (p, tstats), (torch.from_numpy(x),), {"train": True}
        )
        return t_ce(logits, torch.from_numpy(y)).mean(), new

    tgrad, tnew = torch.func.grad(tloss, has_aux=True)(from_flax(_f64(params)))
    for got, want in ((tgrad, jgrad), (tnew, jnew)):
        for k, w in from_flax(want).items():
            np.testing.assert_allclose(
                got[k].numpy(), w.numpy(), rtol=1e-8, atol=1e-8 * float(w.abs().max()), err_msg=k
            )


def test_mobilenet_federation_evaluates_with_the_global_statistics(flax_mobilenet):
    """``Federation.evaluate`` reads ``state.batch_stats``: fedtpu's eval
    (loss and accuracy over the same batches) on the same variables."""
    jmodel, params, stats = flax_mobilenet
    _, tcfg = _configs("none", "per_leaf")
    rng = np.random.default_rng(6)
    images = rng.normal(size=(16, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=16).astype(np.int32)
    fed = TFederation(tcfg, seed=0, data=(images, labels), device="cpu")
    fed.state = tround.init_state(
        fed.model, tcfg, params=from_flax(params), batch_stats=from_flax(stats)
    )
    logits = jmodel.apply({"params": params, "batch_stats": stats}, images, train=False)
    want_loss = float(j_ce(logits, labels).mean())
    want_acc = float((np.asarray(logits).argmax(-1) == labels).mean())
    loss, acc = fed.evaluate(images, labels)
    assert loss == pytest.approx(want_loss, rel=1e-5) and acc == want_acc


@pytest.mark.parametrize("pow2", [False, True])
def test_mobilenet_flat_row_is_fedtpus(flax_mobilenet, pow2):
    """Rows in flax's sorted leaf order (``DepthwiseSeparable_10`` before
    ``DepthwiseSeparable_2``, BatchNorm's ``bias`` before ``scale``) and
    layout, bit for bit: rotq mixes every coordinate of the row."""
    _, params, _ = flax_mobilenet
    rng = np.random.default_rng(3)
    stacked = jax.tree.map(
        lambda a: rng.normal(size=(CLIENTS,) + a.shape).astype(np.float32), params
    )
    jlay = jflat.make_layout(params, pow2=pow2)
    want = np.asarray(jflat.pack_stacked(jlay, jax.tree.map(jnp.asarray, stacked)))
    tstacked = from_flax(stacked)
    tlay = tflat.make_layout({k: v[0] for k, v in tstacked.items()}, pow2=pow2)
    got = tflat.pack_stacked(tlay, tstacked)
    assert (tlay.total, tlay.padded) == (MOBILENET_P, 2**22 if pow2 else 3_217_280)
    assert (tlay.offsets, tlay.sizes) == (jlay.offsets, jlay.sizes)
    names = list(tlay.names)
    assert names.index("DepthwiseSeparable_10.Conv_0.weight") < names.index(
        "DepthwiseSeparable_2.BatchNorm_0.bias"
    )
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    back = tflat.unpack_stacked(tlay, got)
    for k, v in tstacked.items():
        assert torch.equal(back[k], v), k
