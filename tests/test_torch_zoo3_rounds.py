"""EfficientNet-B0 rounds against fedtpu's: the full-width model of the
zoo's part 2b, the one whose train mode draws random numbers, through the
round and the per-leaf codecs.

As ``test_torch_zoo2_rounds.py`` holds ShuffleNetV2: ``Federation.step``
on explicit batches (2 clients, 2 steps of 8 examples of 8x8, one step
masked, a client dead in round 2), each round from fedtpu's state before
it, the global model in f64 in both packages (fedtpu under
``jax.enable_x64``), per-leaf ``topk`` (210 leaves: the grouped K1's plain
version in 3 groups of at most 77) and ``int8`` (3 groups of at most 90).
The port's round takes fedtpu's keep masks through
``RoundDraws.dropout_masks``: each client's step key is fedtpu's
(``split(fold_in(client_rng, round), steps)``) and ``torch_zoo.
fedtpu_masks`` draws what fedtpu's drop-connect and dropout draw under it.
Loss within ``rtol=1e-6``; params and ``batch_stats`` within ``atol=1e-5,
rtol=1e-4`` on all but 0.1% of coordinates (a last-bit difference of an
f64 delta can round to another f32 and so cross a top-k threshold or an
int8 step).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedtpu import config as jconfig
from fedtpu import models as jmodels
from fedtpu.core import round as jround
from fedtpu.ops import compression as jcomp
from fedtpu_torch import config as tconfig
from fedtpu_torch import models as tmodels
from fedtpu_torch.convert import to_flax
from fedtpu_torch.core import round as tround
from fedtpu_torch.core.engine import Federation as TFederation
from fedtpu_torch.ops import compression as tcomp
from fedtpu_torch.ops import kernels
from torch_mobilenet import _count_beyond, _f64, _port_state
from torch_zoo import fedtpu_masks, flax_variables, one_torch_thread  # noqa: F401 (an autouse fixture)

# 8x8 images: fedtpu's compiled f64 round spends its time in XLA's grouped
# convolutions on the CPU (56 s a round at 32x32 and batch 4). From the
# fourth stage on the maps are 1x1: batch 8 keeps 8 values a channel for
# BatchNorm (over 4, the two packages' f64 losses part by 3e-6).
CLIENTS, STEPS, BATCH, SIZE = 2, 2, 8, (8, 8, 3)
LEAVES = 210
# codec -> (the grouped wrapper it calls, leaves a group, groups a round)
GROUPED = {
    "topk": ("threshold_feedback_grouped", kernels.THRESHOLD_GROUP_CAPACITY, 3),
    "int8": ("quantdequant_int8_grouped", kernels.INT8_GROUP_CAPACITY, 3),
}


def _configs(compression):
    return tuple(
        mod.RoundConfig(
            model="efficientnetb0", steps_per_round=STEPS,
            data=mod.DataConfig(dataset="cifar10", batch_size=BATCH, eval_batch_size=8,
                                partition="iid", augment=False),
            fed=mod.FedConfig(num_clients=CLIENTS, compression=compression),
        )
        for mod in (jconfig, tconfig)
    )


def _round_inputs(rng, r):
    x = rng.normal(size=(CLIENTS, STEPS, BATCH) + SIZE).astype(np.float32)
    y = rng.integers(0, 10, size=(CLIENTS, STEPS, BATCH)).astype(np.int32)
    step_mask = np.ones((CLIENTS, STEPS), bool)
    step_mask[1, 1] = False  # client 1's second step is padding
    weights = np.array([8.0, 4.0], np.float32)
    alive = np.array([True, r == 0])  # client 1 dies in round 2
    return x, y, step_mask, weights, alive


def _fedtpu_round_masks(model, client_rng, r):
    """fedtpu's keep masks of round ``r``, ``[clients, steps, batch, ...]``
    by module path: each client's key folded with the round, split into
    its steps' keys. Call it under ``jax.enable_x64`` as the round ran."""
    keys = [k for c in range(CLIENTS)
            for k in jax.random.split(jax.random.fold_in(jnp.asarray(client_rng[c]), r), STEPS)]
    masks = fedtpu_masks(model, BATCH, keys)
    return {k: torch.from_numpy(m.reshape((CLIENTS, STEPS) + m.shape[1:])) for k, m in masks.items()}


def _spied(compression, calls):
    """The port's codec, its grouped call recording the leaves it takes."""
    name, _, _ = GROUPED[compression]
    grouped = getattr(kernels, name)

    def spy(xs, per_rows):
        calls.append(len(xs))
        return grouped(xs, per_rows)

    if compression == "topk":
        return tcomp.make_topk(jconfig.FedConfig().topk_fraction, threshold=spy)
    return tcomp.make_int8(quantdequant=spy)


@pytest.mark.parametrize("compression", ["topk", "int8"])
def test_efficientnet_rounds_track_fedtpu(compression):
    params, stats = flax_variables("efficientnetb0", 10, SIZE, seed=6)
    jmodel = jmodels.create("efficientnetb0", num_classes=10)
    jcfg, tcfg = _configs(compression)
    rng = np.random.default_rng(7)
    batches = [_round_inputs(rng, r) for r in range(2)]
    states, losses, masks = [], [], []
    with torch.device("meta"):
        spec_model = tmodels.create("efficientnetb0", 10, SIZE)
    with jax.enable_x64(True):
        jcodec = jcomp.make_compressor(jcfg.fed)
        variables = {"params": _f64(params), "batch_stats": _f64(stats)}
        jstate = jround.init_state(
            SimpleNamespace(init=lambda *a, **k: variables), jcfg,
            jax.random.PRNGKey(0), None, jcodec,
        )
        jstep = jax.jit(jround.make_round_step(jmodel, jcfg, jcodec))
        states.append(jax.tree.map(np.asarray, jstate))
        for r, (x, y, sm, w, alive) in enumerate(batches):
            masks.append(_fedtpu_round_masks(spec_model, states[r].client_rng, r))
            jstate, jm = jstep(jstate, jround.RoundBatch(
                x=jnp.asarray(x), y=jnp.asarray(y), step_mask=jnp.asarray(sm),
                weights=jnp.asarray(w), alive=jnp.asarray(alive),
            ))
            states.append(jax.tree.map(np.asarray, jstate))
            losses.append(float(jm.loss))
    # Some examples' branches and some head entries are dropped.
    assert not all(bool(m.all()) for rm in masks for m in rm.values())
    calls = []
    data = (rng.normal(size=(16,) + SIZE).astype(np.float32),
            rng.integers(0, 10, size=16).astype(np.int32))
    draws = tround.RoundDraws(dropout_masks=lambda r: masks[r])
    tfed = TFederation(tcfg, seed=0, data=data, device="cpu", compressor=_spied(compression, calls),
                       draws=draws)
    for r, (x, y, sm, w, alive) in enumerate(batches):
        tfed.state = _port_state(states[r], r)
        tm = tfed.step(tround.RoundBatch(
            x=torch.from_numpy(x), y=torch.from_numpy(y), step_mask=torch.from_numpy(sm),
            weights=torch.from_numpy(w), alive=torch.from_numpy(alive),
        ))
        np.testing.assert_allclose(float(tm.loss), losses[r], rtol=1e-6)
        for name in ("params", "batch_stats"):
            bad, total = _count_beyond(to_flax(getattr(tfed.state, name)), getattr(states[r + 1], name))
            assert bad <= 0.001 * total, f"round {r} {name}: {bad} of {total} differ"
        assert tfed.state.params["Conv_0.weight"].dtype == torch.float64
    _, capacity, groups = GROUPED[compression]
    assert calls == [LEAVES, LEAVES]  # one grouped call a round, every leaf in it
    assert len(kernels._group_plan([1000] * LEAVES, None, capacity)) == groups
