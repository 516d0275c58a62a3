"""Shared fixture and helpers of the MobileNet parity tests
(``test_torch_mobilenet.py``, ``test_torch_mobilenet_rounds.py``) and of
the zoo's round tests: fedtpu's MobileNet and its variables, both
packages' round configurations, and fedtpu's round state as the port's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedtpu import config as jconfig
from fedtpu import models as jmodels
from fedtpu_torch import config as tconfig
from fedtpu_torch.convert import from_flax
from fedtpu_torch.core import round as tround
from test_torch_round import _beyond_tolerance

CLIENTS, STEPS, BATCH = 2, 2, 4


def _perturb(rng):
    """BatchNorm leaves away from their init (scale 1, bias 0, mean 0,
    var 1), so that a swapped or misnamed leaf shows."""

    def leaf(path, a):
        name, owner = path[-1].key, path[-2].key
        if not owner.startswith("BatchNorm"):
            return a
        if name == "scale":
            return (1 + 0.2 * rng.normal(size=a.shape)).astype(np.float32)
        if name in ("bias", "mean"):
            return (0.1 * rng.normal(size=a.shape)).astype(np.float32)
        return rng.uniform(0.5, 2.0, size=a.shape).astype(np.float32)  # var

    return leaf


@pytest.fixture(scope="module")
def flax_mobilenet():
    """fedtpu's MobileNet and its variables (numpy), BatchNorm leaves
    perturbed."""
    model = jmodels.create("mobilenet", num_classes=10)
    variables = jax.jit(lambda k: model.init(k, jnp.zeros((1, 32, 32, 3)), train=False))(
        jax.random.PRNGKey(0)
    )
    leaf = _perturb(np.random.default_rng(0))
    params = jax.tree_util.tree_map_with_path(leaf, jax.tree.map(np.asarray, variables["params"]))
    stats = jax.tree_util.tree_map_with_path(leaf, jax.tree.map(np.asarray, variables["batch_stats"]))
    return model, params, stats


def _configs(compression, delta_layout):
    kw = dict(
        model="mobilenet", steps_per_round=STEPS,
        data=dict(dataset="cifar10", batch_size=BATCH, eval_batch_size=8,
                  partition="iid", augment=False),
        fed=dict(num_clients=CLIENTS, compression=compression, delta_layout=delta_layout),
    )
    return tuple(
        mod.RoundConfig(
            model=kw["model"], steps_per_round=kw["steps_per_round"],
            data=mod.DataConfig(**kw["data"]), fed=mod.FedConfig(**kw["fed"]),
        )
        for mod in (jconfig, tconfig)
    )


def _count_beyond(got_tree, want_tree, atol=1e-5):
    """(coordinates beyond ``atol``, rtol=1e-4, coordinates)."""
    bad = total = 0
    for (path, want), got in zip(
        jax.tree_util.tree_leaves_with_path(want_tree), jax.tree.leaves(got_tree)
    ):
        assert got.shape == want.shape, jax.tree_util.keystr(path)
        bad += int(_beyond_tolerance(got, np.asarray(want), atol=atol).sum())
        total += want.size
    return bad, total


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _port_state(jstate, round_idx):
    """fedtpu's state as the port's (the global model f64, the momentum and
    the codec's residuals f32, as fedtpu keeps them)."""
    comp = jstate.comp_state
    if isinstance(comp, dict):
        comp = from_flax(comp)
    elif not isinstance(comp, tuple):
        comp = torch.tensor(np.asarray(comp))
    return tround.FederatedState(
        params=from_flax(jstate.params),
        batch_stats=from_flax(jstate.batch_stats),
        opt_state=from_flax(jstate.opt_state.momentum),
        round_idx=round_idx,
        comp_state=comp,
    )
