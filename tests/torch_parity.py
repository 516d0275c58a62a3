"""Shared helpers of the port's parity tests: the same small config in
both packages, seeded data, and whole rounds of both engines held side by
side."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import torch

from fedtpu import config as jconfig
from fedtpu.core import round as jround
from fedtpu.core.engine import Federation as JFederation
from fedtpu_torch import config as tconfig
from fedtpu_torch.convert import from_flax, to_flax
from fedtpu_torch.core import round as tround
from fedtpu_torch.core.engine import Federation as TFederation


def bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def configs(data_kw=None, opt_kw=None, sim=None, screen=None, **fed_kw):
    """The same small config in both packages: smallcnn, 4 clients, batch
    8, 2 steps, no augmentation, f32; ``sim`` and ``screen`` are the
    fields of ``SimConfig`` and ``ScreenConfig``."""
    def build(mod):
        extra = {}
        if sim:
            extra["sim"] = mod.SimConfig(**sim)
        if screen:
            extra["screen"] = mod.ScreenConfig(**screen)
        return mod.RoundConfig(
            model="smallcnn",
            steps_per_round=2,
            opt=mod.OptimizerConfig(**(opt_kw or {})),
            data=mod.DataConfig(**{
                **dict(dataset="cifar10", batch_size=8, eval_batch_size=16,
                       partition="iid", augment=False),
                **(data_kw or {}),
            }),
            fed=mod.FedConfig(**{"num_clients": 4, **fed_kw, **extra}),
        )

    return build(jconfig), build(tconfig)


def seeded_data(seed, n=64):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, size=n).astype(np.int32))


def round_inputs(rng):
    x = rng.normal(size=(4, 2, 8, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=(4, 2, 8)).astype(np.int32)
    step_mask = np.ones((4, 2), bool)
    step_mask[3, 1] = False
    return x, y, step_mask


def track(jcfg, tcfg, rounds=2, draws=None, data_seed=20, alive=None, dp_draws=False):
    """``rounds`` rounds of both engines from the same init on the same
    explicit batches; params within atol=1e-5, rtol=1e-4."""
    data = seeded_data(data_seed)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jfed = JFederation(jcfg, seed=0, data=data)
        if dp_draws:
            draws = tround.RoundDraws(dp_noise=fedtpu_dp_noise(jfed, jcfg))
        tfed = TFederation(tcfg, seed=0, data=data, device="cpu", draws=draws)
    tfed.state = tfed.state._replace(params=from_flax(jax.tree.map(np.asarray, jfed.state.params)))
    rng = np.random.default_rng(data_seed)
    w = np.asarray(jfed.weights)
    alive = np.ones(4, bool) if alive is None else np.asarray(alive)
    for r in range(rounds):
        x, y, sm = round_inputs(rng)
        jm = jfed.step(jround.RoundBatch(x=jnp.asarray(x), y=jnp.asarray(y), step_mask=jnp.asarray(sm),
                                         weights=jnp.asarray(w), alive=jnp.asarray(alive)))
        tm = tfed.step(tround.RoundBatch(x=torch.from_numpy(x), y=torch.from_numpy(y),
                                         step_mask=torch.from_numpy(sm),
                                         weights=torch.from_numpy(w.copy()), alive=torch.from_numpy(alive)))
        np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=1e-5)
        got, want = to_flax(tfed.state.params), jax.tree.map(np.asarray, jfed.state.params)
        for mod in want:
            for leaf in want[mod]:
                np.testing.assert_allclose(got[mod][leaf], want[mod][leaf], atol=1e-5, rtol=1e-4,
                                           err_msg=f"round {r} {mod}/{leaf}")
        np.testing.assert_allclose(tfed.state.last_client_loss.numpy(),
                                   np.asarray(jfed.state.last_client_loss), rtol=1e-5)
    return jfed, tfed


def fedtpu_dp_noise(jfed, jcfg):
    """fedtpu's DP noise draws for a round, in the port's names and layout."""
    def draw(round_idx, tree):
        leaves, treedef = jax.tree_util.tree_flatten(jfed.state.params)
        base = jax.random.fold_in(jax.random.PRNGKey(jcfg.data.seed ^ 0x5F5E5F), jnp.int32(round_idx))
        keys = jax.random.split(base, len(leaves))
        normals = [np.asarray(jax.random.normal(k, l.shape, jnp.float32)) for k, l in zip(keys, leaves)]
        return from_flax(jax.tree_util.tree_unflatten(treedef, normals))

    return draw
