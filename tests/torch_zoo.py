"""Shared helpers of the zoo's parity tests: fedtpu's variables for a
model, in numpy, from a seed; fedtpu's dropout keep masks for a key."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedtpu import models as jmodels

_SHAPES = {}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The module's torch ops on one CPU thread, the count restored after.
    With a thread per core in each of several test workers on one host,
    some of the zoo's f64 tests ran 14 to 250 times slower than alone;
    alone they take as long on one thread as on eight. Import it into a
    test module to apply it there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def image_shape(name):
    """The input fedtpu's benches give a model: MNIST for the MLPs."""
    return (28, 28, 1) if name.startswith("mlp") else (32, 32, 3)


def _shapes(name, classes, size, ctor):
    key = (name, classes, size, tuple(sorted(ctor.items())))
    if key not in _SHAPES:
        model = jmodels.create(name, num_classes=classes, **ctor)
        _SHAPES[key] = jax.eval_shape(
            lambda k: model.init(k, jnp.zeros((1,) + size), train=False), jax.random.PRNGKey(0)
        )
    return _SHAPES[key]


def flax_variables(name, classes, size, seed, **ctor):
    """``(params, batch_stats)`` of fedtpu's ``name`` (built with the
    constructor's keyword arguments ``ctor``) as nested numpy trees (``{}``
    for a model without statistics): kernels normal with variance 1 /
    fan_in, biases small, BatchNorm leaves away from their init (scale 1 +
    0.2 n, bias and mean 0.1 n, var in [0.5, 2])."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        normal = rng.standard_normal(s.shape, dtype=np.float32)
        if name == "kernel":
            return normal * np.float32(1 / np.sqrt(np.prod(s.shape[:-1])))
        if name == "scale":
            return 1 + np.float32(0.2) * normal
        if name == "var":
            return np.float32(0.5) + np.float32(1.5) * rng.random(s.shape, dtype=np.float32)
        return np.float32(0.1) * normal  # bias, mean

    shapes = _shapes(name, classes, size, ctor)
    return tuple(
        jax.tree_util.tree_map_with_path(leaf, shapes.get(c, {})) for c in ("params", "batch_stats")
    )


class _Draw(fnn.Module):
    """One random module's draw as fedtpu's drop-connect and flax's
    ``Dropout`` make it: ``bernoulli(make_rng("dropout"), keep, shape)``."""

    @fnn.compact
    def __call__(self, keep, shape):
        return jax.random.bernoulli(self.make_rng("dropout"), keep, shape)


class _Draws(fnn.Module):
    """A ``_Draw`` at each random module's path: flax derives a module's
    ``make_rng`` key from the apply's key and the module's path alone, so
    these are the masks fedtpu's model draws under the same key, without
    running its forward."""

    specs: tuple

    @fnn.compact
    def __call__(self):
        return {name: _Draw(name=name)(keep, shape) for name, shape, keep in self.specs}


def fedtpu_masks(model, batch, keys):
    """fedtpu's keep masks for the port's ``model`` (its ``mask_specs``) at
    ``batch`` examples, one set per key of ``keys`` (each an apply's
    ``rngs={"dropout": key}``), stacked: ``{path: [len(keys), batch,
    ...]}`` numpy bools. Call it in the x64 mode of the apply it stands
    for: jax draws the uniforms in the dtype of ``keep``."""
    specs = tuple((name, (batch,) + tuple(spec.shape), spec.keep) for name, spec in model.mask_specs().items())
    draws = [_Draws(specs).apply({}, rngs={"dropout": key}) for key in keys]
    return {name: np.stack([np.asarray(d[name]) for d in draws]) for name, _, _ in specs}
