"""The port's smallcnn and parameter converter against fedtpu's flax model.

- ``from_flax`` / ``to_flax`` round-trip every leaf exactly;
- the port's logits on converted params match flax's within
  ``atol=rtol=1e-5`` in f32 (convolutions sum in another order). This also
  pins the flatten order before ``Dense_0``: flax flattens (H, W, C), and
  the port flattens channels-last too, so ``Dense_0`` is only transposed;
- the loss matches fedtpu's within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedtpu import models as jmodels
from fedtpu.ops.losses import softmax_ce_int_labels as j_ce
from fedtpu_torch import models as tmodels
from fedtpu_torch.convert import from_flax, to_flax
from fedtpu_torch.ops.losses import softmax_ce_int_labels as t_ce


def _flax_smallcnn(image_size, seed=0):
    model = jmodels.create("smallcnn", num_classes=10)
    params = model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1,) + image_size), train=False
    )["params"]
    return model, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("image_size", [(32, 32, 3), (28, 28, 1)])
def test_from_flax_to_flax_round_trip_is_exact(image_size):
    _, params = _flax_smallcnn(image_size)
    back = to_flax(from_flax(params))
    assert back.keys() == params.keys()
    for mod in params:
        assert back[mod].keys() == params[mod].keys()
        for leaf in params[mod]:
            np.testing.assert_array_equal(back[mod][leaf], params[mod][leaf])


def test_converted_names_and_shapes_match_the_torch_model():
    _, params = _flax_smallcnn((32, 32, 3))
    converted = from_flax(params)
    model = tmodels.create("smallcnn", 10, (32, 32, 3))
    want = {k: tuple(v.shape) for k, v in model.named_parameters()}
    assert {k: tuple(v.shape) for k, v in converted.items()} == want


@pytest.mark.parametrize("image_size", [(32, 32, 3), (28, 28, 1)])
def test_smallcnn_logits_match_flax(image_size):
    jmodel, params = _flax_smallcnn(image_size, seed=3)
    x = np.random.default_rng(0).normal(size=(8,) + image_size).astype(np.float32)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x), train=False))
    tmodel = tmodels.create("smallcnn", 10, image_size)
    got = torch.func.functional_call(tmodel, from_flax(params), (torch.from_numpy(x),))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=1e-5)


def test_softmax_ce_matches_fedtpu():
    rng = np.random.default_rng(1)
    logits = (3 * rng.normal(size=(16, 10))).astype(np.float32)
    labels = rng.integers(0, 10, size=16).astype(np.int32)
    want = np.asarray(j_ce(jnp.asarray(logits), jnp.asarray(labels)))
    got = t_ce(torch.from_numpy(logits), torch.from_numpy(labels)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_unported_model_names_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmodels.create("MobileNet")
