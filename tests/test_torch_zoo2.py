"""The port's zoo, slice 7 part 2a (MobileNetV2, GoogLeNet, ResNeXt-29,
SENet-18, DPN, ShuffleNet, ShuffleNetV2), against fedtpu's flax models.

Variables come from one numpy seed in the shapes of fedtpu's tree
(``jax.eval_shape`` of its init, no compile), as in ``test_torch_zoo.py``.

- Every registered name of these families, and ``ShuffleNetV2`` at each
  ``net_size``: the torch parameter and buffer names and shapes are the
  flax tree's paths through ``from_flax``, and ``to_flax(from_flax(tree))``
  is the tree, exactly.
- The sizes of fedtpu's own models (params, leaves, ``batch_stats``) are
  pinned, in both packages.
- Eval-mode logits in f32 within ``atol=1e-5 * max(1, max|logit|)``, rtol 0,
  for one model of each family, both ShuffleNets and ``resnext29_32x4d``.
- ``channel_shuffle`` and the padded pools (3x3 max and average, stride 1
  and 2, padding 1) bit-equal to fedtpu's and flax's.

Train mode is held in ``test_torch_zoo2_train.py``, ShuffleNetV2 rounds
in ``test_torch_zoo2_rounds.py``; part 2b in ``test_torch_zoo3*.py``.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedtpu import models as jmodels
from fedtpu.models.shufflenet import channel_shuffle as j_channel_shuffle
from fedtpu_torch import models as tmodels
from fedtpu_torch.convert import from_flax, to_flax
from fedtpu_torch.models import common, registry
from torch_zoo import flax_variables, one_torch_thread  # noqa: F401 (an autouse fixture)

PART_2A = [
    "mobilenetv2", "googlenet",
    "resnext29_2x64d", "resnext29_4x64d", "resnext29_8x64d", "resnext29_32x4d",
    "senet18", "dpn26", "dpn92", "shufflenetg2", "shufflenetg3", "shufflenetv2",
]
PART_2B = [
    "efficientnetb0", "regnetx_200mf", "regnetx_400mf", "regnety_400mf",
    "pnasneta", "pnasnetb", "dla", "simpledla",
]
# (registry name, constructor keyword arguments)
NAME_CASES = [(n, {}) for n in PART_2A] + [("shufflenetv2", {"net_size": s}) for s in (0.5, 1.5, 2)]

# model -> (params, param leaves, batch_stats, stats leaves) at 10 classes:
# fedtpu's own sizes.
SIZES = {
    "mobilenetv2": (2_296_922, 173, 35_088, 114),
    "googlenet": (6_166_250, 258, 15_808, 128),
    "resnext29_2x64d": (9_128_778, 95, 25_216, 62),
    "resnext29_32x4d": (4_774_218, 95, 25_216, 62),
    "senet18": (11_260_354, 88, 6_912, 34),
    "dpn26": (11_574_842, 89, 35_888, 58),
    "dpn92": (34_236_634, 287, 113_328, 190),
    "shufflenetg2": (887_582, 149, 19_776, 98),
    "shufflenetg3": (862_768, 149, 23_736, 98),
    "shufflenetv2": (1_263_854, 170, 16_180, 112),
}

CIFAR = (32, 32, 3)


def _size(tree):
    leaves = jax.tree.leaves(tree)
    return sum(int(np.prod(a.shape)) for a in leaves), len(leaves)


@pytest.mark.parametrize("name,ctor", NAME_CASES, ids=lambda v: str(v))
def test_torch_names_and_shapes_are_the_flax_paths(name, ctor):
    params, stats = flax_variables(name, 10, CIFAR, seed=0, **ctor)
    with torch.device("meta"):
        model = tmodels.create(name, 10, CIFAR, **ctor)
    for tree, mine in ((params, model.named_parameters()), (stats, model.named_buffers())):
        assert {k: tuple(v.shape) for k, v in from_flax(tree).items()} == {
            k: tuple(v.shape) for k, v in mine
        }
        back = to_flax(from_flax(tree))
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tree), jax.tree.leaves(back)):
            np.testing.assert_array_equal(b, a, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", list(SIZES))
def test_sizes_match_fedtpus(name):
    params, stats = flax_variables(name, 10, CIFAR, seed=0)
    want = SIZES[name]
    assert _size(params) + _size(stats) == want
    with torch.device("meta"):
        model = tmodels.create(name, 10)
    got = [list(model.parameters()), list(model.buffers())]
    assert (sum(p.numel() for p in got[0]), len(got[0]), sum(b.numel() for b in got[1]), len(got[1])) == want


def test_not_ported_is_part_2b():
    """Part 2a builds by registry name, and so, since it was ported
    (``test_torch_zoo3.py``), does part 2b, the last of fedtpu's zoo:
    nothing is left in ``registry.NOT_PORTED``."""
    assert registry.NOT_PORTED == ()
    assert set(PART_2A) | set(PART_2B) <= set(tmodels.available())
    for name in PART_2B:
        with torch.device("meta"):
            assert isinstance(tmodels.create(name), torch.nn.Module)


def test_create_passes_constructor_arguments_through():
    """As fedtpu's ``create`` does: ``net_size`` reaches ``ShuffleNetV2``,
    and an argument the constructor lacks is a ``TypeError``."""
    half = tmodels.create("shufflenetv2", net_size=0.5)
    assert half.Conv_1.weight.shape == (1024, 192, 1, 1)
    assert tmodels.ShuffleNetV2(2).Conv_1.weight.shape == (2048, 976, 1, 1)
    with pytest.raises(TypeError):
        tmodels.create("googlenet", net_size=0.5)


def test_block_names_follow_flax_numbering():
    """flax numbers each block class across the stages and creates a
    shortcut projection last; the head convs are the module's second."""
    v2 = tmodels.ShuffleNetV2()
    names = {n.split(".")[0] for n, _ in v2.named_parameters()}
    assert names == ({f"DownBlock_{i}" for i in range(3)} | {f"SplitBlock_{i}" for i in range(13)}
                     | {"Conv_0", "BatchNorm_0", "Conv_1", "BatchNorm_1", "Dense_0"})
    assert v2.DownBlock_1.Conv_0.weight.shape == (116, 1, 3, 3)   # left, depthwise over the input
    assert v2.DownBlock_1.Conv_2.weight.shape == (116, 116, 1, 1)  # right's first 1x1
    assert v2.SplitBlock_3.Conv_1.weight.shape == (116, 1, 3, 3)
    mv2 = tmodels.MobileNetV2()
    assert mv2.InvertedResidual_0.Conv_3.weight.shape == (16, 32, 1, 1)  # stride 1, 32 -> 16
    assert not hasattr(mv2.InvertedResidual_3, "Conv_3")  # stride 2: no shortcut
    assert mv2.InvertedResidual_16.Conv_1.weight.shape == (960, 1, 3, 3)
    assert mv2.Conv_1.weight.shape == (1280, 320, 1, 1)
    se = tmodels.SENet18()
    assert se.SEPreActBlock_2.Conv_0.weight.shape == (128, 64, 1, 1)  # the shortcut
    assert se.SEPreActBlock_0.Conv_0.weight.shape == (64, 64, 3, 3)   # no shortcut
    assert se.SEPreActBlock_7.SEGate_0.Conv_0.bias.shape == (32,)
    g3 = tmodels.ShuffleNetG3()
    assert g3.ShuffleBottleneck_0.Conv_0.weight.shape == (54, 24, 1, 1)  # stem-fed: 1 group
    assert g3.ShuffleBottleneck_0.Conv_2.weight.shape == (216, 18, 1, 1)  # 3 groups of 18
    assert g3.ShuffleBottleneck_4.Conv_0.weight.shape == (60, 80, 1, 1)
    dpn = tmodels.DPN26()
    # Stage 1: 256 + 2 * 16 after its first block, + 16 after its second.
    assert dpn.DualPathBlock_1.Conv_0.weight.shape == (96, 288, 1, 1)
    assert dpn.DualPathBlock_2.Conv_3.weight.shape == (544, 304, 1, 1)
    assert dpn.Dense_0.weight.shape == (10, 2048 + 3 * 128)
    gn = tmodels.GoogLeNet()
    assert gn.Inception_8.Conv_6.weight.shape == (128, 832, 1, 1)
    assert gn.Inception_0.Conv_5.bias.shape == (32,)


# (model, image size) of the eval-mode comparison: one model of each
# family, both ShuffleNets and ResNeXt's widest cardinality.
EVAL_CASES = [
    ("mobilenetv2", (16, 16, 3)),
    ("googlenet", (8, 8, 3)),
    ("resnext29_2x64d", (8, 8, 3)),
    ("resnext29_32x4d", (8, 8, 3)),
    ("senet18", (8, 8, 3)),
    ("dpn26", (8, 8, 3)),
    ("shufflenetg2", (16, 16, 3)),
    ("shufflenetg3", (16, 16, 3)),
    ("shufflenetv2", (16, 16, 3)),
]


@pytest.mark.parametrize("name,size", EVAL_CASES, ids=lambda v: str(v))
def test_eval_logits_match_fedtpu(name, size):
    params, stats = flax_variables(name, 10, size, seed=1)
    x = np.random.default_rng(2).normal(size=(3,) + size).astype(np.float32)
    jmodel = jmodels.create(name, num_classes=10)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, x
    ))
    model = tmodels.create(name, 10, size)
    with torch.no_grad():
        got = torch.func.functional_call(
            model, (from_flax(params), from_flax(stats)), (torch.from_numpy(x),)
        ).numpy()
    assert got.shape == want.shape == (3, 10)
    np.testing.assert_allclose(got, want, atol=1e-5 * max(1.0, float(np.abs(want).max())), rtol=0)


@pytest.mark.parametrize("groups", [2, 3])
def test_channel_shuffle_is_fedtpus(groups):
    x = np.random.default_rng(groups).normal(size=(2, 5, 4, 6 * groups)).astype(np.float32)
    want = np.asarray(j_channel_shuffle(jnp.asarray(x), groups))
    got = common.channel_shuffle(torch.from_numpy(x).permute(0, 3, 1, 2), groups).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["max", "avg"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("shape", [(2, 9, 9, 5), (3, 8, 8, 4)], ids=str)
def test_padded_pools_are_flaxs(kind, stride, shape):
    """3x3 windows, padding 1 on each side: max pads with -inf, the
    average counts the padding (flax's ``count_include_pad=True``); the
    input's signs mixed so that a window of negatives shows the padding."""
    x = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    pad = ((1, 1), (1, 1))
    if kind == "max":
        want = fnn.max_pool(jnp.asarray(x), (3, 3), strides=(stride, stride), padding=pad)
        port = common.max_pool
    else:
        want = fnn.avg_pool(jnp.asarray(x), (3, 3), strides=(stride, stride), padding=pad)
        port = common.avg_pool
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2), 3, stride, padding=1).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
