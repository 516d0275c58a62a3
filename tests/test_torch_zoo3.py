"""The port's zoo, slice 7 part 2b (EfficientNet-B0, RegNetX/Y, PNASNet,
DLA, SimpleDLA), against fedtpu's flax models.

Variables come from one numpy seed in the shapes of fedtpu's tree
(``jax.eval_shape`` of its init, no compile), as in ``test_torch_zoo.py``.

- All eight registered names: the torch parameter and buffer names and
  shapes are the flax tree's paths through ``from_flax``, and
  ``to_flax(from_flax(tree))`` is the tree, exactly.
- The sizes of fedtpu's own models (params, leaves, ``batch_stats``) are
  pinned, in both packages.
- Eval-mode logits in f32 within ``atol=1e-5 * max(1, max|logit|)``, rtol 0,
  for every model.
- No name of fedtpu's zoo is left unported: ``registry.NOT_PORTED`` is
  empty and the port's registry is fedtpu's.

Train mode is held in ``test_torch_zoo3_train.py``, EfficientNet-B0
rounds in ``test_torch_zoo3_rounds.py``.
"""

import jax
import numpy as np
import pytest
import torch

from fedtpu import models as jmodels
from fedtpu_torch import models as tmodels
from fedtpu_torch.convert import from_flax, to_flax
from fedtpu_torch.models import registry
from torch_zoo import flax_variables, one_torch_thread  # noqa: F401 (an autouse fixture)

# model -> (params, param leaves, batch_stats, stats leaves) at 10 classes:
# fedtpu's own sizes.
SIZES = {
    "efficientnetb0": (3_598_598, 210, 39_456, 96),
    "regnetx_200mf": (2_321_946, 134, 20_912, 88),
    "regnetx_400mf": (4_779_338, 215, 36_736, 142),
    "regnety_400mf": (5_714_362, 303, 36_736, 142),
    "pnasneta": (130_646, 71, 4_840, 46),
    "pnasnetb": (451_626, 251, 12_736, 166),
    "dla": (16_291_386, 131, 17_792, 86),
    "simpledla": (15_142_970, 119, 16_256, 78),
}
PART_2B = list(SIZES)

CIFAR = (32, 32, 3)


def _size(tree):
    leaves = jax.tree.leaves(tree)
    return sum(int(np.prod(a.shape)) for a in leaves), len(leaves)


@pytest.mark.parametrize("name", PART_2B)
def test_torch_names_and_shapes_are_the_flax_paths(name):
    params, stats = flax_variables(name, 10, CIFAR, seed=0)
    with torch.device("meta"):
        model = tmodels.create(name, 10, CIFAR)
    for tree, mine in ((params, model.named_parameters()), (stats, model.named_buffers())):
        assert {k: tuple(v.shape) for k, v in from_flax(tree).items()} == {
            k: tuple(v.shape) for k, v in mine
        }
        back = to_flax(from_flax(tree))
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tree), jax.tree.leaves(back)):
            np.testing.assert_array_equal(b, a, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", PART_2B)
def test_sizes_match_fedtpus(name):
    params, stats = flax_variables(name, 10, CIFAR, seed=0)
    want = SIZES[name]
    assert _size(params) + _size(stats) == want
    with torch.device("meta"):
        model = tmodels.create(name, 10)
    got = [list(model.parameters()), list(model.buffers())]
    assert (sum(p.numel() for p in got[0]), len(got[0]), sum(b.numel() for b in got[1]), len(got[1])) == want


def test_nothing_is_left_unported():
    """Every name of fedtpu's registry builds, by registry name and by its
    constructor, and the port registers no other."""
    assert registry.NOT_PORTED == ()
    assert tmodels.available() == jmodels.available()
    for name, ctor in (("efficientnetb0", "EfficientNetB0"), ("regnetx_200mf", "RegNetX_200MF"),
                       ("regnetx_400mf", "RegNetX_400MF"), ("regnety_400mf", "RegNetY_400MF"),
                       ("pnasneta", "PNASNetA"), ("pnasnetb", "PNASNetB"), ("dla", "DLA"),
                       ("simpledla", "SimpleDLA")):
        with torch.device("meta"):
            by_name, by_ctor = tmodels.create(name), getattr(tmodels, ctor)()
        assert [n for n, _ in by_name.named_parameters()] == [n for n, _ in by_ctor.named_parameters()]


def test_block_names_follow_flax_numbering():
    """flax numbers each class's submodules in the order it creates them:
    EfficientNet's expand conv is ``Conv_0`` only at expansion > 1; a
    RegNetY block's SE convs come before its last 1x1; PNASNet-B's
    downsampling cell creates its pool branch's conv before ``SepConv_2``;
    a level-2 DLA tree is ``BasicBlock_0``, ``Tree_0``, ``BasicBlock_1``,
    ``BasicBlock_2``, ``Root_0`` over four inputs."""
    eff = tmodels.EfficientNetB0()
    assert eff.MBConv_0.Conv_0.weight.shape == (32, 1, 3, 3)      # expansion 1: the depthwise
    assert eff.MBConv_0.Conv_1.weight.shape == (8, 32, 1, 1)      # SE: int(32 * 0.25)
    assert eff.MBConv_1.Conv_0.weight.shape == (96, 16, 1, 1)     # the expand
    assert eff.MBConv_1.Conv_2.bias.shape == (4,)                 # SE from the block's input 16
    assert eff.MBConv_15.Conv_4.weight.shape == (320, 1152, 1, 1)
    assert list(eff.mask_specs()) == [f"MBConv_{b}" for b in (2, 4, 6, 7, 9, 10, 12, 13, 14)] + ["Dropout_0"]
    assert eff.mask_specs()["MBConv_14"].keep == 1.0 - 0.2 * 14 / 16
    y = tmodels.RegNetY_400MF()
    assert y.RegNetBlock_0.Conv_1.groups == 2 and y.RegNetBlock_0.Conv_2.bias.shape == (16,)  # round(64 * 0.25)
    assert y.RegNetBlock_0.Conv_4.weight.shape == (32, 32, 1, 1)
    assert y.RegNetBlock_0.Conv_5.weight.shape == (32, 64, 1, 1)  # the shortcut, last
    assert not hasattr(y.RegNetBlock_2, "Conv_5")  # 64 -> 64, stride 1
    x = tmodels.RegNetX_200MF()
    assert x.RegNetBlock_12.Conv_1.groups == 46 and x.RegNetBlock_12.Conv_2.weight.shape == (368, 368, 1, 1)
    b = tmodels.PNASNetB()
    assert b.CellB_6.SepConv_0.Conv_0.weight.shape == (64, 1, 7, 7)  # stride 2: two outputs a group
    assert b.CellB_6.Conv_0.weight.shape == (64, 32, 1, 1)           # the pool branch's conv
    assert b.CellB_6.Conv_1.weight.shape == (64, 128, 1, 1)          # the concatenation's
    assert b.CellB_0.Conv_0.weight.shape == (32, 64, 1, 1)
    dla = tmodels.DLA()
    assert dla.Tree_1.Tree_0.BasicBlock_0.Conv_0.weight.shape == (128, 64, 3, 3)
    assert dla.Tree_1.BasicBlock_0.Conv_2.weight.shape == (128, 64, 1, 1)
    assert dla.Tree_1.Root_0.Conv_0.weight.shape == (128, 512, 1, 1)
    assert dla.Tree_0.Root_0.Conv_0.weight.shape == (64, 128, 1, 1)
    simple = tmodels.SimpleDLA()
    assert simple.SimpleTree_2.SimpleTree_1.BasicBlock_0.Conv_0.weight.shape == (256, 256, 3, 3)
    assert simple.SimpleTree_2.Root_0.Conv_0.weight.shape == (256, 512, 1, 1)


# (model, image size) of the eval-mode comparison: every model, each at
# an image that leaves its last map at least 2x2 (1x1 for EfficientNet).
EVAL_CASES = [
    ("efficientnetb0", (16, 16, 3)),
    ("regnetx_200mf", (8, 8, 3)),
    ("regnetx_400mf", (8, 8, 3)),
    ("regnety_400mf", (8, 8, 3)),
    ("pnasneta", (8, 8, 3)),
    ("pnasnetb", (8, 8, 3)),
    ("dla", (16, 16, 3)),
    ("simpledla", (16, 16, 3)),
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
