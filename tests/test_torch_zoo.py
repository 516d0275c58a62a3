"""The port's zoo, slice 7 part 1 (MLP, LeNet, smallcnn_avgpool, ResNet,
PreAct-ResNet, VGG, DenseNet), against fedtpu's flax models.

Variables come from one numpy seed in the shapes of fedtpu's tree
(``jax.eval_shape`` of its init): kernels at a lecun-like scale, BatchNorm
leaves away from their init, so that a swapped or misnamed leaf shows.

- Every registered model of these families: its torch parameter and
  buffer names and shapes are the flax tree's paths through ``from_flax``,
  and ``to_flax(from_flax(tree))`` is the tree, exactly.
- The sizes of fedtpu's own models (params, leaves, ``batch_stats``) are
  pinned, in both packages.
- Eval-mode logits in f32 within ``atol=1e-5 * max(1, max|logit|)``, rtol 0
  (convolutions sum in another order; XLA's CPU ``rsqrt`` is not correctly
  rounded, torch's is). VGG at 64x64, where its last map is 2x2 and the
  flatten order before ``Dense_0`` shows.
- ``remat=True`` only where fedtpu has it.
- The constructor surface mirrors fedtpu's
  (``tests/test_models.py::test_constructor_surface_matches_reference``);
  a name still in ``registry.NOT_PORTED`` (none since part 2b) raises
  ``NotImplementedError`` naming ROADMAP slice 7.

Train mode (logits, statistics, a step's gradient in f64, remat) is held
in ``test_torch_zoo_train.py``, whole rounds in
``test_torch_zoo_rounds.py``.
"""

import jax
import numpy as np
import pytest
import torch

from fedtpu import models as jmodels
from fedtpu_torch import models as tmodels
from fedtpu_torch.convert import from_flax, to_flax
from fedtpu_torch.models import registry
from torch_zoo import flax_variables, image_shape

# fedtpu's registered names of the families this slice ports.
PORTED = [
    "densenet121", "densenet161", "densenet169", "densenet201", "densenet_cifar",
    "lenet", "mlp", "mlp_tiny",
    "preactresnet18", "preactresnet34", "preactresnet50", "preactresnet101", "preactresnet152",
    "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
    "smallcnn_avgpool", "vgg", "vgg11", "vgg13", "vgg16", "vgg19",
]

# (model, classes) -> (params, param leaves, batch_stats, stats leaves):
# fedtpu's own sizes.
SIZES = {
    ("resnet18", 100): (11_220_132, 62, 9_600, 40),
    ("resnet50", 100): (23_705_252, 161, 53_120, 106),
    ("preactresnet18", 10): (11_171_146, 54, 6_784, 32),
    ("vgg19", 10): (20_040_522, 66, 11_008, 32),
    ("densenet_cifar", 10): (1_000_618, 362, 31_320, 240),
    ("mlp", 10): (203_530, 4, 0, 0),
    ("lenet", 10): (62_006, 10, 0, 0),
}


def _size(tree):
    leaves = jax.tree.leaves(tree)
    return sum(int(np.prod(a.shape)) for a in leaves), len(leaves)


@pytest.mark.parametrize("name", PORTED)
def test_torch_names_and_shapes_are_the_flax_paths(name):
    params, stats = flax_variables(name, 10, image_shape(name), seed=0)
    with torch.device("meta"):
        model = tmodels.create(name, 10, image_shape(name))
    for tree, mine in ((params, model.named_parameters()), (stats, model.named_buffers())):
        assert {k: tuple(v.shape) for k, v in from_flax(tree).items()} == {
            k: tuple(v.shape) for k, v in mine
        }
        back = to_flax(from_flax(tree))
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tree), jax.tree.leaves(back)):
            np.testing.assert_array_equal(b, a, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name,classes", list(SIZES), ids=[f"{n}-{c}" for n, c in SIZES])
def test_sizes_match_fedtpus(name, classes):
    params, stats = flax_variables(name, classes, image_shape(name), seed=0)
    want = SIZES[(name, classes)]
    assert _size(params) + _size(stats) == want
    with torch.device("meta"):
        model = tmodels.create(name, classes, image_shape(name))
    got = [list(model.parameters()), list(model.buffers())]
    assert (sum(p.numel() for p in got[0]), len(got[0]), sum(b.numel() for b in got[1]), len(got[1])) == want


def test_densenet_layers_are_numbered_across_stages():
    """flax numbers ``DenseLayer_i`` across the four stages (6 + 12 + 24 +
    16 = 58 layers) and ``Transition_0..2`` between them; the final
    BatchNorm is the module's own ``BatchNorm_0``."""
    model = tmodels.densenet_cifar()
    names = {n.split(".")[0] for n, _ in model.named_parameters()}
    assert {f"DenseLayer_{i}" for i in range(58)} <= names
    assert {"Transition_0", "Transition_1", "Transition_2", "BatchNorm_0"} <= names
    assert "DenseLayer_58" not in names and "Transition_3" not in names
    # Stage 2's first layer takes the first transition's output: 24 + 6 * 12 = 96 -> 48.
    assert model.DenseLayer_6.BatchNorm_0.scale.shape == (48,)


def test_preact_shortcut_is_the_first_conv_of_a_downsampling_block():
    model = tmodels.PreActResNet18()
    assert model.PreActBlock_2.Conv_0.weight.shape == (128, 64, 1, 1)   # the shortcut
    assert model.PreActBlock_2.Conv_1.weight.shape == (128, 64, 3, 3)
    assert model.PreActBlock_0.Conv_0.weight.shape == (64, 64, 3, 3)    # no shortcut
    assert not hasattr(model.PreActBlock_0, "Conv_2")


def test_resnet_shortcut_is_created_last():
    model = tmodels.ResNet18()
    assert model.BasicBlock_2.Conv_2.weight.shape == (128, 64, 1, 1)
    assert model.BasicBlock_2.BatchNorm_2.scale.shape == (128,)
    bottleneck = tmodels.ResNet50().Bottleneck_0
    assert bottleneck.Conv_3.weight.shape == (256, 64, 1, 1)


# (model, classes, image size) of the eval-mode comparison.
EVAL_CASES = [
    ("mlp", 10, (28, 28, 1)),
    ("mlp_tiny", 10, (28, 28, 1)),
    ("lenet", 10, (32, 32, 3)),
    ("lenet", 10, (28, 28, 1)),
    ("smallcnn_avgpool", 10, (32, 32, 3)),
    ("resnet18", 100, (8, 8, 3)),
    ("resnet50", 100, (8, 8, 3)),
    ("preactresnet18", 10, (8, 8, 3)),
    ("preactresnet50", 10, (8, 8, 3)),
    ("vgg11", 10, (64, 64, 3)),
    ("densenet_cifar", 10, (16, 16, 3)),
]


@pytest.mark.parametrize("name,classes,size", EVAL_CASES, ids=lambda v: str(v))
def test_eval_logits_match_fedtpu(name, classes, size):
    params, stats = flax_variables(name, classes, size, seed=1)
    x = np.random.default_rng(2).normal(size=(3,) + size).astype(np.float32)
    jmodel = jmodels.create(name, num_classes=classes)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats} if stats else {"params": params}, x
    ))
    model = tmodels.create(name, classes, size)
    with torch.no_grad():
        got = torch.func.functional_call(
            model, (from_flax(params), from_flax(stats)), (torch.from_numpy(x),)
        ).numpy()
    assert got.shape == want.shape == (3, classes)
    np.testing.assert_allclose(got, want, atol=1e-5 * max(1.0, float(np.abs(want).max())), rtol=0)


def test_remat_is_refused_where_fedtpu_refuses_it():
    with pytest.raises(ValueError, match="does not support remat"):
        tmodels.create("densenet_cifar", remat=True)
    with pytest.raises(ValueError, match="does not support remat"):
        tmodels.create("vgg11", remat=True)


# fedtpu's test_constructor_surface_matches_reference list.
REFERENCE_CONSTRUCTORS = [
    "MobileNet", "MobileNetV2", "ResNet18", "ResNet34", "ResNet50", "ResNet101",
    "ResNet152", "PreActResNet18", "VGG", "GoogLeNet", "DenseNet121",
    "densenet_cifar", "ResNeXt29_2x64d", "SENet18", "DPN26", "DPN92",
    "ShuffleNetG2", "ShuffleNetG3", "ShuffleNetV2", "EfficientNetB0",
    "RegNetX_200MF", "RegNetY_400MF", "PNASNetA", "PNASNetB", "DLA",
    "SimpleDLA", "LeNet",
]


@pytest.mark.parametrize("ctor", REFERENCE_CONSTRUCTORS)
def test_constructor_surface_matches_fedtpus(ctor):
    """A reference constructor of the ported families exists under its
    name and builds fedtpu's model; one of slice 7 part 2 raises naming its
    ROADMAP item, by constructor name and by registry name."""
    if ctor.lower() in registry.NOT_PORTED:
        assert not hasattr(tmodels, ctor)
        with pytest.raises(NotImplementedError, match="ROADMAP.*slice 7, part 2"):
            tmodels.create(ctor)
        return
    assert hasattr(tmodels, ctor), ctor
    built = tmodels.VGG("VGG19") if ctor == "VGG" else getattr(tmodels, ctor)()
    key = "vgg19" if ctor == "VGG" else ctor
    assert [n for n, _ in built.named_parameters()] == [
        n for n, _ in tmodels.create(key).named_parameters()
    ]


def test_registry_is_fedtpus_zoo():
    """Ported and not-yet-ported names together are fedtpu's registry, and
    a name fedtpu does not know is a ``KeyError`` in both."""
    assert not set(tmodels.available()) & set(registry.NOT_PORTED)
    assert sorted(tmodels.available() + list(registry.NOT_PORTED)) == jmodels.available()
    assert set(PORTED) <= set(tmodels.available())
    for mod in (jmodels, tmodels):
        with pytest.raises(KeyError, match="unknown model"):
            mod.create("alexnet")


def test_vgg_flattens_channels_last():
    """At 64x64 VGG's last map is 2x2x512: ``Dense_0`` takes 2048 features
    in (H, W, C) order, fedtpu's kernel transposed."""
    model = tmodels.VGG("VGG11", image_size=(64, 64, 3))
    assert model.Dense_0.weight.shape == (10, 2048)
    params, _ = flax_variables("vgg11", 10, (64, 64, 3), seed=3)
    assert from_flax(params)["Dense_0.weight"].shape == (10, 2048)
    np.testing.assert_array_equal(from_flax(params)["Dense_0.weight"].numpy(), params["Dense_0"]["kernel"].T)


def test_models_default_to_fedtpus_input():
    """Without an image size each model takes the input fedtpu's bench
    gives it: MNIST for the MLPs, CIFAR for the rest."""
    assert tmodels.MLP().Dense_0.weight.shape == (256, 784)
    assert tmodels.LeNet().Dense_0.weight.shape == (120, 400)
    assert tmodels.create("lenet", 10, (28, 28, 1)).Dense_0.weight.shape == (120, 256)
    x = torch.zeros((2, 32, 32, 3))
    for ctor in (tmodels.ResNet18, tmodels.PreActResNet18, tmodels.densenet_cifar):
        assert ctor(num_classes=100)(x).shape == (2, 100)
