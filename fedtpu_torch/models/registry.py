"""Model registry: a model is a config value, looked up by name.

The names are fedtpu's (``fedtpu.models.registry``), case-insensitive,
and every one of them is ported: the families of slice 7, parts 1 (MLP,
smallcnn, LeNet, MobileNet, ResNet, PreAct-ResNet, VGG, DenseNet), 2a
(MobileNetV2, GoogLeNet, ResNeXt-29, SENet-18, DPN, ShuffleNet,
ShuffleNetV2) and 2b (EfficientNet-B0, RegNetX/Y, PNASNet, DLA,
SimpleDLA). A name of fedtpu's zoo listed in ``NOT_PORTED`` (none now)
raises ``NotImplementedError`` naming its ROADMAP.md item; a name fedtpu
does not know raises ``KeyError``, as fedtpu's does.
"""

from __future__ import annotations

import inspect
from typing import Callable, Dict, Tuple

from torch import nn

from fedtpu_torch.config import not_ported

_REGISTRY: Dict[str, Callable[..., nn.Module]] = {}

# fedtpu's registered names still to port: none since slice 7, part 2b.
# The tests hold ported and unported names together to fedtpu's registry.
NOT_PORTED: Tuple[str, ...] = ()


def register(name: str):
    def deco(ctor: Callable[..., nn.Module]):
        _REGISTRY[name.lower()] = ctor
        return ctor

    return deco


def create(
    name: str,
    num_classes: int = 10,
    image_size: Tuple[int, int, int] = (32, 32, 3),
    remat: bool = False,
    **kwargs,
) -> nn.Module:
    """Build a model by registry name (case-insensitive) for NHWC inputs of
    ``image_size``; ``remat=True`` asks for per-block recompute, which only
    some models have (fedtpu's ``ValueError`` otherwise). Other keyword
    arguments go to the constructor, as fedtpu's ``create`` passes them
    (``create("shufflenetv2", net_size=0.5)``)."""
    key = name.lower()
    if key in NOT_PORTED:
        raise not_ported(f"model '{name}'", "slice 7")
    if key not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'; available: {available()}")
    ctor = _REGISTRY[key]
    kwargs.update(num_classes=num_classes, image_size=tuple(image_size))
    if "remat" in inspect.signature(ctor).parameters:
        kwargs["remat"] = remat
    elif remat:
        raise ValueError(
            f"model '{name}' does not support remat; models that do: "
            + str([n for n, c in sorted(_REGISTRY.items())
                   if "remat" in inspect.signature(c).parameters])
        )
    return ctor(**kwargs)


def available() -> list[str]:
    return sorted(_REGISTRY)
