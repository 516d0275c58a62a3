"""Model registry: a model is a config value, looked up by name."""

from __future__ import annotations

import inspect
from typing import Callable, Dict, Tuple

from torch import nn

_REGISTRY: Dict[str, Callable[..., nn.Module]] = {}


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
) -> nn.Module:
    """Build a model by registry name (case-insensitive) for NHWC inputs of
    ``image_size``; ``remat=True`` asks for per-block recompute, which only
    some models have (fedtpu's ``ValueError`` otherwise)."""
    key = name.lower()
    if key not in _REGISTRY:
        raise NotImplementedError(
            f"model '{name}' is not ported to fedtpu_torch yet (ROADMAP.md "
            f"Queue 1, slice 7: the rest of the zoo); "
            f"available: {available()}"
        )
    ctor = _REGISTRY[key]
    kwargs = dict(num_classes=num_classes, image_size=tuple(image_size))
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
