"""Model registry: a model is a config value, looked up by name."""

from __future__ import annotations

from typing import Callable, Dict, Tuple

from torch import nn

_REGISTRY: Dict[str, Callable[..., nn.Module]] = {}


def register(name: str):
    def deco(ctor: Callable[..., nn.Module]):
        _REGISTRY[name.lower()] = ctor
        return ctor

    return deco


def create(
    name: str, num_classes: int = 10, image_size: Tuple[int, int, int] = (32, 32, 3)
) -> nn.Module:
    """Build a model by registry name (case-insensitive) for NHWC inputs of
    ``image_size``."""
    key = name.lower()
    if key not in _REGISTRY:
        raise NotImplementedError(
            f"model '{name}' is not ported to fedtpu_torch yet (ROADMAP.md "
            f"Queue 1, slice 7: the rest of the zoo); "
            f"available: {available()}"
        )
    return _REGISTRY[key](num_classes=num_classes, image_size=tuple(image_size))


def available() -> list[str]:
    return sorted(_REGISTRY)
