"""Dataset loading, numpy only.

CIFAR-10 in the same on-disk format, normalisation and deterministic
synthetic fallback as ``fedtpu.data.datasets``, so both packages see
identical arrays for the same split and seed.
"""

from __future__ import annotations

import os
import pickle
import warnings
from typing import Optional, Tuple

import numpy as np

from fedtpu_torch.config import not_ported

CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.array([0.2023, 0.1994, 0.2010], np.float32)


def _search_dirs() -> Tuple[str, ...]:
    # FEDTPU_DATA_DIR, when set, is the only place searched (as in fedtpu).
    explicit = os.environ.get("FEDTPU_DATA_DIR", "")
    if explicit:
        return (explicit,)
    return ("./data", os.path.expanduser("~/data"), "/data")


def _find(*names: str) -> Optional[str]:
    for d in _search_dirs():
        for n in names:
            p = os.path.join(d, n)
            if os.path.exists(p):
                return p
    return None


def _fallback_warning(dataset: str) -> None:
    warnings.warn(
        f"dataset '{dataset}' not found on disk; using the deterministic "
        "SYNTHETIC surrogate (throughput is valid, accuracy is not "
        "comparable to real-data runs)",
        stacklevel=3,
    )


def _synthetic(
    num: int, shape: Tuple[int, ...], num_classes: int, seed: int, split: str = "train"
) -> Tuple[np.ndarray, np.ndarray]:
    """Class-conditional Gaussian images, draw for draw as fedtpu makes
    them: prototypes depend only on ``seed``; labels and noise on the split."""
    proto_rng = np.random.default_rng(seed)
    protos = proto_rng.normal(0.0, 1.0, size=(num_classes,) + shape).astype(np.float32)
    rng = np.random.default_rng(seed + (1_000_003 if split == "test" else 0) + 1)
    labels = rng.integers(0, num_classes, size=num).astype(np.int32)
    x = protos[labels] + 0.5 * rng.normal(0.0, 1.0, size=(num,) + shape).astype(
        np.float32
    )
    return x, labels


def load_cifar10(split: str = "train", seed: int = 0):
    """CIFAR-10 as float32 NHWC, normalised; labels int32."""
    root = _find("cifar-10-batches-py")
    n = 50000 if split == "train" else 10000
    if root is None:
        _fallback_warning("cifar10")
        return _synthetic(n, (32, 32, 3), 10, seed, split)
    files = (
        [f"data_batch_{i}" for i in range(1, 6)] if split == "train" else ["test_batch"]
    )
    xs, ys = [], []
    for f in files:
        with open(os.path.join(root, f), "rb") as fh:
            d = pickle.load(fh, encoding="bytes")
        xs.append(d[b"data"])
        ys.extend(d[b"labels"])
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    x = (x.astype(np.float32) / 255.0 - CIFAR10_MEAN) / CIFAR10_STD
    return x, np.asarray(ys, np.int32)


_LOADERS = {
    "cifar10": (load_cifar10, (32, 32, 3), 10),
    "synthetic": (None, (32, 32, 3), 10),
}
# fedtpu's other datasets, which the port does not load yet.
_NOT_PORTED = ("cifar100", "mnist", "cifar10_hard", "cifar100_hard")


def _entry(dataset: str):
    if dataset in _NOT_PORTED:
        raise not_ported(f"dataset {dataset!r}", "slice 7: the rest of the zoo")
    if dataset not in _LOADERS:
        raise KeyError(f"unknown dataset '{dataset}'; have {sorted(_LOADERS)}")
    return _LOADERS[dataset]


def load(dataset: str, split: str = "train", seed: int = 0, num: Optional[int] = None):
    """Load ``(images, labels)`` for a named dataset; optionally truncate."""
    loader, shape, classes = _entry(dataset)
    if loader is None:
        x, y = _synthetic(num or 8192, shape, classes, seed, split)
    else:
        x, y = loader(split, seed)
    if num is not None:
        x, y = x[:num], y[:num]
    return x, y


def dataset_info(dataset: str) -> Tuple[Tuple[int, ...], int]:
    """(input_shape, num_classes) for a named dataset."""
    _, shape, classes = _entry(dataset)
    return shape, classes
