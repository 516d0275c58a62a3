"""Dataset loading, numpy only.

The port of ``fedtpu.data.datasets``: CIFAR-10 and CIFAR-100 (python
pickles), MNIST (idx files, raw or ``.gz``) in the same on-disk formats,
normalisation and layout as fedtpu, the deterministic synthetic fallback
when the files are missing, and the ``*_hard`` benchmark tasks, which are
always synthetic. Both packages see identical arrays for the same dataset,
split and seed: the seed offsets (CIFAR-100 ``+10``, MNIST ``+20``,
``cifar10_hard`` ``+40``, ``cifar100_hard`` ``+50``) and the draws are
fedtpu's. A truncated load (``num``) of a synthetic fallback makes only
the rows it returns, where fedtpu makes the whole split and slices it.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
import warnings
from typing import Optional, Tuple

import numpy as np

# (dataset, split) -> "disk" | "synthetic": the source of the last load.
_SOURCE: dict = {}
_WARNED: set = set()

CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.array([0.2023, 0.1994, 0.2010], np.float32)
MNIST_MEAN, MNIST_STD = 0.1307, 0.3081


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


def _record_source(dataset: str, source: str, split: str) -> None:
    """Record where ``(dataset, split)`` came from; warn once per dataset
    when a missing file made it synthetic. The ``*_hard`` tasks and
    ``"synthetic"`` are synthetic by design and never warn."""
    _SOURCE[(dataset, split)] = source
    deliberate = dataset == "synthetic" or dataset.endswith("_hard")
    if source == "synthetic" and not deliberate and dataset not in _WARNED:
        _WARNED.add(dataset)
        warnings.warn(
            f"dataset '{dataset}' not found on disk (searched "
            f"{list(_search_dirs())}); falling back to the deterministic "
            "SYNTHETIC surrogate (throughput is valid, accuracy is not "
            "comparable to real-data runs)",
            stacklevel=3,
        )


def _synthetic(
    num: int, shape: Tuple[int, ...], num_classes: int, seed: int, split: str = "train",
    rows: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Class-conditional Gaussian images, draw for draw as fedtpu makes
    them: prototypes depend only on ``seed``; labels and noise on the split.
    ``rows``: only the set's first ``rows`` examples, the same values: all
    ``num`` labels are drawn, then the noise of the rows kept, which numpy
    draws as the prefix of the whole set's."""
    proto_rng = np.random.default_rng(seed)
    protos = proto_rng.normal(0.0, 1.0, size=(num_classes,) + shape).astype(np.float32)
    rng = np.random.default_rng(seed + (1_000_003 if split == "test" else 0) + 1)
    labels = rng.integers(0, num_classes, size=num).astype(np.int32)
    keep = num if rows is None else min(rows, num)
    labels = labels[:keep]
    x = protos[labels] + 0.5 * rng.normal(0.0, 1.0, size=(keep,) + shape).astype(
        np.float32
    )
    return x, labels


def _synthetic_hard(
    num: int,
    shape: Tuple[int, ...],
    num_classes: int,
    seed: int,
    split: str = "train",
    informative_dims: int = 64,
    proto_scale: float = 0.3,
    label_noise: float = 0.1,
) -> Tuple[np.ndarray, np.ndarray]:
    """fedtpu's non-saturating task, draw for draw: the class signal lives
    in a low-dimensional subspace at small scale under unit noise (for
    image shapes, coarse ``H/4 x W/4`` fields upsampled 4x; otherwise a
    random flat subspace of ``informative_dims``), and ``label_noise`` of
    the labels are redrawn uniformly. Prototypes depend only on ``seed``."""
    proto_rng = np.random.default_rng(seed)
    if len(shape) == 3 and shape[0] % 4 == 0 and shape[1] % 4 == 0:
        ch, cw = shape[0] // 4, shape[1] // 4
        coarse = proto_rng.normal(
            0.0, 1.0, size=(num_classes, ch, cw, shape[2])
        ).astype(np.float32)
        protos = proto_scale * coarse.repeat(4, axis=1).repeat(4, axis=2)
    else:
        dim = int(np.prod(shape))
        basis = proto_rng.normal(0.0, 1.0, size=(informative_dims, dim)).astype(np.float32)
        basis /= np.linalg.norm(basis, axis=1, keepdims=True)
        coords = proto_rng.normal(
            0.0, 1.0, size=(num_classes, informative_dims)
        ).astype(np.float32)
        protos = (proto_scale * coords @ basis).reshape((num_classes,) + shape)
    rng = np.random.default_rng(seed + (1_000_003 if split == "test" else 0) + 1)
    labels = rng.integers(0, num_classes, size=num).astype(np.int32)
    x = protos[labels] + rng.normal(0.0, 1.0, size=(num,) + shape).astype(np.float32)
    flip = rng.random(num) < label_noise
    noisy = rng.integers(0, num_classes, size=num).astype(np.int32)
    labels = np.where(flip, noisy, labels)
    return x, labels


# The *_hard tasks, memoised per (name, split, seed) as fedtpu memoises
# them: 8192 train / 4096 test examples, truncated by load().
_HARD_CACHE: dict = {}


def _hard_cached(name, shape, classes, seed, split):
    n = 8192 if split == "train" else 4096
    key = (name, split, seed)
    if key not in _HARD_CACHE:
        _HARD_CACHE[key] = _synthetic_hard(n, shape, classes, seed, split)
    return _HARD_CACHE[key]


def load_cifar10_hard(split: str = "train", seed: int = 0, rows: Optional[int] = None):
    """The non-saturating 10-class task at CIFAR-10 shapes, always
    synthetic (made whole once and memoised: ``rows`` changes nothing)."""
    _record_source("cifar10_hard", "synthetic", split)
    return _hard_cached("cifar10_hard", (32, 32, 3), 10, seed + 40, split)


def load_cifar100_hard(split: str = "train", seed: int = 0, rows: Optional[int] = None):
    """The non-saturating 100-class task at CIFAR-100 shapes, always
    synthetic (made whole once and memoised: ``rows`` changes nothing)."""
    _record_source("cifar100_hard", "synthetic", split)
    return _hard_cached("cifar100_hard", (32, 32, 3), 100, seed + 50, split)


def _normalise_cifar(data: np.ndarray) -> np.ndarray:
    x = data.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return (x.astype(np.float32) / 255.0 - CIFAR10_MEAN) / CIFAR10_STD


def load_cifar10(split: str = "train", seed: int = 0, rows: Optional[int] = None):
    """CIFAR-10 as float32 NHWC, normalised; labels int32. ``rows``: at
    least the first ``rows`` examples are needed (the synthetic fallback
    makes no more)."""
    root = _find("cifar-10-batches-py")
    n = 50000 if split == "train" else 10000
    if root is None:
        _record_source("cifar10", "synthetic", split)
        return _synthetic(n, (32, 32, 3), 10, seed, split, rows)
    _record_source("cifar10", "disk", split)
    files = (
        [f"data_batch_{i}" for i in range(1, 6)] if split == "train" else ["test_batch"]
    )
    xs, ys = [], []
    for f in files:
        with open(os.path.join(root, f), "rb") as fh:
            d = pickle.load(fh, encoding="bytes")
        xs.append(d[b"data"])
        ys.extend(d[b"labels"])
    return _normalise_cifar(np.concatenate(xs)), np.asarray(ys, np.int32)


def load_cifar100(split: str = "train", seed: int = 0, rows: Optional[int] = None):
    """CIFAR-100's fine labels, the images normalised with CIFAR-10's mean
    and std, as fedtpu does."""
    root = _find("cifar-100-python")
    n = 50000 if split == "train" else 10000
    if root is None:
        _record_source("cifar100", "synthetic", split)
        return _synthetic(n, (32, 32, 3), 100, seed + 10, split, rows)
    _record_source("cifar100", "disk", split)
    with open(os.path.join(root, split), "rb") as fh:
        d = pickle.load(fh, encoding="bytes")
    return _normalise_cifar(d[b"data"]), np.asarray(d[b"fine_labels"], np.int32)


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fh:
        magic = struct.unpack(">I", fh.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, fh.read(4 * ndim))
        return np.frombuffer(fh.read(), np.uint8).reshape(dims)


def load_mnist(split: str = "train", seed: int = 0, rows: Optional[int] = None):
    """MNIST as float32 ``[N, 28, 28, 1]``, normalised; labels int32."""
    prefix = "train" if split == "train" else "t10k"
    img = _find(f"{prefix}-images-idx3-ubyte", f"{prefix}-images-idx3-ubyte.gz",
                f"MNIST/raw/{prefix}-images-idx3-ubyte")
    lbl = _find(f"{prefix}-labels-idx1-ubyte", f"{prefix}-labels-idx1-ubyte.gz",
                f"MNIST/raw/{prefix}-labels-idx1-ubyte")
    n = 60000 if split == "train" else 10000
    if img is None or lbl is None:
        _record_source("mnist", "synthetic", split)
        return _synthetic(n, (28, 28, 1), 10, seed + 20, split, rows)
    _record_source("mnist", "disk", split)
    x = _read_idx(img).astype(np.float32)[..., None]
    x = (x / 255.0 - MNIST_MEAN) / MNIST_STD
    return x, _read_idx(lbl).astype(np.int32)


_LOADERS = {
    "cifar10": (load_cifar10, (32, 32, 3), 10),
    "cifar100": (load_cifar100, (32, 32, 3), 100),
    "cifar10_hard": (load_cifar10_hard, (32, 32, 3), 10),
    "cifar100_hard": (load_cifar100_hard, (32, 32, 3), 100),
    "mnist": (load_mnist, (28, 28, 1), 10),
    "synthetic": (None, (32, 32, 3), 10),
}


def _entry(dataset: str):
    if dataset not in _LOADERS:
        raise KeyError(f"unknown dataset '{dataset}'; have {sorted(_LOADERS)}")
    return _LOADERS[dataset]


def load(dataset: str, split: str = "train", seed: int = 0, num: Optional[int] = None):
    """Load ``(images, labels)`` for a named dataset; optionally truncate
    to the first ``num`` examples."""
    loader, shape, classes = _entry(dataset)
    if loader is None:
        _record_source(dataset, "synthetic", split)
        x, y = _synthetic(num or 8192, shape, classes, seed, split)
    else:
        x, y = loader(split, seed, rows=num)
    if num is not None:
        x, y = x[:num], y[:num]
    return x, y


def data_source(dataset: str, split: str = "train") -> str:
    """'disk' | 'synthetic' | 'unknown': the source of the last
    ``load(dataset, split)``."""
    return _SOURCE.get((dataset, split), "unknown")


def dataset_info(dataset: str) -> Tuple[Tuple[int, ...], int]:
    """(input_shape, num_classes) for a named dataset."""
    _, shape, classes = _entry(dataset)
    return shape, classes
