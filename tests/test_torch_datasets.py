"""The port's dataset loaders against fedtpu's, bit for bit.

- The synthetic fallback of every dataset and split (``FEDTPU_DATA_DIR``
  names an empty directory), and the ``*_hard`` tasks (always synthetic,
  memoised per name, split and seed), image and flat shapes.
- The disk formats: a small CIFAR-100 pickle and MNIST idx files, raw and
  ``.gz``, written into ``tmp_path``; the committed CIFAR-10 fixture
  (``tests/fixtures/cifar10_fixture``: 200 train, 64 test).
- ``data_source`` per split, and the warning rule: a missing file warns
  once per dataset; ``*_hard`` and ``"synthetic"`` never warn.
"""

import gzip
import pickle
import struct
import warnings
from pathlib import Path

import numpy as np
import pytest

from fedtpu.data import datasets as jdatasets
from fedtpu_torch.data import datasets as tdatasets

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "cifar10_fixture"


@pytest.fixture()
def data_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("FEDTPU_DATA_DIR", str(tmp_path))
    return tmp_path


def _same(dataset, split, seed=0, num=None):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = tdatasets.load(dataset, split, seed=seed, num=num)
        want = jdatasets.load(dataset, split, seed=seed, num=num)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert tdatasets.data_source(dataset, split) == jdatasets.data_source(dataset, split)
    return got


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("dataset,shape,classes,n", [
    ("cifar10", (32, 32, 3), 10, {"train": 50000, "test": 10000}),
    ("cifar100", (32, 32, 3), 100, {"train": 50000, "test": 10000}),
    ("mnist", (28, 28, 1), 10, {"train": 60000, "test": 10000}),
    ("synthetic", (32, 32, 3), 10, {"train": 8192, "test": 8192}),
])
def test_synthetic_fallback_is_fedtpus(data_dir, dataset, shape, classes, n, split):
    x, y = _same(dataset, split)
    assert x.shape == (n[split],) + shape and y.max() < classes
    assert tdatasets.data_source(dataset, split) == "synthetic"
    assert tdatasets.dataset_info(dataset) == jdatasets.dataset_info(dataset) == (shape, classes)


@pytest.mark.parametrize("dataset,split,num", [
    ("cifar10", "test", 256), ("cifar100", "test", 1), ("mnist", "test", 12000),
])
def test_truncated_synthetic_fallback_is_fedtpus(data_dir, dataset, split, num):
    """The port makes only the rows a truncated load returns; fedtpu makes
    the whole split and slices it: the same arrays."""
    x, _ = _same(dataset, split, seed=3, num=num)
    assert len(x) == min(num, 10000)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("dataset", ["cifar10_hard", "cifar100_hard"])
def test_hard_tasks_are_fedtpus(dataset, split, seed):
    x, y = _same(dataset, split, seed=seed, num=1000)
    assert x.shape == (1000, 32, 32, 3)
    assert tdatasets.data_source(dataset, split) == "synthetic"
    again = tdatasets.load(dataset, split, seed=seed)
    assert again[0] is tdatasets.load(dataset, split, seed=seed)[0]  # memoised
    np.testing.assert_array_equal(again[0][:1000], x)
    assert len(again[0]) == (8192 if split == "train" else 4096)


@pytest.mark.parametrize("shape", [(50,), (6, 5, 2)])
def test_hard_task_of_a_flat_shape_is_fedtpus(shape):
    """Shapes that are not images divisible by 4 take the random flat
    subspace."""
    got = tdatasets._synthetic_hard(64, shape, 10, 7, "test")
    want = jdatasets._synthetic_hard(64, shape, 10, 7, "test")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_cifar100_disk_is_fedtpus(data_dir):
    d = data_dir / "cifar-100-python"
    d.mkdir()
    rng = np.random.default_rng(1)
    for split, n in (("train", 6), ("test", 3)):
        data = rng.integers(0, 256, size=(n, 3072), dtype=np.int64).astype(np.uint8)
        fine = rng.integers(0, 100, size=n).tolist()
        with open(d / split, "wb") as fh:
            pickle.dump({b"data": data, b"fine_labels": fine, b"coarse_labels": [0] * n}, fh)
        x, y = _same("cifar100", split)
        assert tdatasets.data_source("cifar100", split) == "disk"
        assert x.shape == (n, 32, 32, 3)
        np.testing.assert_array_equal(y, fine)


def _idx_bytes(arr):
    magic = struct.pack(">I", (0x08 << 8) | arr.ndim)  # unsigned bytes
    return magic + b"".join(struct.pack(">I", d) for d in arr.shape) + arr.tobytes()


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("split,prefix", [("train", "train"), ("test", "t10k")])
def test_mnist_idx_disk_is_fedtpus(data_dir, gz, split, prefix):
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, size=(5, 28, 28), dtype=np.int64).astype(np.uint8)
    labels = rng.integers(0, 10, size=5, dtype=np.int64).astype(np.uint8)
    suffix = ".gz" if gz else ""
    opener = gzip.open if gz else open
    for kind, arr in (("images-idx3", images), ("labels-idx1", labels)):
        with opener(data_dir / f"{prefix}-{kind}-ubyte{suffix}", "wb") as fh:
            fh.write(_idx_bytes(arr))
    x, y = _same("mnist", split)
    assert tdatasets.data_source("mnist", split) == "disk"
    assert x.shape == (5, 28, 28, 1) and x.dtype == np.float32
    np.testing.assert_array_equal(y, labels.astype(np.int32))


def test_mnist_under_torchvisions_raw_directory_is_fedtpus(data_dir):
    raw = data_dir / "MNIST" / "raw"
    raw.mkdir(parents=True)
    rng = np.random.default_rng(3)
    (raw / "train-images-idx3-ubyte").write_bytes(
        _idx_bytes(rng.integers(0, 256, size=(4, 28, 28), dtype=np.int64).astype(np.uint8)))
    (raw / "train-labels-idx1-ubyte").write_bytes(
        _idx_bytes(rng.integers(0, 10, size=4, dtype=np.int64).astype(np.uint8)))
    x, _ = _same("mnist", "train")
    assert tdatasets.data_source("mnist", "train") == "disk" and len(x) == 4


@pytest.mark.parametrize("split,n", [("train", 200), ("test", 64)])
def test_cifar10_fixture_is_fedtpus(monkeypatch, split, n):
    monkeypatch.setenv("FEDTPU_DATA_DIR", str(FIXTURE))
    x, y = _same("cifar10", split)
    assert tdatasets.data_source("cifar10", split) == "disk"
    assert x.shape == (n, 32, 32, 3) and y.shape == (n,)


def test_missing_file_warns_once_per_dataset(data_dir, monkeypatch):
    monkeypatch.setattr(tdatasets, "_WARNED", set())
    with pytest.warns(UserWarning, match="'mnist' not found on disk"):
        tdatasets.load("mnist", "test", num=8)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tdatasets.load("mnist", "train", num=8)  # the same dataset: no second warning
        for deliberate in ("cifar10_hard", "cifar100_hard", "synthetic"):
            tdatasets.load(deliberate, "test", num=8)
    assert tdatasets.data_source("mnist", "test") == "synthetic"
    with pytest.warns(UserWarning, match="'cifar100' not found on disk"):
        tdatasets.load("cifar100", "test", num=8)


def test_data_source_is_kept_per_split(data_dir):
    """A disk-backed split does not relabel the other split, and a split
    never loaded is 'unknown'."""
    d = data_dir / "cifar-100-python"
    d.mkdir()
    with open(d / "train", "wb") as fh:
        pickle.dump({b"data": np.zeros((2, 3072), np.uint8), b"fine_labels": [1, 2]}, fh)
    tdatasets.load("cifar100", "train")
    assert tdatasets.data_source("cifar100", "train") == "disk"
    assert tdatasets.data_source("cifar100", "val") == "unknown"
    with pytest.raises(FileNotFoundError):
        tdatasets.load("cifar100", "test")  # the directory is there, the file is not
    with pytest.raises(KeyError, match="unknown dataset"):
        tdatasets.load("imagenet")
