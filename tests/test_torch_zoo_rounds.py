"""Whole rounds of the zoo's small models against fedtpu's ``Federation``.

BASELINE config 1 (FedAvg MLP on MNIST, 2 clients, iid, lr 0.05 constant)
and LeNet on CIFAR-10 shapes: both engines load the dataset themselves
(the synthetic fallback: ``FEDTPU_DATA_DIR`` names an empty directory),
partition it, and gather every round's batches from the device-resident
set by fedtpu's per-round keys, which the port is handed. f32, no
augmentation (the crops are fedtpu's random draws), 512 examples and
batch 32 (8 steps) where config 1 takes all 60,000 at batch 128. Held:
the loss within ``rtol=1e-5``; the global params within ``atol=1e-5,
rtol=1e-4`` on every coordinate uncompressed, on all but 0.1% with a codec
(a 1e-7 difference can cross a top-k threshold or an int8 step); the test
split's loss and accuracy within ``rtol=1e-5``. fedtpu makes a synthetic
split whole before it slices it, so one load of each split serves every
case here.
"""

import functools
import warnings

import jax
import numpy as np
import pytest
import torch

from fedtpu import config as jconfig
from fedtpu.core import engine as jengine
from fedtpu.core.engine import Federation as JFederation
from fedtpu.data import datasets as jdatasets
from fedtpu_torch import config as tconfig
from fedtpu_torch.convert import from_flax, to_flax
from fedtpu_torch.core.engine import Federation as TFederation
from fedtpu_torch.data import datasets as tdatasets


@pytest.fixture(scope="module")
def fedtpu_load():
    """fedtpu's ``load``, memoised for this file's cases (its engine's
    too), and emptied after them."""
    load = functools.lru_cache(maxsize=None)(jdatasets.load)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine, "load", load)
        yield load
    load.cache_clear()


def _configs(model, dataset, clients, compression):
    def build(mod):
        return mod.RoundConfig(
            model=model,
            num_classes=10,
            steps_per_round=8,
            opt=mod.OptimizerConfig(learning_rate=0.05, schedule="constant"),
            data=mod.DataConfig(dataset=dataset, batch_size=32, eval_batch_size=64, partition="iid",
                                num_examples=512, augment=False, device_layout="gather"),
            fed=mod.FedConfig(num_clients=clients, compression=compression),
        )

    return build(jconfig), build(tconfig)


@pytest.mark.parametrize("model,dataset,clients,compression", [
    ("mlp", "mnist", 2, "none"),
    ("mlp", "mnist", 2, "int8"),
    ("lenet", "cifar10", 4, "none"),
    ("lenet", "cifar10", 4, "topk"),
], ids=lambda v: str(v))
def test_rounds_track_fedtpu(model, dataset, clients, compression, tmp_path, monkeypatch, fedtpu_load):
    monkeypatch.setenv("FEDTPU_DATA_DIR", str(tmp_path))
    jcfg, tcfg = _configs(model, dataset, clients, compression)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the synthetic fallback's warning
        jfed = JFederation(jcfg, seed=0)
        tfed = TFederation(tcfg, seed=0, device="cpu")
    assert tfed.data_source == "synthetic"
    np.testing.assert_array_equal(tfed.images, jfed.images)
    np.testing.assert_array_equal(tfed.labels, jfed.labels)
    np.testing.assert_array_equal(tfed.client_idx, np.asarray(jfed.client_idx))
    assert jfed._layout == tfed.layout == "gather"
    tfed.state = tfed.state._replace(params=from_flax(jax.tree.map(np.asarray, jfed.state.params)))
    for r in range(3):
        key = jax.random.fold_in(jax.random.PRNGKey(jcfg.data.seed), r)
        keys = torch.from_numpy(np.array(jax.random.uniform(key, tfed.client_idx.shape)))
        jm = jfed.step()
        tm = tfed.step(tfed.device_batch(r, keys=keys))
        np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=1e-5)
        got, want = to_flax(tfed.state.params), jax.tree.map(np.asarray, jfed.state.params)
        bad = total = 0
        for mod in want:
            for leaf in want[mod]:
                beyond = np.abs(got[mod][leaf] - want[mod][leaf]) > 1e-5 + 1e-4 * np.abs(want[mod][leaf])
                bad += int(beyond.sum())
                total += beyond.size
        allowed = 0 if compression == "none" else 0.001 * total
        assert bad <= allowed, f"round {r}: {bad} of {total} coordinates differ"
    test = tdatasets.load(dataset, "test", num=256)
    for a, b in zip(test, fedtpu_load(dataset, "test", num=256)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(tfed.evaluate(*test), jfed.evaluate(*test), rtol=1e-5)
