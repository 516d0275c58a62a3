"""The port's standalone trainer (``fedtpu_torch.core.solo``) against
fedtpu's on the CPU.

fedtpu's ``solo_cfg`` (``tests/test_solo.py``: mlp, 512 synthetic
examples, batch 32). From fedtpu's initial weights and with fedtpu's epoch
order injected (fedtpu draws it from threefry), the port's epoch gives
fedtpu's weights within ``atol=1e-5, rtol=1e-4`` and the same loss,
accuracy and test accuracy; two epochs of the port alone carry the epoch
into the learning rate. The checkpoint file is fedtpu's, byte for byte,
and each package resumes from the other's; a test epoch saves only when
the accuracy improves.
"""

import os
import warnings

import jax
import numpy as np
import pytest
import torch

from fedtpu import config as jconfig
from fedtpu.core.solo import SoloTrainer as JSolo
from fedtpu_torch import config as tconfig
from fedtpu_torch.convert import from_flax, to_flax
from fedtpu_torch.core.solo import SoloTrainer, run_solo
from fedtpu_torch.utils.metrics import MetricsLogger

TOL = dict(atol=1e-5, rtol=1e-4)


def solo_cfg(mod, **opt_kw):
    return mod.RoundConfig(
        model="mlp",
        num_classes=10,
        opt=mod.OptimizerConfig(**{"learning_rate": 0.05, "weight_decay": 0.0, **opt_kw}),
        data=mod.DataConfig(dataset="synthetic", batch_size=32, eval_batch_size=32, num_examples=512),
        fed=mod.FedConfig(num_clients=1),
    )


def fedtpu_order(j) -> np.ndarray:
    """The order fedtpu's next ``train_epoch`` draws."""
    _, shuffle_rng = jax.random.split(j.rng)
    return np.asarray(jax.random.permutation(shuffle_rng, len(j.images)))


def _assert_close(tree, want):
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(want), strict=True):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


@pytest.fixture(scope="module")
def fedtpu_epoch():
    """fedtpu's trainer: its initial weights, its first epoch's order, and
    its weights, momentum and numbers after one train and test epoch."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = JSolo(solo_cfg(jconfig, weight_decay=5e-4, schedule="cosine", cosine_t_max=4))
    init = jax.tree.map(np.asarray, j.params)
    order = fedtpu_order(j)
    train = j.train_epoch()
    test = j.test_epoch()
    return init, order, train, test, jax.tree.map(np.asarray, j.params), jax.tree.map(
        np.asarray, j.opt_state.momentum)


def test_an_epoch_on_fedtpus_order_gives_fedtpus_weights(fedtpu_epoch):
    init, order, (jloss, jacc), (jtl, jta), params, momentum = fedtpu_epoch
    t = SoloTrainer(solo_cfg(tconfig, weight_decay=5e-4, schedule="cosine", cosine_t_max=4), device="cpu")
    t.params = from_flax(init)
    loss, acc = t.train_epoch(order=order)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert acc == jacc and t.epoch == 1
    _assert_close(to_flax(t.params), params)
    _assert_close(to_flax(t.opt_state), momentum)
    tl, ta = t.test_epoch()
    np.testing.assert_allclose(tl, jtl, rtol=1e-5, atol=1e-6)
    assert ta == jta == t.best_acc


def test_the_epoch_sets_the_learning_rate():
    """Two epochs on the cosine schedule with the rate of epoch 0 both
    times (the counter held back) part from two epochs that advance it."""
    cfg = solo_cfg(tconfig, schedule="cosine", cosine_t_max=2)
    a, b = SoloTrainer(cfg, device="cpu"), SoloTrainer(cfg, device="cpu")
    order = np.random.default_rng(0).permutation(512)
    for _ in range(2):
        a.train_epoch(order=order)
        b.train_epoch(order=order)
        b.epoch = 0
    assert a.epoch == 2 and b.epoch == 0
    assert not all(torch.equal(a.params[k], b.params[k]) for k in a.params)


def test_checkpoint_is_fedtpus_file_and_each_package_resumes_the_others(tmp_path, fedtpu_epoch):
    init, order, _, (_, jta), params, momentum = fedtpu_epoch
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = JSolo(solo_cfg(jconfig, weight_decay=5e-4, schedule="cosine", cosine_t_max=4))
    j.params = jax.tree.map(jax.numpy.asarray, params)
    j.opt_state = j.opt_state._replace(momentum=jax.tree.map(jax.numpy.asarray, momentum))
    j.epoch, j.best_acc = 1, jta
    j.save_checkpoint(str(tmp_path / "j.fckpt"))
    # fedtpu's file resumes the port's trainer, and the port writes it back.
    t = SoloTrainer(solo_cfg(tconfig), checkpoint_path=str(tmp_path / "j.fckpt"), resume=True, device="cpu")
    assert t.epoch == 1 and t.best_acc == pytest.approx(jta)
    t.save_checkpoint(str(tmp_path / "t.fckpt"))
    assert (tmp_path / "t.fckpt").read_bytes() == (tmp_path / "j.fckpt").read_bytes()
    # The port's file resumes fedtpu's trainer.
    t.epoch, t.best_acc = 3, 0.75
    t.opt_state = {k: v * 2 for k, v in t.opt_state.items()}
    t.save_checkpoint(str(tmp_path / "t2.fckpt"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j2 = JSolo(solo_cfg(jconfig), checkpoint_path=str(tmp_path / "t2.fckpt"), resume=True)
    assert j2.epoch == 3 and j2.best_acc == pytest.approx(0.75)
    for a, b in zip(jax.tree_util.tree_leaves(j2.params), jax.tree_util.tree_leaves(params), strict=True):
        np.testing.assert_array_equal(np.asarray(a), b)
    for a, b in zip(jax.tree_util.tree_leaves(j2.opt_state.momentum), jax.tree_util.tree_leaves(momentum),
                    strict=True):
        np.testing.assert_array_equal(np.asarray(a), 2 * b)


def test_resume_restores_everything(tmp_path):
    path = str(tmp_path / "solo.fckpt")
    t1 = SoloTrainer(solo_cfg(tconfig), checkpoint_path=path, device="cpu")
    t1.train_epoch()
    t1.test_epoch()  # the first test epoch always improves on 0
    assert os.path.exists(path)
    t2 = SoloTrainer(solo_cfg(tconfig), checkpoint_path=path, resume=True, device="cpu")
    assert t2.epoch == t1.epoch == 1 and t2.best_acc == pytest.approx(t1.best_acc)
    for tree in ("params", "opt_state", "batch_stats"):
        a, b = getattr(t1, tree), getattr(t2, tree)
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a), tree


def test_only_an_improvement_saves(tmp_path):
    path = str(tmp_path / "solo.fckpt")
    t = SoloTrainer(solo_cfg(tconfig), checkpoint_path=path, device="cpu")
    t.best_acc = 2.0  # unbeatable
    t.train_epoch()
    t.test_epoch()
    assert not os.path.exists(path)
    t.best_acc = 0.0
    t.test_epoch()
    assert os.path.exists(path)
    before = os.path.getmtime(path), open(path, "rb").read()
    t.test_epoch()  # the same accuracy is no improvement
    assert (os.path.getmtime(path), open(path, "rb").read()) == before


def test_run_solo_logs_each_epoch_and_trains(tmp_path):
    logged = []

    class Logger(MetricsLogger):
        def log(self, step, **kw):
            logged.append((step, kw))

    t = run_solo(solo_cfg(tconfig), epochs=2, checkpoint_path=str(tmp_path / "s.fckpt"),
                 logger=Logger(), device="cpu")
    assert t.epoch == 2 and [s for s, _ in logged] == [1, 2]
    assert t.best_acc > 0.5  # synthetic is easy
    assert set(logged[0][1]) == {"train_loss", "train_acc", "test_loss", "test_acc", "best_acc"}


def test_a_mesh_raises_naming_its_item():
    with pytest.raises(NotImplementedError, match="ROADMAP.*slice 8, part 6"):
        SoloTrainer(solo_cfg(tconfig), mesh=object(), device="cpu")
