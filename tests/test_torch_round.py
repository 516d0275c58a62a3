"""The port's data path, optimizer, round and engine against fedtpu.

Inputs come from numpy and go through both packages; fedtpu's random draws
(crop offsets, flips, the data rotation offset) are handed to the port.
Tolerances:

- augmentation, partitions, synthetic data and the presharded window are
  bit-equal (pure selections);
- one optimizer step agrees within 1e-6;
- the whole slice (``Federation.step`` on one explicit ``RoundBatch`` per
  round, from the same converted init, f32) keeps the global params within
  ``atol=1e-5, rtol=1e-4`` uncompressed. With ``topk``/``int8`` at most
  0.1% of coordinates may differ beyond that: a 1e-7 difference in a delta
  can move one coordinate across a top-k threshold or an int8 rounding
  boundary. (The codecs fed the same deltas are bit-equal,
  ``test_torch_compression.py``.)
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedtpu import config as jconfig
from fedtpu.core import optim as joptim
from fedtpu.core import round as jround
from fedtpu.core.engine import Federation as JFederation
from fedtpu.data import augment as jaugment
from fedtpu.data import datasets as jdatasets
from fedtpu.data import device as jdevice
from fedtpu.data import partition as jpartition
from fedtpu_torch import config as tconfig
from fedtpu_torch.convert import from_flax, to_flax
from fedtpu_torch.core import optim as toptim
from fedtpu_torch.core import round as tround
from fedtpu_torch.core.engine import Federation as TFederation
from fedtpu_torch.data import augment as taugment
from fedtpu_torch.data import datasets as tdatasets
from fedtpu_torch.data import device as tdevice
from fedtpu_torch.data import partition as tpartition


def _both_configs(**fed_kw):
    """The same small config in both packages: smallcnn, 4 clients, batch
    8, 2 steps, no augmentation, f32."""
    kw = dict(
        model="smallcnn",
        steps_per_round=2,
        data=dict(
            dataset="cifar10", batch_size=8, eval_batch_size=16, partition="iid",
            augment=False,
        ),
        fed=dict(num_clients=4, **fed_kw),
    )

    def build(mod):
        return mod.RoundConfig(
            model=kw["model"],
            steps_per_round=kw["steps_per_round"],
            data=mod.DataConfig(**kw["data"]),
            fed=mod.FedConfig(**kw["fed"]),
        )

    return build(jconfig), build(tconfig)


# ---------------------------------------------------------------- data


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("crop", [True, False])
def test_augment_bit_equal_with_injected_draws(crop, dtype):
    x = np.random.default_rng(0).normal(size=(6, 32, 32, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(5)
    want = jaugment.augment_batch(rng, jnp.asarray(x).astype(dtype), crop=crop)
    # fedtpu's own draws, taken the way augment_batch takes them.
    crop_rng, flip_rng = jax.random.split(rng)
    offs = np.array(jax.random.randint(crop_rng, (6, 2), 0, 9))
    flips = np.array(jax.random.bernoulli(flip_rng, 0.5, (6,)))
    got = taugment.augment_batch(
        torch.from_numpy(x).to(getattr(torch, dtype)), crop=crop,
        offsets=torch.from_numpy(offs), flips=torch.from_numpy(flips),
    )
    want32 = np.asarray(want.astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), want32)


def test_partitions_and_synthetic_data_bit_equal():
    np.testing.assert_array_equal(tpartition.iid(103, 4, seed=2)[0], jpartition.iid(103, 4, seed=2)[0])
    np.testing.assert_array_equal(tpartition.iid(103, 4, seed=2)[1], jpartition.iid(103, 4, seed=2)[1])
    for a, b in zip(tpartition.round_robin(96, 3, 8), jpartition.round_robin(96, 3, 8)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(
        tdatasets._synthetic(64, (32, 32, 3), 10, 0),
        jdatasets._synthetic(64, (32, 32, 3), 10, 0),
    ):
        np.testing.assert_array_equal(a, b)
    assert tdatasets.dataset_info("cifar10") == jdatasets.dataset_info("cifar10")


@pytest.mark.parametrize("steps,offset", [(2, 5), (3, 0), (5, 11)])
def test_presharded_window_bit_equal_with_injected_offset(steps, offset):
    rng = np.random.default_rng(1)
    images = rng.normal(size=(52, 4, 4, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=52).astype(np.int32)
    idx, mask = jpartition.iid(52, 4, seed=0)
    jx, jy = jdevice.preshard_arrays(images, labels, idx, mask)
    tx, ty = tdevice.preshard_arrays(images, labels, idx, mask)
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)
    # batch 4: steps * batch fits the 13-example shard for steps <= 3 and
    # wraps it (several local epochs) for steps = 5.
    want = jdevice.presharded_window(
        jnp.asarray(jx), jnp.asarray(jy), jnp.int32(offset), steps, 4, (4, 4, 3)
    )
    got = tdevice.presharded_window(
        torch.from_numpy(tx), torch.from_numpy(ty), offset, steps, 4, (4, 4, 3)
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_round_offset_is_deterministic_and_in_range():
    offs = [tdevice.round_offset(13, True, 0, r) for r in range(20)]
    assert offs == [tdevice.round_offset(13, True, 0, r) for r in range(20)]
    assert all(0 <= o < 13 for o in offs) and len(set(offs)) > 1
    assert tdevice.round_offset(13, False, 0, 4) == 0


# ----------------------------------------------------------- optimizer


@pytest.mark.parametrize("nesterov", [False, True])
def test_one_optimizer_step_matches_fedtpu(nesterov):
    rng = np.random.default_rng(2)
    shapes = {"w": (3, 5, 7), "b": (3, 7)}  # stacked over 3 clients
    p, g, m = ({k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()} for _ in range(3))
    jcfg = jconfig.OptimizerConfig(nesterov=nesterov)
    tcfg = tconfig.OptimizerConfig(nesterov=nesterov)
    lr = tcfg.lr_at(0)
    assert np.float32(lr) == jcfg.lr_at(0)  # both packages step in f32
    jp, js = joptim.apply(
        jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g),
        joptim.SGDState(momentum=jax.tree.map(jnp.asarray, m)), lr, jcfg,
    )
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    tp, tm = toptim.apply(t(p), t(g), t(m), lr, tcfg)
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6, rtol=0)
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(js.momentum[k]), atol=1e-6, rtol=0)


def test_cosine_schedule_matches_fedtpu():
    jcfg = jconfig.OptimizerConfig(schedule="cosine", cosine_t_max=10)
    tcfg = tconfig.OptimizerConfig(schedule="cosine", cosine_t_max=10)
    for r in (0, 3, 10, 15):
        assert tcfg.lr_at(r) == pytest.approx(float(jcfg.lr_at(r)), rel=1e-6)


# ------------------------------------------------------- the whole slice


def _round_inputs(rng, r):
    x = rng.normal(size=(4, 2, 8, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=(4, 2, 8)).astype(np.int32)
    step_mask = np.ones((4, 2), bool)
    step_mask[3, 1] = False  # a ragged shard: client 3's second step is padding
    weights = np.array([16.0, 12.0, 16.0, 8.0], np.float32)
    alive = np.array([True, True, r == 0, True])  # client 2 dies in round 2
    return x, y, step_mask, weights, alive


def _beyond_tolerance(got, want, atol=1e-5, rtol=1e-4):
    return np.abs(got - want) > atol + rtol * np.abs(want)


@pytest.mark.parametrize("compression", ["none", "topk", "int8"])
def test_whole_slice_tracks_fedtpu(compression):
    jcfg, tcfg = _both_configs(compression=compression)
    rng = np.random.default_rng(7)
    images = rng.normal(size=(64, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=64).astype(np.int32)
    jfed = JFederation(jcfg, seed=0, data=(images, labels))
    tfed = TFederation(tcfg, seed=0, data=(images, labels), device="cpu")
    init = jax.tree.map(np.asarray, jfed.state.params)
    tfed.state = tfed.state._replace(params=from_flax(init))
    for r in range(2):
        x, y, sm, w, alive = _round_inputs(rng, r)
        jm = jfed.step(jround.RoundBatch(
            x=jnp.asarray(x), y=jnp.asarray(y), step_mask=jnp.asarray(sm),
            weights=jnp.asarray(w), alive=jnp.asarray(alive),
        ))
        tm = tfed.step(tround.RoundBatch(
            x=torch.from_numpy(x), y=torch.from_numpy(y), step_mask=torch.from_numpy(sm),
            weights=torch.from_numpy(w), alive=torch.from_numpy(alive),
        ))
        np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=1e-5)
        assert float(tm.num_active) == float(jm.num_active)
        got, want = to_flax(tfed.state.params), jax.tree.map(np.asarray, jfed.state.params)
        bad = total = 0
        for mod in want:
            for leaf in want[mod]:
                if compression == "none":
                    np.testing.assert_allclose(
                        got[mod][leaf], want[mod][leaf], atol=1e-5, rtol=1e-4,
                        err_msg=f"round {r} {mod}/{leaf}",
                    )
                bad += int(_beyond_tolerance(got[mod][leaf], want[mod][leaf]).sum())
                total += want[mod][leaf].size
        assert bad <= 0.001 * total, f"round {r}: {bad} of {total} coordinates differ"
    if compression == "none":
        np.testing.assert_allclose(
            tfed.evaluate(images, labels), jfed.evaluate(images, labels), rtol=1e-5
        )


def test_participation_sampling_matches_fedtpu():
    """The seeded numpy draw of a round's participants, on the same alive
    mask (client 1 dead)."""
    jcfg, tcfg = _both_configs(participation_fraction=0.5)
    alive = np.array([True, False, True, True])
    for r in range(6):
        want = JFederation._alive_for_round(SimpleNamespace(alive=alive, cfg=jcfg), r)
        got = TFederation._alive_for_round(SimpleNamespace(alive=alive, cfg=tcfg), r)
        np.testing.assert_array_equal(got, want)


def test_federation_defaults_to_cuda():
    _, tcfg = _both_configs()
    data = (np.zeros((64, 32, 32, 3), np.float32), np.zeros(64, np.int32))
    if torch.cuda.is_available():
        assert TFederation(tcfg, data=data).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TFederation(tcfg, data=data)


_F, _D, _O = tconfig.FedConfig, tconfig.DataConfig, tconfig.OptimizerConfig


@pytest.mark.parametrize("part", [
    _F(delta_layout="flat"),
    _F(compression="rotq"),
    _F(compression="randk"),
    _F(aggregator="median"),
    _F(server_optimizer="adam"),
    _F(dp_clip_norm=1.0),
    _F(megabatch_clients=2),
    _F(screen=tconfig.ScreenConfig(norm_max=1.0)),
    _F(algorithm="fedprox"),
    _D(device_layout="gather"),
    _D(partition="dirichlet"),
    _D(dataset="mnist"),
    _O(momentum_dtype="bfloat16"),
], ids=repr)
def test_unported_options_raise_naming_the_roadmap(part):
    field = {_F: "fed", _D: "data", _O: "opt"}[type(part)]
    cfg = tconfig.RoundConfig(model="smallcnn", **{field: part})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TFederation(cfg, device="cpu")
