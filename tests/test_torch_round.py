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
from fedtpu_torch import models as tmodels
from fedtpu_torch.convert import from_flax, to_flax
from fedtpu_torch.core import optim as toptim
from fedtpu_torch.core import round as tround
from fedtpu_torch.core.engine import Federation as TFederation
from fedtpu_torch.data import augment as taugment
from fedtpu_torch.data import datasets as tdatasets
from fedtpu_torch.data import device as tdevice
from fedtpu_torch.data import partition as tpartition
from fedtpu_torch.models import registry
from fedtpu_torch.ops import compression as tcomp


def _both_configs(data_kw=None, **fed_kw):
    """The same small config in both packages: smallcnn, 4 clients, batch
    8, 2 steps, no augmentation, f32; ``data_kw`` and ``fed_kw`` set further
    ``DataConfig`` and ``FedConfig`` fields."""
    kw = dict(
        model="smallcnn",
        steps_per_round=2,
        data={
            **dict(dataset="cifar10", batch_size=8, eval_batch_size=16, partition="iid",
                   augment=False),
            **(data_kw or {}),
        },
        fed={"num_clients": 4, **fed_kw},
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


def _ragged_assignment():
    """iid shards of 30 examples over 4 clients, client 2's cut to 3
    examples (ragged) and client 3's empty."""
    idx, mask = jpartition.iid(30, 4, seed=0)
    mask = mask.copy()
    mask[2, 3:] = False
    mask[3, :] = False
    return idx, mask


@pytest.mark.parametrize("need", [5, 16])
@pytest.mark.parametrize("shuffle", [True, False], ids=["shuffled", "in_order"])
def test_round_take_indices_bit_equal_with_injected_keys(shuffle, need):
    """fedtpu's indices from fedtpu's keys; the padding's +inf keys tie, and
    the stable sort keeps them in slot order as ``jnp.argsort`` does."""
    idx, mask = _ragged_assignment()
    rng = jax.random.fold_in(jax.random.PRNGKey(3), 2) if shuffle else None
    want = jdevice.round_take_indices(jnp.asarray(idx), jnp.asarray(mask), need, rng)
    keys = torch.from_numpy(np.array(jax.random.uniform(rng, idx.shape))) if shuffle else None
    got = tdevice.round_take_indices(
        torch.from_numpy(idx).long(), torch.from_numpy(mask), need, keys
    )
    assert got.shape == (4, need)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_round_keys_are_deterministic_per_round():
    a = tdevice.round_keys((4, 8), 0, 3, "cpu")
    assert torch.equal(a, tdevice.round_keys((4, 8), 0, 3, "cpu"))
    assert not torch.equal(a, tdevice.round_keys((4, 8), 0, 4, "cpu"))
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0


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
    """The f32 rates of fedtpu's compiled schedule, bit for bit, at both
    horizons (every round of ``0..t_max + 60`` in
    ``test_torch_options.py``), and the SGD step takes the rate as f32."""
    for t_max in (200, 10):
        jcfg = jconfig.OptimizerConfig(schedule="cosine", cosine_t_max=t_max)
        tcfg = tconfig.OptimizerConfig(schedule="cosine", cosine_t_max=t_max)
        rate = jax.jit(jcfg.lr_at)
        for r in (0, 3, 4, 10, 15, 128, 148, 155, 160, 195, 260):
            got = tcfg.lr_at(r)
            assert np.float32(got) == got
            assert np.float32(got).view(np.int32) == np.float32(rate(jnp.int32(r))).view(np.int32), (t_max, r)


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


def _track_fedtpu(
    compression, delta_layout="per_leaf", wrap=None, rounds=2, fed_kw=None, strict=None
):
    """``rounds`` rounds of both engines from the same init on the same
    batches; ``wrap`` turns the port's codec into one fed fedtpu's draws;
    ``fed_kw`` sets further ``FedConfig`` fields in both. ``strict`` (by
    default: uncompressed) holds every coordinate to the tolerance, else
    all but 0.1% of them."""
    if strict is None:
        strict = compression == "none"
    jcfg, tcfg = _both_configs(
        compression=compression, delta_layout=delta_layout, **(fed_kw or {})
    )
    rng = np.random.default_rng(7)
    images = rng.normal(size=(64, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=64).astype(np.int32)
    jfed = JFederation(jcfg, seed=0, data=(images, labels))
    comp = tcomp.make_compressor(tcfg.fed)
    if wrap is not None:
        comp = wrap(comp)
    tfed = TFederation(tcfg, seed=0, data=(images, labels), device="cpu", compressor=comp)
    init = jax.tree.map(np.asarray, jfed.state.params)
    tfed.state = tfed.state._replace(params=from_flax(init))
    for r in range(rounds):
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
                if strict:
                    np.testing.assert_allclose(
                        got[mod][leaf], want[mod][leaf], atol=1e-5, rtol=1e-4,
                        err_msg=f"round {r} {mod}/{leaf}",
                    )
                bad += int(_beyond_tolerance(got[mod][leaf], want[mod][leaf]).sum())
                total += want[mod][leaf].size
        assert bad <= 0.001 * total, f"round {r}: {bad} of {total} coordinates differ"
    return jfed, tfed, images, labels


@pytest.mark.parametrize("compression", ["none", "topk", "int8"])
def test_whole_slice_tracks_fedtpu(compression):
    jfed, tfed, images, labels = _track_fedtpu(compression)
    if compression == "none":
        np.testing.assert_allclose(
            tfed.evaluate(images, labels), jfed.evaluate(images, labels), rtol=1e-5
        )


def _with_fedtpu_rotq_draws(comp):
    """rotq fed, each round, the signs and uniforms fedtpu draws for it."""

    def apply_flat(y, state, lay, round_idx=0):
        key = jax.random.fold_in(jax.random.PRNGKey(0x5EED0), round_idx)
        k_sign, k_unif = jax.random.split(key)
        signs = np.asarray(jax.random.rademacher(k_sign, (lay.padded,), jnp.float32))
        unif = np.asarray(jax.random.uniform(k_unif, tuple(y.shape), jnp.float32))
        return comp.apply_flat(
            y, state, lay, round_idx=round_idx,
            signs=torch.tensor(signs), uniforms=torch.tensor(unif),
        )

    return comp._replace(apply_flat=apply_flat)


@pytest.mark.parametrize("compression,rounds", [("topk", 2), ("rotq", 1)])
def test_whole_flat_slice_tracks_fedtpu(compression, rounds):
    """The flat round (pack, codec, mean, unpack) against fedtpu's, within
    the per-leaf round's tolerance. rotq is held for one round: a last-bit
    difference of a convolution can move one rotated coordinate across a
    stochastic-rounding step, which moves every coordinate of that client's
    row by scale / sqrt(h) (about 8e-6 here), and the next round's local
    training amplifies it. topk's residual buffer, where client 2's dead
    second round keeps its row, is held to the same rule as the params."""
    wrap = _with_fedtpu_rotq_draws if compression == "rotq" else None
    jfed, tfed, _, _ = _track_fedtpu(compression, "flat", wrap, rounds)
    got, want = tfed.state.comp_state.numpy(), np.asarray(jfed.state.comp_state)
    assert got.shape == want.shape == (4, 2**20 if compression == "rotq" else 545_152)
    if compression == "topk":
        bad = int(_beyond_tolerance(got, want).sum())
        assert bad <= 0.001 * want.size, f"{bad} of {want.size} residual coordinates differ"


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_flat_round_bit_equal_to_per_leaf_round(compression):
    """Per-coordinate math does not see the layout: the flat round's params
    are the per-leaf round's, bit for bit."""
    _, tcfg = _both_configs(compression=compression)
    _, fcfg = _both_configs(compression=compression, delta_layout="flat")
    rng = np.random.default_rng(8)
    data = (rng.normal(size=(64, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, size=64).astype(np.int32))
    per_leaf = TFederation(tcfg, seed=0, data=data, device="cpu")
    flat = TFederation(fcfg, seed=0, data=data, device="cpu")
    for r in range(2):
        x, y, sm, w, alive = _round_inputs(rng, r)
        batch = tround.RoundBatch(
            x=torch.from_numpy(x), y=torch.from_numpy(y), step_mask=torch.from_numpy(sm),
            weights=torch.from_numpy(w), alive=torch.from_numpy(alive),
        )
        per_leaf.step(batch)
        flat.step(batch)
        for k, v in per_leaf.state.params.items():
            assert torch.equal(flat.state.params[k].view(torch.int32), v.view(torch.int32)), k


def test_gather_rounds_track_fedtpu():
    """Two rounds of both engines on the gather layout, each batch gathered
    from the device-resident set by fedtpu's per-round keys."""
    jcfg, tcfg = _both_configs(data_kw=dict(device_layout="gather"))
    rng = np.random.default_rng(9)
    data = (rng.normal(size=(60, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, size=60).astype(np.int32))
    jfed = JFederation(jcfg, seed=0, data=data)
    tfed = TFederation(tcfg, seed=0, data=data, device="cpu")
    assert jfed._layout == tfed.layout == "gather"
    tfed.state = tfed.state._replace(params=from_flax(jax.tree.map(np.asarray, jfed.state.params)))
    for r in range(2):
        key = jax.random.fold_in(jax.random.PRNGKey(jcfg.data.seed), r)
        keys = torch.from_numpy(np.array(jax.random.uniform(key, tfed.client_idx.shape)))
        jm = jfed.step()
        tm = tfed.step(tfed.device_batch(r, keys=keys))
        np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=1e-5)
        got, want = to_flax(tfed.state.params), jax.tree.map(np.asarray, jfed.state.params)
        for mod in want:
            for leaf in want[mod]:
                np.testing.assert_allclose(
                    got[mod][leaf], want[mod][leaf], atol=1e-5, rtol=1e-4,
                    err_msg=f"round {r} {mod}/{leaf}",
                )


@pytest.mark.parametrize("layout", ["presharded", "gather"])
def test_unshuffled_layouts_give_the_same_batches(layout):
    """With shuffling off (round_robin) both layouts take every client's
    shard from its head, as in fedtpu."""
    _, tcfg = _both_configs(data_kw=dict(partition="round_robin", device_layout=layout))
    rng = np.random.default_rng(10)
    data = (rng.normal(size=(64, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, size=64).astype(np.int32))
    _, base = _both_configs(data_kw=dict(partition="round_robin"))
    want = TFederation(base, data=data, device="cpu").device_batch(1)
    got = TFederation(tcfg, data=data, device="cpu").device_batch(1)
    assert torch.equal(got.x, want.x) and torch.equal(got.y.long(), want.y.long())


def test_skewed_presharded_footprint_falls_back_to_gather():
    """round_robin deals 4 batches of 16 to 16 clients: 12 empty shards
    make the presharded rows 8x the data, so both engines warn and take the
    gather layout; a round runs."""
    jcfg, tcfg = _both_configs(
        data_kw=dict(partition="round_robin", batch_size=16), num_clients=16
    )
    rng = np.random.default_rng(11)
    data = (rng.normal(size=(64, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, size=64).astype(np.int32))
    with pytest.warns(UserWarning, match="falling back to 'gather'"):
        tfed = TFederation(tcfg, data=data, device="cpu")
    with pytest.warns(UserWarning, match="falling back to 'gather'"):
        jfed = JFederation(jcfg, data=data)
    assert tfed.layout == jfed._layout == "gather"
    assert np.isfinite(float(tfed.step().loss))
    _, balanced = _both_configs(data_kw=dict(partition="round_robin", batch_size=16))
    assert TFederation(balanced, data=data, device="cpu").layout == "presharded"


def test_default_config_builds_a_federation():
    """``RoundConfig()`` names MobileNet, the reference's default model."""
    data = (np.zeros((64, 32, 32, 3), np.float32), np.zeros(64, np.int32))
    fed = TFederation(tconfig.RoundConfig(), data=data, device="cpu")
    assert fed.cfg.model == "MobileNet"
    assert fed.state.batch_stats["DepthwiseSeparable_12.BatchNorm_1.var"].shape == (1024,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TFederation(tconfig.RoundConfig(), data=data)


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
    "efficientnetb0",
    "status_snapshot",
    "PNASNetA",
], ids=repr)
def test_unported_options_raise_naming_the_roadmap(part, monkeypatch):
    """A slice-8 surface, or a model name still listed in
    ``registry.NOT_PORTED``, raises naming its ROADMAP item. Every name of
    fedtpu's zoo is ported: the model cases list theirs there. The engine's
    status board waits for the observability slice."""
    data = (np.zeros((64, 32, 32, 3), np.float32), np.zeros(64, np.int32))
    if part == "status_snapshot":
        # The board runs since slice 8 part 5a; mesh= waits for part 6.
        fed = TFederation(tconfig.RoundConfig(model="smallcnn"), data=data, device="cpu")
        snap = fed.status_snapshot()
        assert (snap["role"], snap["phase"], snap["round"]) == ("engine", "init", 0)
        with pytest.raises(NotImplementedError, match="ROADMAP.*slice 8, part 6"):
            TFederation(tconfig.RoundConfig(model="smallcnn"), data=data, mesh=object(), device="cpu")
        return
    if isinstance(part, str):
        monkeypatch.setattr(registry, "NOT_PORTED", (part.lower(),))
        cfg = tconfig.RoundConfig(model=part)
    else:
        field = {_F: "fed", _D: "data", _O: "opt"}[type(part)]
        cfg = tconfig.RoundConfig(model="smallcnn", **{field: part})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TFederation(cfg, data=(np.zeros((64, 32, 32, 3), np.float32), np.zeros(64, np.int32)),
                    device="cpu")


@pytest.mark.parametrize("fed,match", [
    (dict(aggregator="median", compression="topk"), "cannot compose with delta compression"),
    (dict(aggregator="krum", compression="int8", delta_layout="flat"), "cannot compose with delta compression"),
    (dict(dp_clip_norm=1.0, compression="int8", weighted=False), "DP clipping cannot compose"),
    (dict(dp_clip_norm=1.0), "DP requires uniform weighting"),
    (dict(dp_clip_norm=1.0, weighted=False, aggregator="median"), "assumes the mean aggregator"),
    (dict(aggregator="trimmed_mean", trim_fraction=0.5), r"trim_fraction must be in \[0, 0.5\)"),
    (dict(megabatch_clients=3, num_clients=4), "must divide"),
    (dict(screen=dict(cos_min=1.5)), "cos_min must be in"),
    (dict(screen=dict(norm_max=1.0, release_at=0.9)), "release_at"),
    (dict(aggregator="mode"), "unknown aggregator"),
], ids=lambda v: v if isinstance(v, str) else repr(v))
def test_forbidden_combinations_raise_fedtpus_errors(fed, match):
    """The port refuses what fedtpu refuses, with fedtpu's message: both
    packages raise ``ValueError`` on the same config."""
    def build(mod):
        kw = dict(fed)
        if "screen" in kw:
            kw["screen"] = mod.ScreenConfig(**kw["screen"])
        return mod.RoundConfig(
            model="smallcnn",
            data=mod.DataConfig(batch_size=8, partition="iid", augment=False),
            fed=mod.FedConfig(**{"num_clients": 4, **kw}),
        )

    data = (np.zeros((64, 32, 32, 3), np.float32), np.zeros(64, np.int32))
    with pytest.raises(ValueError, match=match):
        TFederation(build(tconfig), data=data, device="cpu")
    with pytest.raises(ValueError, match=match):
        JFederation(build(jconfig), data=data)


def test_dp_refuses_a_batchnorm_model_like_fedtpu():
    cfg = tconfig.RoundConfig(
        model="mobilenet", data=_D(batch_size=4, partition="iid", augment=False),
        fed=_F(num_clients=2, dp_clip_norm=1.0, weighted=False),
    )
    with pytest.raises(ValueError, match="BatchNorm-free"):
        TFederation(cfg, data=(np.zeros((16, 32, 32, 3), np.float32), np.zeros(16, np.int32)), device="cpu")


def test_robust_aggregator_with_weights_warns_once(caplog):
    tround._WEIGHTED_ROBUST_WARNED.discard("median")
    cfg = tconfig.RoundConfig(model="smallcnn", fed=_F(num_clients=4, aggregator="median"))
    with caplog.at_level("WARNING", logger="fedtpu_torch.round"):
        tround.make_round_step(tmodels.create("smallcnn", 10), cfg)
        tround.make_round_step(tmodels.create("smallcnn", 10), cfg)
    assert sum("ignores example-count weights" in r.message for r in caplog.records) == 1


@pytest.mark.parametrize("compression", ["rotq", "randk"])
def test_flat_only_codec_on_per_leaf_layout_raises(compression):
    cfg = tconfig.RoundConfig(model="smallcnn", fed=_F(compression=compression))
    with pytest.raises(ValueError, match="flat-layout codec"):
        TFederation(cfg, device="cpu")


def test_per_leaf_compressor_on_flat_layout_raises():
    _, tcfg = _both_configs(delta_layout="flat")
    with pytest.raises(ValueError, match="flat-layout compressor"):
        tround.make_round_step(
            tmodels.create("smallcnn", 10), tcfg, tcomp.make_topk(0.01)
        )
