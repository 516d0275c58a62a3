"""The port's round options against fedtpu on the same numpy inputs.

fedtpu runs as its own CPU tests run it (eagerly or jitted, f32). Its
threefry draws (DP noise) are handed to the port. Tolerances:

- the median, the trimmed mean (its band summed in client order, as
  XLA's reduction adds), Krum's choice and output, the Dirichlet
  partition, the host batches, the loss-sampled masks, the bf16-momentum
  step (against fedtpu's eager step) and DP noise on injected draws are
  bit-equal;
- DP clipping agrees within ``rtol=1e-6``: it takes a square root, and
  XLA's CPU ``sqrt`` is not correctly rounded;
- screening's verdicts are equal, its statistics within ``rtol=1e-5``;
- whole smallcnn rounds (FedProx on a Dirichlet assignment, DP, a robust
  aggregator, screening) keep the global params within ``atol=1e-5,
  rtol=1e-4``, as ``test_torch_round.py`` holds the plain round.
"""

import warnings
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
from fedtpu.data import device as jdevice
from fedtpu.data import partition as jpartition
from fedtpu.ops import flat as jflat
from fedtpu_torch import config as tconfig
from fedtpu_torch.convert import from_flax, to_flax
from fedtpu_torch.core import optim as toptim
from fedtpu_torch.core import round as tround
from fedtpu_torch.core.engine import Federation as TFederation
from fedtpu_torch.data import partition as tpartition
from fedtpu_torch.ops import flat as tflat
from fedtpu_torch.ops import quantile
from torch_parity import bits, configs, seeded_data, track


# ------------------------------------------------------- the two repairs


@pytest.mark.parametrize("t_max", [200, 10, 50])
def test_cosine_rates_exact_over_the_horizon(t_max):
    """Every f32 rate of rounds ``0..t_max + 60`` is fedtpu's compiled one,
    bit for bit: no round is allowed an ulp (the correctly rounded cosine
    would miss rounds 148 of 200 and 37 of 50 by two)."""
    jcfg = jconfig.OptimizerConfig(schedule="cosine", cosine_t_max=t_max)
    tcfg = tconfig.OptimizerConfig(schedule="cosine", cosine_t_max=t_max)
    rate = jax.jit(jcfg.lr_at)
    for r in range(t_max + 61):
        got = tcfg.lr_at(r)
        assert np.float32(got) == got  # an f32 value
        assert bits(got) == bits(rate(jnp.int32(r))), r


def _skewed_assignment():
    """16 clients over 64 examples: client 0 holds 40, the others 0-2 each
    (some none): the presharded footprint is far above twice the data."""
    owner = np.concatenate([np.zeros(40, int), np.arange(24) % 12 + 1])
    return tpartition._owner_to_shards(owner, 16)


def test_assignment_gives_fedtpus_first_round_batch():
    idx, mask = _skewed_assignment()
    jcfg, tcfg = configs(num_clients=16, data_kw=dict(batch_size=4))
    data = seeded_data(1)
    with pytest.warns(UserWarning, match="falling back to 'gather'"):
        jfed = JFederation(jcfg, data=data, assignment=(idx, mask))
    with pytest.warns(UserWarning, match="falling back to 'gather'"):
        tfed = TFederation(tcfg, data=data, device="cpu", assignment=(idx, mask))
    assert jfed._layout == tfed.layout == "gather"
    want, got = jfed.round_batch(0), tfed.round_batch(0)
    for field in ("x", "y", "step_mask", "weights", "alive"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)), err_msg=field)
    # The device-gathered batch of round 0 from fedtpu's keys.
    key = jax.random.fold_in(jax.random.PRNGKey(jcfg.data.seed), 0)
    keys = np.array(jax.random.uniform(key, idx.shape))
    take = jdevice.round_take_indices(jnp.asarray(idx), jnp.asarray(mask), 2 * 4, key)
    dev = tfed.device_batch(0, keys=torch.from_numpy(keys))
    np.testing.assert_array_equal(dev.y.numpy().reshape(16, -1), data[1][np.asarray(take)])
    np.testing.assert_array_equal(dev.step_mask.numpy()[:, 0], mask.any(axis=1))


def test_set_assignment_follows_fedtpus_rules():
    idx, mask = _skewed_assignment()
    _, tcfg = configs(num_clients=16, data_kw=dict(batch_size=4, device_layout="gather"))
    tfed = TFederation(tcfg, data=seeded_data(1), device="cpu", assignment=(idx, mask))
    tfed.device_batch(0)  # uploads the data
    idx2, mask2 = idx[::-1].copy(), mask[::-1].copy()
    tfed.set_assignment(idx2, mask2)
    np.testing.assert_array_equal(tfed.weights.numpy(), mask2.sum(1).astype(np.float32))
    assert torch.equal(tfed._device_data[2], torch.from_numpy(idx2.astype(np.int64)))
    assert np.isfinite(float(tfed.step().loss))
    with pytest.raises(ValueError, match="must match"):
        tfed.set_assignment(idx[:, :3], mask[:, :3])
    with pytest.raises(ValueError, match="must be"):
        TFederation(tcfg, data=seeded_data(1), device="cpu", assignment=(idx[:3], mask[:3]))
    _, balanced = configs()
    with pytest.raises(ValueError, match="gather"):
        TFederation(balanced, data=seeded_data(1), device="cpu").set_assignment(*tpartition.iid(64, 4))


# ------------------------------------------------- robust aggregators


def _stacked(rng, n, shapes):
    return {k: rng.normal(size=(n,) + s).astype(np.float32) for k, s in shapes.items()}


_SHAPES = {"a": (7, 3), "b": (5,)}


@pytest.mark.parametrize("alive", [
    [1, 1, 1, 1, 1],          # odd live count
    [1, 1, 1, 1, 1, 1],       # even: the mean of the two middle values
    [1, 0, 1, 1, 0, 1],       # dead rows, even live count
    [0, 1, 0, 1, 1, 0, 1],    # dead rows, even
    [0, 0, 0, 0],             # nobody live: no update
], ids=["odd", "even", "dead_even", "dead_even_7", "all_dead"])
def test_median_bit_equal(alive):
    rng = np.random.default_rng(len(alive))
    x = _stacked(rng, len(alive), _SHAPES)
    w = np.asarray(alive, np.float32) * 3.0
    want = jround._robust_over_clients(jax.tree.map(jnp.asarray, x), jnp.asarray(w), None, "median", 0.1)
    got = tround._robust_over_clients({k: torch.from_numpy(v) for k, v in x.items()}, torch.from_numpy(w), "median", 0.1)
    for k in x:
        np.testing.assert_array_equal(bits(got[k]), bits(want[k]), err_msg=k)


@pytest.mark.parametrize("trim", [0.1, 0.25])
@pytest.mark.parametrize("n_alive", [5, 8])
def test_trimmed_mean_matches_fedtpu(trim, n_alive):
    rng = np.random.default_rng(int(trim * 100) + n_alive)
    x = _stacked(rng, 9, _SHAPES)
    w = np.zeros(9, np.float32)
    w[rng.choice(9, n_alive, replace=False)] = 1.0
    want = jround._robust_over_clients(jax.tree.map(jnp.asarray, x), jnp.asarray(w), None, "trimmed_mean", trim)
    got = tround._robust_over_clients({k: torch.from_numpy(v) for k, v in x.items()}, torch.from_numpy(w), "trimmed_mean", trim)
    for k in x:
        np.testing.assert_array_equal(bits(got[k]), bits(want[k]), err_msg=k)


def test_trimmed_mean_at_trim_zero_is_the_exact_uniform_mean():
    rng = np.random.default_rng(3)
    x = {k: torch.from_numpy(v) for k, v in _stacked(rng, 6, _SHAPES).items()}
    w = torch.tensor([2.0, 0.0, 5.0, 1.0, 1.0, 0.0])
    got = tround._robust_over_clients(x, w, "trimmed_mean", 0.0)
    uniform = (w > 0).float()
    want_j = jround._robust_over_clients(
        {k: jnp.asarray(v.numpy()) for k, v in x.items()}, jnp.asarray(w.numpy()), None, "trimmed_mean", 0.0)
    for k, v in x.items():
        assert torch.equal(got[k].view(torch.int32), tround._mean_over_clients(v, uniform).view(torch.int32))
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want_j[k]), rtol=1e-6)  # a weighted sum


def test_trimmed_mean_above_2_pow_24_elements_sorts(monkeypatch):
    """One leaf of 8 x 2,097,153 > 2^24 elements, where torch.quantile
    refuses: the port sorts instead (torch.quantile is made to raise)."""
    def refuse(*a, **k):
        raise AssertionError("torch.quantile must not be used")

    monkeypatch.setattr(torch, "quantile", refuse)
    monkeypatch.setattr(torch, "nanquantile", refuse)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(8, 2_097_153)).astype(np.float32)
    w = np.array([1, 1, 0, 1, 1, 1, 1, 1], np.float32)
    got = tround._robust_over_clients({"x": torch.from_numpy(x)}, torch.from_numpy(w), "trimmed_mean", 0.2)["x"]
    live = x[w > 0]
    srt = np.sort(live, axis=0)
    lo, hi = srt[1], srt[-2]  # q*(n-1) = 1.2 -> lower 1; 0.8*6 = 4.8 -> higher 5
    band = np.where((live >= lo) & (live <= hi), live, np.nan)
    np.testing.assert_allclose(got.numpy(), np.nanmean(band, axis=0), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("method,q", [("lower", 0.1), ("higher", 0.9), ("midpoint", 0.5)])
def test_nanquantile_matches_jnp(method, q):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(11, 40)).astype(np.float32)
    x[[2, 5, 7]] = np.nan
    want = jnp.nanquantile(jnp.asarray(x), q, axis=0, method=method)
    got = quantile.nanquantile(torch.from_numpy(x), q, method)
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("alive", [[1] * 7, [1, 0, 1, 1, 1, 0, 1, 1]], ids=["all", "dead_rows"])
def test_krum_selects_and_copies_fedtpus_client(alive):
    rng = np.random.default_rng(6)
    n = len(alive)
    base = rng.normal(size=(1, 30)).astype(np.float32)
    x = {"p": base + 0.1 * rng.normal(size=(n, 30)).astype(np.float32),
         "s": rng.normal(size=(n, 4)).astype(np.float32)}
    x["p"][0] += 5.0  # an outlier Krum must not pick
    w = np.asarray(alive, np.float32)
    want = jround._krum_over_clients(jax.tree.map(jnp.asarray, x), jnp.asarray(w), None, 0.25)
    got_p, got_s = tround._krum_over_clients(
        ({"p": torch.from_numpy(x["p"])}, {"s": torch.from_numpy(x["s"])}), torch.from_numpy(w), 0.25)
    chosen = [i for i in range(n) if np.array_equal(x["p"][i], np.asarray(want["p"]))]
    assert len(chosen) == 1 and chosen[0] != 0 and alive[chosen[0]]
    np.testing.assert_array_equal(got_p["p"].numpy(), np.asarray(want["p"]))
    np.testing.assert_array_equal(got_s["s"].numpy(), np.asarray(want["s"]))


def test_krum_with_no_live_client_is_zero():
    x = {"p": torch.ones(4, 3)}
    (got,) = tround._krum_over_clients((x,), torch.zeros(4), 0.1)
    assert torch.equal(got["p"], torch.zeros(3))


# ---------------------------------------------------------------- DP


def test_dp_clip_matches_fedtpu():
    rng = np.random.default_rng(7)
    x = {"Conv_0.bias": rng.normal(size=(5, 6)).astype(np.float32),
         "Conv_0.weight": rng.normal(size=(5, 6, 3, 3, 3)).astype(np.float32)}
    for v in x.values():
        v[1] *= 1e-2  # a row under the clip norm stays as it is
    want = jround._dp_clip(jax.tree.map(jnp.asarray, x), 1.5)
    got = tround._dp_clip({k: torch.from_numpy(v) for k, v in x.items()}, 1.5)
    for k in x:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got["Conv_0.bias"][1].numpy(), x["Conv_0.bias"][1])


def test_dp_noise_bit_equal_with_fedtpus_draws():
    rng = np.random.default_rng(8)
    tree = {"Conv_0.bias": rng.normal(size=(6,)).astype(np.float32),
            "Dense_0.weight": rng.normal(size=(4, 6)).astype(np.float32)}
    std, r, seed = np.float32(0.3), 5, 0x5F5E5F
    want = jround._dp_noise(jax.tree.map(jnp.asarray, tree), jnp.float32(std), jnp.int32(r), seed)
    base = jax.random.fold_in(jax.random.PRNGKey(seed), r)
    keys = jax.random.split(base, len(tree))
    normals = {k: torch.from_numpy(np.array(jax.random.normal(kk, tree[k].shape, jnp.float32)))
               for k, kk in zip(sorted(tree), keys)}
    got = tround._dp_noise({k: torch.from_numpy(v) for k, v in tree.items()}, torch.tensor(std), r, seed, normals)
    for k in tree:
        np.testing.assert_array_equal(bits(got[k]), bits(want[k]), err_msg=k)
    # Its own draws: seeded by (seed, round), reproducible.
    a = tround._dp_noise({k: torch.from_numpy(v) for k, v in tree.items()}, torch.tensor(std), r, seed)
    b = tround._dp_noise({k: torch.from_numpy(v) for k, v in tree.items()}, torch.tensor(std), r, seed)
    assert all(torch.equal(a[k], b[k]) for k in tree)


# ---------------------------------------------------------- screening


@pytest.mark.parametrize("alive", [[1] * 8, [1, 1, 0, 1, 1, 1, 1, 0], [1, 1, 0, 0]], ids=["all", "dead", "few"])
def test_screen_rows_verdicts_equal(alive):
    rng = np.random.default_rng(9)
    n = len(alive)
    honest = rng.normal(size=(1, 300)).astype(np.float32)
    rows = honest + 0.5 * rng.normal(size=(n, 300)).astype(np.float32)
    rows[1] *= -1.0   # sign-flipped
    rows[3] *= 20.0   # boosted
    w = np.asarray(alive, np.float32)
    for thr in (dict(zmax=3.0), dict(cos_min=0.0), dict(norm_max=40.0), dict(zmax=3.0, cos_min=0.0)):
        keep_j, stats_j = jflat.screen_rows(jnp.asarray(rows), jnp.asarray(w), **thr)
        keep_t, stats_t = tflat.screen_rows(torch.from_numpy(rows), torch.from_numpy(w), **thr)
        np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j), err_msg=str(thr))
        for k in ("norm", "cos", "z"):
            np.testing.assert_allclose(stats_t[k].numpy(), np.asarray(stats_j[k]), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------- partitions


@pytest.mark.parametrize("alpha,clients", [(0.5, 8), (0.1, 16), (5.0, 4)])
def test_dirichlet_bit_equal(alpha, clients):
    labels = np.random.default_rng(10).integers(0, 10, size=500).astype(np.int32)
    for a, b in zip(tpartition.dirichlet(labels, clients, alpha=alpha, seed=3),
                    jpartition.dirichlet(labels, clients, alpha=alpha, seed=3)):
        np.testing.assert_array_equal(a, b)


def test_dirichlet_topup_and_raise_like_fedtpu():
    """48 examples over 16 clients at alpha 0.05 leave some client under 2
    after 100 draws: topup warns and moves examples as fedtpu does; raise
    raises."""
    labels = np.random.default_rng(11).integers(0, 4, size=48).astype(np.int32)
    kw = dict(alpha=0.05, seed=0, min_size=2)
    with pytest.warns(UserWarning, match="topping up"):
        got = tpartition.dirichlet(labels, 16, **kw)
    with pytest.warns(UserWarning, match="topping up"):
        want = jpartition.dirichlet(labels, 16, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[1].sum(1).min() >= 2
    with pytest.raises(ValueError, match="could not satisfy"):
        tpartition.dirichlet(labels, 16, min_size_action="raise", **kw)


@pytest.mark.parametrize("partition", ["dirichlet", "round_robin"])
def test_round_batch_bit_equal(partition):
    jcfg, tcfg = configs(data_kw=dict(partition=partition, batch_size=4), num_clients=6)
    data = seeded_data(12, 96)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jfed = JFederation(jcfg, data=data)
        tfed = TFederation(tcfg, data=data, device="cpu")
    np.testing.assert_array_equal(tfed.client_idx, jfed.client_idx)
    for r in (0, 3):
        want, got = jfed.round_batch(r), tfed.round_batch(r)
        for field in ("x", "y", "step_mask", "weights", "alive"):
            np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)))


def test_make_client_batches_bit_equal():
    images, labels = seeded_data(13, 50)
    idx, mask = tpartition.dirichlet(labels, 5, alpha=0.3, seed=1)
    mask[4] = False  # a client with no data: zero rows, masked steps
    for shuffle in (False, True):
        got = tpartition.make_client_batches(images, labels, idx, mask, 4, 3, seed=2, shuffle=shuffle)
        want = jpartition.make_client_batches(images, labels, idx, mask, 4, 3, seed=2, shuffle=shuffle)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


# -------------------------------------------------- bf16 momentum


@pytest.mark.parametrize("nesterov", [False, True])
def test_bf16_momentum_step_bit_equal(nesterov):
    rng = np.random.default_rng(14)
    shapes = {"w": (3, 5, 7), "b": (3, 7)}
    p, g, m = ({k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()} for _ in range(3))
    jcfg = jconfig.OptimizerConfig(momentum_dtype="bfloat16", nesterov=nesterov)
    tcfg = tconfig.OptimizerConfig(momentum_dtype="bfloat16", nesterov=nesterov)
    jm = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in m.items()}
    jp, js = joptim.apply(jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g),
                          joptim.SGDState(momentum=jm), tcfg.lr_at(0), jcfg)
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    tp, tm = toptim.apply(t(p), t(g), {k: v.to(torch.bfloat16) for k, v in t(m).items()}, tcfg.lr_at(0), tcfg)
    for k in shapes:
        assert tm[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
        np.testing.assert_array_equal(tm[k].float().numpy(), np.asarray(js.momentum[k].astype(jnp.float32)))
    state = toptim.init({"w": torch.zeros(2, 3)}, 4, tcfg)
    assert state["w"].dtype == torch.bfloat16 and state["w"].shape == (4, 2, 3)


# ----------------------------------------------------- whole rounds


def test_fedprox_on_dirichlet_tracks_fedtpu():
    jcfg, tcfg = configs(data_kw=dict(partition="dirichlet"), algorithm="fedprox", fedprox_mu=0.5)
    jfed, tfed = track(jcfg, tcfg)
    np.testing.assert_array_equal(tfed.client_idx, jfed.client_idx)


def test_fedprox_term_moves_the_round():
    """mu > 0 changes the params against plain FedAvg (the term is live)."""
    _, plain = configs()
    _, prox = configs(algorithm="fedprox", fedprox_mu=5.0)
    data = seeded_data(21)
    outs = []
    for cfg in (plain, prox):
        fed = TFederation(cfg, seed=0, data=data, device="cpu")
        fed.step()
        outs.append(fed.state.params["Dense_1.weight"])
    assert not torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("layout", ["per_leaf", "flat"])
def test_dp_round_tracks_fedtpu_with_its_draws(layout):
    jcfg, tcfg = configs(dp_clip_norm=0.5, dp_noise_multiplier=0.1, weighted=False, delta_layout=layout)
    track(jcfg, tcfg, alive=[True, True, False, True], dp_draws=True)


@pytest.mark.parametrize("aggregator", ["median", "trimmed_mean", "krum"])
def test_robust_round_tracks_fedtpu(aggregator):
    jcfg, tcfg = configs(aggregator=aggregator, weighted=False, trim_fraction=0.25)
    track(jcfg, tcfg, alive=[True, True, True, False])


def test_screened_round_tracks_fedtpu():
    """One round with a boosted, sign-flipped attacker seat: the same rows
    screened, and the same params."""
    jcfg, tcfg = configs(
        weighted=False, sim=dict(malicious_fraction=0.25, attack="scale:factor=-8"),
        screen=dict(zmax=3.0, cos_min=-0.5),
    )
    data = seeded_data(22)
    jfed = JFederation(jcfg, seed=0, data=data)
    tfed = TFederation(tcfg, seed=0, data=data, device="cpu")
    np.testing.assert_array_equal(tfed.attacker_clients, jfed.attacker_clients)
    tfed.state = tfed.state._replace(params=from_flax(jax.tree.map(np.asarray, jfed.state.params)))
    jm, tm = jfed.step(jfed.round_batch(0)), tfed.step(tfed.round_batch(0))
    np.testing.assert_array_equal(tm.screened.numpy(), np.asarray(jm.screened))
    assert tm.screened.numpy()[tfed.attacker_clients].all()
    got, want = to_flax(tfed.state.params), jax.tree.map(np.asarray, jfed.state.params)
    for mod in want:
        for leaf in want[mod]:
            np.testing.assert_allclose(got[mod][leaf], want[mod][leaf], atol=1e-5, rtol=1e-4)


# -------------------------------------------------- loss sampling


def _losses():
    return np.array([2.0, np.nan, 0.5, 3.0, 1.0, np.nan], np.float32)


def test_loss_sampled_masks_bit_equal():
    jcfg, tcfg = configs(num_clients=6, participation_fraction=0.5, participation_sampling="loss")
    alive = np.array([True, True, True, False, True, True])
    losses = _losses()
    for r in range(8):
        want = JFederation._alive_for_round(
            SimpleNamespace(alive=alive, cfg=jcfg, _state=SimpleNamespace(last_client_loss=jnp.asarray(losses))), r)
        got = TFederation._alive_for_round(SimpleNamespace(alive=alive, cfg=tcfg), r, losses)
        np.testing.assert_array_equal(got, want)
    # Nothing observed yet: uniform, as fedtpu.
    nan = np.full(6, np.nan, np.float32)
    want = JFederation._alive_for_round(
        SimpleNamespace(alive=alive, cfg=jcfg, _state=SimpleNamespace(last_client_loss=jnp.asarray(nan))), 2)
    np.testing.assert_array_equal(TFederation._alive_for_round(SimpleNamespace(alive=alive, cfg=tcfg), 2, nan), want)


def test_loss_sampling_in_step_and_run_on_device():
    """``step`` reads the losses each round; ``run_on_device`` draws every
    round of its block from the losses known when it starts (one read),
    as fedtpu's fused block does."""
    jcfg, tcfg = configs(num_clients=6, participation_fraction=0.5, participation_sampling="loss")
    tfed = TFederation(tcfg, seed=0, data=seeded_data(24, 96), device="cpu")
    seen = []
    inner = tfed._round_step

    def spy(state, batch, generator=None):
        seen.append(batch.alive.numpy().copy())
        return inner(state, batch, generator)

    tfed._round_step = spy
    losses = _losses()
    tfed.state = tfed.state._replace(last_client_loss=torch.from_numpy(losses))

    def fedtpu_mask(r, obs):
        return JFederation._alive_for_round(SimpleNamespace(
            alive=np.ones(6, bool), cfg=jcfg, _state=SimpleNamespace(last_client_loss=jnp.asarray(obs))), r)

    tfed.run_on_device(3)
    for r in range(3):
        np.testing.assert_array_equal(seen[r], fedtpu_mask(r, losses))
    before = tfed.state.last_client_loss.numpy().copy()
    tfed.step()
    np.testing.assert_array_equal(seen[3], fedtpu_mask(3, before))
    trained = seen[3]
    after = tfed.state.last_client_loss.numpy()
    np.testing.assert_array_equal(after[~trained], before[~trained])
    assert np.isfinite(after[trained]).all()


def test_last_client_loss_is_nan_until_trained():
    _, tcfg = configs()
    tfed = TFederation(tcfg, seed=0, data=seeded_data(25), device="cpu")
    assert torch.isnan(tfed.state.last_client_loss).all()
    tfed.set_alive(2, False)
    tfed.step()
    got = tfed.state.last_client_loss
    assert torch.isnan(got[2]) and torch.isfinite(got[[0, 1, 3]]).all()


# --------------------------------------------------------- the record


def test_run_records_fedtpus_fields(tmp_path):
    from fedtpu_torch.utils.metrics import MetricsLogger

    _, tcfg = configs()
    data = seeded_data(26)
    tfed = TFederation(tcfg, seed=0, data=data, device="cpu")
    path = tmp_path / "rounds.jsonl"
    with MetricsLogger(str(path), echo=False) as logger:
        tfed.run(2, logger=logger, eval_every=2, eval_data=(data[0][:32], data[1][:32]))
    lines = path.read_text().splitlines()
    assert len(lines) == 2
    import json

    last = json.loads(lines[-1])
    for key in ("loss", "acc", "active", "worst_client_loss", "round_s", "dataset",
                "data_source", "test_loss", "test_acc"):
        assert key in last, key
    assert last["data_source"] == "caller" and last["dataset"] == "cifar10"
    assert tfed.eval_history and tfed.history[-1]["round"] == 1
