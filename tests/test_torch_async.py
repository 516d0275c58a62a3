"""The port's asynchronous engine (``fedtpu_torch.core.async_engine``)
against fedtpu's on the CPU.

fedtpu's ``tiny_cfg`` (``tests/test_async_engine.py``: mlp, 4 clients,
batch 8, 256 synthetic examples, 2 steps). The same starting state goes
into both engines (fedtpu's, installed through ``load_state``), the port's
ticks take fedtpu's presharded offsets, and the arrival draws are fedtpu's
numpy draws: every state field within ``atol=1e-5, rtol=1e-4`` after one
and several ticks, the counters and flags equal. ``fedbuff_combine`` is
bit-equal to fedtpu's at staleness powers 0.5, 1 and 2 (XLA's and torch's
``pow`` agree there in f32). Then fedtpu's own properties, on the port:
the staleness accounting, fused ticks equal to sequential ones,
``buffer_k == N`` equal to the synchronous engine, the per-client FedProx
anchor, a dead client, one epoch per pull; the generation is fedtpu's
``AsyncState`` bytes but for ``client_rng``, and a resume is bit-equal to
a run that never stopped. One BatchNorm case runs both packages' tick in
f64 on a small conv model (4x4 inputs, batch 4: 64 values a channel).
"""

import dataclasses
import warnings

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from fedtpu import config as jconfig
from fedtpu.core import async_engine as jasync
from fedtpu.data.device import _round_offset
from fedtpu.models.common import batch_norm as jbn
from fedtpu.transport import wire as jwire
from fedtpu_torch import config as tconfig
from fedtpu_torch.convert import from_flax
from fedtpu_torch.core import async_engine as tasync
from fedtpu_torch.core.engine import Federation as TFederation
from fedtpu_torch.models.common import BatchNorm, name_batch_norms
from fedtpu_torch.transport import wire as twire

TOL = dict(atol=1e-5, rtol=1e-4)


def tiny_cfg(mod, num_clients=4, partition="round_robin", **fed_kw):
    return mod.RoundConfig(
        model="mlp",
        num_classes=10,
        opt=mod.OptimizerConfig(learning_rate=0.05, weight_decay=0.0),
        data=mod.DataConfig(dataset="synthetic", batch_size=8, eval_batch_size=64, num_examples=256,
                            augment=False, partition=partition),
        fed=mod.FedConfig(num_clients=num_clients, **fed_kw),
        steps_per_round=2,
    )


def port(num_clients=4, **kw) -> tasync.AsyncFederation:
    cfg = tiny_cfg(tconfig, num_clients, kw.pop("partition", "round_robin"), **kw.pop("fed_kw", {}))
    return tasync.AsyncFederation(cfg, device="cpu", **kw)


def fedtpu_offset(j, version: int) -> int:
    """fedtpu's presharded rotation offset of a tick."""
    labels = j._fed._ensure_device_data()[1]
    return int(_round_offset(labels, j._fed._shuffle, jax.random.fold_in(j._fed._data_key, version))[0])


def install(t, jstate) -> None:
    """fedtpu's state (a device or host tree) into the port's engine, the
    port's own generator kept."""
    host = jax.tree.map(np.asarray, jstate)
    t.load_state(host._replace(client_rng=t.generation.client_rng))


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def assert_state_close(t, jstate, what=""):
    got, want = t.generation, jax.tree.map(np.asarray, jstate)
    for field in ("params", "batch_stats", "client_params", "client_stats", "base_params", "base_stats"):
        for a, b in zip(_leaves(getattr(got, field)), _leaves(getattr(want, field)), strict=True):
            np.testing.assert_allclose(a, b, **TOL, err_msg=f"{what} {field}")
    for a, b in zip(_leaves(got.opt_state["momentum"]), _leaves(want.opt_state.momentum), strict=True):
        np.testing.assert_allclose(a, b, **TOL, err_msg=f"{what} momentum")
    np.testing.assert_allclose(got.last_client_loss, want.last_client_loss, **TOL)
    for field in ("base_version", "version", "pending"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=f"{what} {field}")


# ----------------------------------------------------------- the combine
@pytest.mark.parametrize("damping", [True, False])
@pytest.mark.parametrize("power", [0.5, 1.0, 2.0])
def test_fedbuff_combine_is_fedtpus(damping, power):
    rng = np.random.default_rng(3)
    stacked = {"a": rng.normal(size=(5, 7, 3)).astype(np.float32), "b": rng.normal(size=(5, 11)).astype(np.float32)}
    raw_w = (rng.integers(1, 50, 5) * (rng.random(5) < 0.6)).astype(np.float32)
    staleness = rng.integers(0, 9, 5).astype(np.float32)
    want = jasync.fedbuff_combine(jax.tree.map(jnp.asarray, stacked), jnp.asarray(raw_w), jnp.asarray(staleness),
                                  power, staleness_damping=damping)
    got = tasync.fedbuff_combine({k: torch.from_numpy(v) for k, v in stacked.items()}, torch.from_numpy(raw_w),
                                 torch.from_numpy(staleness), power, staleness_damping=damping)
    for k in stacked:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_fedbuff_combine_of_no_arrival_is_zero():
    got = tasync.fedbuff_combine({"a": torch.ones(3, 2)}, torch.zeros(3), torch.zeros(3), 0.5)
    assert torch.equal(got["a"], torch.zeros(2))


# ------------------------------------------------------------ the draws
@pytest.mark.parametrize("sigma,seed", [(0.0, 0), (0.7, 1), (1.0, 5)])
def test_arrival_draws_are_fedtpus_bit_for_bit(sigma, seed):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = jasync.AsyncFederation(tiny_cfg(jconfig, 8), seed=seed, buffer_k=3, speed_sigma=sigma)
    t = port(8, seed=seed, buffer_k=3, speed_sigma=sigma)
    np.testing.assert_array_equal(t._speeds, j._speeds)
    for i in range(12):
        if i == 5:  # fewer live than... still k of the live, and none of the dead
            j.set_alive(2, False)
            t.set_alive(2, False)
        a, b = t._arrive_mask(), j._arrive_mask()
        np.testing.assert_array_equal(a, b)
        assert a.sum() == 3 and (i < 5 or not a[2])


# --------------------------------------------------------------- ticks
@pytest.fixture(scope="module")
def fedtpu_run():
    """fedtpu's engine on the iid (shuffled) tiny config: its start state,
    then its state, metrics and offsets after each of 3 ticks."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = jasync.AsyncFederation(tiny_cfg(jconfig, partition="iid"), seed=1, buffer_k=2, speed_sigma=0.7)
    start = jax.tree.map(np.asarray, j.state)
    ticks = []
    for v in range(3):
        off = fedtpu_offset(j, v)
        m = j.tick()
        ticks.append((off, jax.tree.map(np.asarray, m), jax.tree.map(np.asarray, j.state)))
    return start, ticks


@pytest.mark.parametrize("num_ticks", [1, 3])
def test_ticks_match_fedtpus_with_its_offsets(fedtpu_run, num_ticks):
    start, ticks = fedtpu_run
    t = port(partition="iid", seed=1, buffer_k=2, speed_sigma=0.7)
    install(t, start)
    for i in range(num_ticks):
        off, jm, jstate = ticks[i]
        m = t.tick(offset=off)
        assert float(m.num_arrived) == float(jm.num_arrived) == 2.0
        assert float(m.staleness_mean) == float(jm.staleness_mean)
        np.testing.assert_allclose(float(m.loss), float(jm.loss), rtol=1e-5)
        np.testing.assert_allclose(m.per_client_loss.numpy(), jm.per_client_loss, **TOL)
        np.testing.assert_allclose(float(m.update_norm), float(jm.update_norm), **TOL)
        assert_state_close(t, jstate, f"tick {i}")
    assert t.state.version == num_ticks


def test_generation_is_fedtpus_async_state_bytes_but_the_generator_leaf(fedtpu_run):
    """fedtpu's state after 3 ticks installed in the port: its generation
    encodes to fedtpu's bytes once ``client_rng`` is fedtpu's (the frame's
    zlib stage left out: it is the same function of the same bytes), and
    fedtpu's bytes decode into the port's template and install."""
    start, ticks = fedtpu_run
    jstate = ticks[-1][2]
    t = port(partition="iid", seed=1, buffer_k=2, speed_sigma=0.7)
    install(t, jstate)
    gen = t.generation
    assert gen._fields == jasync.AsyncState._fields
    assert gen.client_rng.dtype == np.uint8 and jstate.client_rng.shape == (4, 2)
    same = gen._replace(client_rng=jstate.client_rng)
    data = jwire.encode(jstate)
    assert twire.encode(same) == data
    other = port(partition="iid", seed=1, buffer_k=2, speed_sigma=0.7)
    other.load_state(twire.decode(data, same)._replace(client_rng=gen.client_rng))
    assert twire.encode(other.generation) == twire.encode(gen)


def test_staleness_accounting():
    """fedtpu's ``test_staleness_accounting``: client 0 arrives at ticks
    0 and 1, client 1 first at tick 2, with staleness 2."""
    t = port(2, buffer_k=1)
    schedule = [np.array([True, False]), np.array([True, False]), np.array([False, True])]
    t._arrive_mask = lambda: schedule.pop(0)
    stale = [float(t.tick().staleness_mean) for _ in range(3)]
    assert stale == [0.0, 0.0, 2.0]
    assert t.state.version == 3
    assert t.state.base_version.tolist() == [2, 3]


def test_staleness_damping_scales_the_applied_magnitude():
    def run(damping):
        t = port(2, buffer_k=1, staleness_power=1.0, staleness_damping=damping)
        schedule = [np.array([False, True]), np.array([True, False])]
        t._arrive_mask = lambda: schedule.pop(0)
        t.tick()
        m = t.tick()
        assert float(m.staleness_mean) == 1.0
        return float(m.update_norm)

    np.testing.assert_allclose(run(True), run(False) / 2.0, rtol=1e-5)


def test_fused_ticks_equal_sequential_ones_bit_for_bit():
    a = port(partition="iid", seed=1, buffer_k=2, speed_sigma=0.7)
    b = port(partition="iid", seed=1, buffer_k=2, speed_sigma=0.7)
    seq = [a.tick() for _ in range(4)]
    fused = b.run_on_device(4)
    assert a.state.version == b.state.version == 4
    assert twire.encode(a.generation) == twire.encode(b.generation)
    for f in tasync.AsyncMetrics._fields:
        assert torch.equal(torch.stack([getattr(m, f) for m in seq]), getattr(fused, f)), f


def test_full_buffer_matches_the_synchronous_engine():
    """buffer_k == N: every client arrives every tick from the same base,
    so the async trajectory is the synchronous one (fedtpu's anchor)."""
    cfg = tiny_cfg(tconfig)
    sync = TFederation(cfg, seed=0, device="cpu")
    t = tasync.AsyncFederation(cfg, seed=0, buffer_k=4, device="cpu")
    for _ in range(3):
        sync.step()
        t.tick()
    for k, v in sync.state.params.items():
        np.testing.assert_allclose(t.state.params[k].numpy(), v.numpy(), rtol=2e-5, atol=2e-6, err_msg=k)
    # Damping is the identity at staleness 0.
    off = tasync.AsyncFederation(cfg, seed=0, buffer_k=4, staleness_damping=False, device="cpu")
    for _ in range(3):
        off.tick()
    for k, v in off.state.params.items():
        np.testing.assert_allclose(t.state.params[k].numpy(), v.numpy(), rtol=1e-6, atol=1e-7, err_msg=k)


def test_fedprox_anchor_is_each_clients_pull_snapshot():
    """FedProx in the async step is anchored at each client's own pull
    snapshot: fedtpu's trajectory on a schedule where the clients' bases
    part, and the anchor's pull (a client that never arrives drifts less
    with the proximal term)."""
    schedule = [np.array([True, False, False]), np.array([False, True, False]), np.array([True, False, False])]
    cfg_kw = dict(algorithm="fedprox", fedprox_mu=0.5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = jasync.AsyncFederation(tiny_cfg(jconfig, 3, **cfg_kw), seed=0, buffer_k=1)
    t = port(3, buffer_k=1, fed_kw=cfg_kw)
    install(t, j.state)
    js, ts = list(schedule), list(schedule)
    j._arrive_mask = lambda: js.pop(0)
    t._arrive_mask = lambda: ts.pop(0)
    for i in range(3):
        j.tick()
        t.tick()
    assert_state_close(t, j.state, "fedprox")

    def drift(mu):
        kw = dict(algorithm="fedprox", fedprox_mu=mu) if mu else {}
        a = port(3, buffer_k=1, fed_kw=kw)
        sched = [np.array([True, False, False]), np.array([False, True, False])] * 4
        a._arrive_mask = lambda: sched.pop(0)
        for _ in range(8):
            a.tick()
        return sum(float(torch.linalg.vector_norm(a.state.client_params[k][2] - a.state.base_params[k][2]))
                   for k in a.state.client_params)

    assert drift(10.0) < drift(0.0)


def test_dead_client_never_arrives_and_rejoins():
    t = port(buffer_k=2)
    t.set_alive(3, False)
    for _ in range(5):
        t.tick()
    assert int(t.state.base_version[3]) == 0 and t.state.version == 5
    assert not bool(t.state.pending[3])  # a dead client does not train either
    t.set_alive(3, True)
    for _ in range(8):
        t.tick()
    assert int(t.state.base_version[3]) > 0


def test_one_epoch_per_pull_cycle():
    t = port(2, buffer_k=1)
    t._arrive_mask = lambda: np.array([True, False])  # client 1 never arrives
    t.tick()
    after_first = {k: v[1].clone() for k, v in t.state.client_params.items()}
    momentum = {k: v[1].clone() for k, v in t.state.opt_state.items()}
    for _ in range(4):
        t.tick()
    assert all(torch.equal(after_first[k], t.state.client_params[k][1]) for k in after_first)
    assert all(torch.equal(momentum[k], t.state.opt_state[k][1]) for k in momentum)
    assert bool(t.state.pending[1]) and not bool(t.state.pending[0])


def test_resume_is_bit_equal_to_an_uninterrupted_run():
    """Save after 3 ticks, restore into a fresh engine, 2 more ticks on the
    same arrival schedule: bit-equal to 5 uninterrupted ticks (the
    generator rides the generation; the arrival draws do not, as in
    fedtpu, so the schedule is pinned)."""
    sched = [np.array([i % 4 == j for j in range(4)]) for i in range(5)]

    def fresh():
        a = port(partition="iid", seed=7, buffer_k=1)
        a._arrive_mask = lambda s=list(sched): s.pop(0)
        return a

    ref = fresh()
    for _ in range(5):
        ref.tick()
    a = fresh()
    for _ in range(3):
        a.tick()
    b = port(partition="iid", seed=7, buffer_k=1)
    # The generation's bytes, as the checkpoint store writes them (its zlib
    # stage aside).
    b.load_state(twire.decode(twire.encode(a.generation), b.generation))
    rest = list(sched)[3:]
    b._arrive_mask = lambda: rest.pop(0)
    for _ in range(2):
        b.tick()
    assert b.state.version == 5
    assert twire.encode(ref.generation) == twire.encode(b.generation)


# ------------------------------------------------------------ BatchNorm
class _FlaxTinyBN(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool = False):
        x = fnn.Conv(4, (3, 3))(x)
        x = fnn.relu(jbn(train)(x))
        return fnn.Dense(10)(x.mean(axis=(1, 2)))


class _TorchTinyBN(nn.Module):
    def __init__(self):
        super().__init__()
        self.Conv_0 = nn.Conv2d(3, 4, 3, padding=1)
        self.BatchNorm_0 = BatchNorm(4)
        self.Dense_0 = nn.Linear(4, 10)
        name_batch_norms(self)

    def forward(self, x, train: bool = False):
        stats = {} if train else None
        x = F.relu(self.BatchNorm_0(self.Conv_0(x.permute(0, 3, 1, 2)), stats))
        logits = self.Dense_0(x.mean(dim=(2, 3)))
        return (logits, stats) if train else logits


def test_batchnorm_ticks_match_fedtpus_in_f64():
    """Both packages' tick on a conv + BatchNorm model in f64 (fedtpu under
    ``jax.enable_x64``), 3 clients, buffer 1 on a fixed schedule, 3 ticks:
    every stack, the statistics' among them, within the round tests'
    tolerance (both packages keep the f32 cast of the logits for the loss,
    so the f64 trajectories part at f32's rounding)."""
    n, steps, batch = 3, 2, 4
    rng = np.random.default_rng(11)
    images = rng.normal(size=(n * steps * batch, 4, 4, 3)).astype(np.float32).astype(np.float64)
    labels = rng.integers(0, 10, n * steps * batch).astype(np.int32)
    idx = np.arange(n * steps * batch, dtype=np.int32).reshape(n, steps * batch)
    mask = np.ones_like(idx, bool)
    schedule = [np.array([True, False, False]), np.array([False, False, True]), np.array([True, False, False])]
    with jax.enable_x64(True):
        jcfg = dataclasses.replace(tiny_cfg(jconfig, n), steps_per_round=steps,
                                   data=jconfig.DataConfig(dataset="synthetic", batch_size=batch, augment=False,
                                                           device_layout="gather"))
        model = _FlaxTinyBN()
        state = jasync.init_async_state(model, jcfg, jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 3)))
        state = jax.tree.map(lambda x: x.astype(jnp.float64) if x.dtype == jnp.float32 else x, state)
        host = jax.tree.map(np.asarray, state)
        jstep = jax.jit(jasync.make_async_step(model, jcfg, steps, shuffle=False, image_shape=(4, 4, 3),
                                               layout="gather"))
        weights = jnp.full((n,), float(steps * batch))
        for arrive in schedule:
            state, _ = jstep(state, jnp.asarray(images.reshape(len(images), -1)), jnp.asarray(labels),
                             jnp.asarray(idx), jnp.asarray(mask), weights, jnp.asarray(arrive),
                             jnp.ones((n,), bool), jax.random.PRNGKey(0))
        want = jax.tree.map(np.asarray, state)
    tcfg = dataclasses.replace(tiny_cfg(tconfig, n), steps_per_round=steps,
                               data=tconfig.DataConfig(dataset="synthetic", batch_size=batch, augment=False))
    tmodel = _TorchTinyBN().double()
    ts = tasync.AsyncState(
        **{f: from_flax(getattr(host, f)) for f in ("params", "batch_stats", "client_params", "client_stats",
                                                     "base_params", "base_stats")},
        opt_state=from_flax(host.opt_state.momentum), client_rng=(),
        base_version=torch.zeros(n, dtype=torch.int32), version=0, pending=torch.zeros(n, dtype=torch.bool),
        server_opt_state=(), last_client_loss=torch.full((n,), float("nan")),
    )
    tstep = tasync.make_async_step(tmodel, tcfg)
    x = torch.from_numpy(images).reshape(n, steps, batch, 4, 4, 3)
    y = torch.from_numpy(labels.astype(np.int64)).reshape(n, steps, batch)
    for arrive in schedule:
        ts, _ = tstep(ts, x, y, torch.ones(n, dtype=torch.bool), torch.full((n,), float(steps * batch)),
                      torch.from_numpy(arrive), torch.ones(n, dtype=torch.bool))
    assert set(ts.batch_stats) == {"BatchNorm_0.mean", "BatchNorm_0.var"}
    for field in ("params", "batch_stats", "client_params", "client_stats", "base_params", "base_stats",
                  "opt_state"):
        got = from_flax(getattr(want, field) if field != "opt_state" else want.opt_state.momentum)
        for k, v in getattr(ts, field).items():
            np.testing.assert_allclose(v.numpy(), got[k].numpy(), **TOL, err_msg=f"{field} {k}")
    np.testing.assert_array_equal(ts.base_version.numpy(), want.base_version)
    np.testing.assert_array_equal(ts.pending.numpy(), want.pending)


# --------------------------------------------------------------- guards
def test_unsound_compositions_raise_fedtpus_messages():
    for kw in (dict(compression="topk"), dict(aggregator="median"), dict(weighted=False, dp_clip_norm=1.0)):
        with pytest.raises(ValueError) as want:
            jasync.AsyncFederation(tiny_cfg(jconfig, **kw))
        with pytest.raises(ValueError) as got:
            tasync.AsyncFederation(tiny_cfg(tconfig, **kw), device="cpu")
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="buffer_k"):
        port(buffer_k=9)


def test_options_the_port_does_not_run_raise_naming_their_item():
    with pytest.raises(NotImplementedError, match="ROADMAP.*slice 8, part 6"):
        port(mesh=object())
    # The status board runs since slice 8 part 5a, shared with the delegate
    # engine and stamped with the async loop's role.
    eng = port()
    snap = eng.status_snapshot()
    assert (snap["role"], snap["phase"], snap["round"]) == ("async_engine", "init", 0)
    assert snap["alive"] == [True] * eng.cfg.fed.num_clients and eng.status is eng._fed.status
