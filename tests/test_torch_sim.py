"""The port's massive-cohort simulation (``fedtpu_torch.sim``) against
fedtpu's, on the CPU: the counterparts of ``tests/test_sim.py``.

Everything numpy is held bit for bit: every scenario's partition, the
samplers' cohort sequences, the availability and churn trace, the
population's admit, evict and readmit, the heterogeneity index and the
per-cohort eval slice; ``validate_sim_config`` refuses what fedtpu's
refuses, with its messages. The engine: with ``population == cohort``
under the uniform sampler it is the port's resident ``Federation`` bit
for bit; a seat handed to another client has its momentum and residual
reset and no other seat is touched; a sim round with fedtpu's gather keys
injected stays within the round tests' tolerance of fedtpu's
``SimFederation``; and a 2,000-client population runs through 64 seats
with cohort-sized device state.
"""

import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

from fedtpu import config as jconfig
from fedtpu.sim import population as jpopulation
from fedtpu.sim import samplers as jsamplers
from fedtpu.sim import scenario as jscenario
from fedtpu.sim.engine import SimFederation as JSimFederation
from fedtpu_torch import config as tconfig
from fedtpu_torch.convert import from_flax, to_flax
from fedtpu_torch.core.engine import Federation as TFederation
from fedtpu_torch.sim import (
    Population,
    SimFederation,
    cohort_eval_indices,
    make_partition,
    make_sampler,
    parse_scenario,
)
from fedtpu_torch.sim.scenario import apply_quantity_skew


def _labels(n=4000, classes=10, seed=0):
    return np.random.default_rng(seed).integers(0, classes, n).astype(np.int32)


def _cfg(mod, population, cohort, scenario="", sampler="uniform", num_examples=400,
         compression="none", augment=True, **sim_kw):
    return mod.RoundConfig(
        model="mlp", num_classes=10,
        opt=mod.OptimizerConfig(learning_rate=0.01, weight_decay=0.0),
        data=mod.DataConfig(dataset="synthetic", batch_size=4, partition="iid",
                            num_examples=num_examples, device_layout="gather", augment=augment),
        fed=mod.FedConfig(num_clients=cohort, compression=compression,
                          sim=mod.SimConfig(population=population, scenario=scenario,
                                            cohort_sampler=sampler, **sim_kw)),
        steps_per_round=2,
    )


def _same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


SPECS = [
    "iid",
    "round_robin",
    "dirichlet:alpha=0.3",
    "dirichlet:alpha=0.1,min_size=2",
    "pathological:shards=2",
    "label_skew:classes=3",
    "quantity_skew:power=1.5",
    "quantity_skew:power=0.8,min=3",
    "dirichlet:alpha=0.5+quantity_skew:power=1.2",
    "label_skew:classes=2+quantity_skew:power=1.5",
    "dirichlet:alpha=0.1+quantity_skew:power=1.5",
]


# ----------------------------------------------------------------- numpy
@pytest.mark.parametrize("spec", SPECS)
def test_scenario_partitions_are_fedtpus(spec):
    labels = _labels()
    for seed, clients in ((7, 20), (8, 37)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # dirichlet's top-up warning, in both
            want = jscenario.make_partition(spec, labels, clients, seed=seed, batch_size=16)
            got = make_partition(spec, labels, clients, seed=seed, batch_size=16)
        _same(got, want)
    assert parse_scenario(spec) == jscenario.parse_scenario(spec)


def test_scenario_pieces_are_fedtpus():
    labels = _labels(2000)
    idx, mask = jscenario.label_skew(labels, 30, classes_per_client=2, seed=3)
    _same(apply_quantity_skew(idx, mask, power=1.3, min_size=2, seed=4),
          jscenario.apply_quantity_skew(idx, mask, power=1.3, min_size=2, seed=4))
    hist = np.zeros(10)
    hist[[2, 7]] = [3, 1]
    eval_labels = _labels(3000, seed=9)
    for num, seed in ((200, 0), (37, 5)):
        np.testing.assert_array_equal(cohort_eval_indices(eval_labels, hist, num, seed=seed),
                                      jscenario.cohort_eval_indices(eval_labels, hist, num, seed=seed))


@pytest.mark.parametrize("bad,match", [
    ("zipf:oops=1", "unknown scenario base"),
    ("iid+label_skew:classes=2", "modifier"),
    ("dirichlet:alpha", "key=value"),
    ("iid+", "empty stage"),
])
def test_parse_scenario_rejects_what_fedtpu_rejects(bad, match):
    with pytest.raises(ValueError, match=match) as want:
        jscenario.parse_scenario(bad)
    with pytest.raises(ValueError, match=match) as got:
        parse_scenario(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["uniform", "loss"])
@pytest.mark.parametrize("avail,churn", [(1.0, 0.0), (0.5, 0.0), (0.6, 0.3)])
def test_cohort_sequences_and_traces_are_fedtpus(name, avail, churn):
    labels = _labels(800)
    idx, mask = make_partition("iid", labels, 100, seed=0)
    jpop = jpopulation.Population(idx, mask, seed=3, availability=avail, churn=churn)
    tpop = Population(idx, mask, seed=3, availability=avail, churn=churn)
    for pop in (jpop, tpop):
        pop.observe_loss(np.arange(50), np.linspace(0.1, 5.0, 50))
    js, ts = jsamplers.make_sampler(name, seed=3, prior=2.0), make_sampler(name, seed=3, prior=2.0)
    for r in range(6):
        _same(ts.sample(tpop, r, 16), js.sample(jpop, r, 16))
        np.testing.assert_array_equal(tpop.available_at(r), jpop.available_at(r))
        ids, alive = ts.sample(tpop, r, 16)
        tpop.mark_sampled(ids[alive], r)
        jpop.mark_sampled(ids[alive], r)
    np.testing.assert_array_equal(tpop.times_sampled, jpop.times_sampled)
    assert tpop.stats() == jpop.stats()
    if churn:
        with pytest.raises(ValueError, match="rewind"):
            tpop.available_at(2)


def test_scarce_availability_pads_dead_seats_as_fedtpu():
    idx, mask = make_partition("iid", _labels(400), 50, seed=0)
    tpop, jpop = Population(idx, mask, seed=0, availability=0.2), jpopulation.Population(idx, mask, seed=0, availability=0.2)
    ids, alive = make_sampler("uniform", seed=0).sample(tpop, 0, 32)
    _same((ids, alive), jsamplers.make_sampler("uniform", seed=0).sample(jpop, 0, 32))
    assert alive.sum() == tpop.available_at(0).sum() < 32 and (~alive[int(alive.sum()):]).all()


def test_population_membership_and_heterogeneity_are_fedtpus():
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 100, (6, 8)).astype(np.int32)
    mask = np.ones((6, 8), bool)
    pops = [Population(idx, mask, seed=0), jpopulation.Population(idx, mask, seed=0)]
    for pop in pops:
        pop.observe_loss(np.array([2]), np.array([1.5]))
        pop.evict(2)
        pop.readmit(2)
        pop.evict(4)
        assert pop.admit(np.arange(5, dtype=np.int32), np.ones(5, bool)) == 6
        with pytest.raises(ValueError):
            pop.admit(np.arange(9, dtype=np.int32), np.ones(9, bool))
        with pytest.raises(ValueError):
            pop.admit(np.arange(3, dtype=np.int32), np.ones(4, bool))
    t, j = pops
    for field in ("idx", "mask", "sizes", "last_seen_loss", "last_sampled_round", "times_sampled"):
        np.testing.assert_array_equal(getattr(t, field), getattr(j, field), err_msg=field)
    np.testing.assert_array_equal(t.available_at(0), j.available_at(0))
    np.testing.assert_array_equal(t.members(), j.members())
    for _ in range(5):
        _same(make_sampler("uniform").sample(t, _, 5), jsamplers.make_sampler("uniform").sample(j, _, 5))
    assert t.stats() == j.stats()
    labels = _labels(100)
    assert t.heterogeneity_index(labels) == j.heterogeneity_index(labels)
    idx2, mask2 = make_partition("pathological:shards=2", _labels(2000), 40, seed=1)
    assert (Population(idx2, mask2).heterogeneity_index(_labels(2000))
            == jpopulation.Population(idx2, mask2).heterogeneity_index(_labels(2000)))


@pytest.mark.parametrize("fed_kw", [
    dict(num_clients=8, sim=dict(population=4)),
    dict(num_clients=2, sim=dict(population=4, cohort_sampler="zipf")),
    dict(num_clients=2, participation_fraction=0.5, sim=dict(population=4)),
    dict(num_clients=2, sim=dict(population=4, availability=0.0)),
    dict(num_clients=2, sim=dict(population=4, churn=1.5)),
    dict(num_clients=2, sim=dict(malicious_fraction=1.0)),
    dict(num_clients=2, sim=dict(malicious_fraction=0.5, attack="zap")),
], ids=repr)
def test_validate_sim_config_refuses_what_fedtpu_refuses(fed_kw):
    def build(mod):
        kw = dict(fed_kw)
        return mod.FedConfig(**{**kw, "sim": mod.SimConfig(**kw["sim"])})

    with pytest.raises(ValueError) as want:
        jconfig.validate_sim_config(build(jconfig))
    with pytest.raises(ValueError) as got:
        tconfig.validate_sim_config(build(tconfig))
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------- engine
@pytest.mark.parametrize("runner", ["step", "fused"])
def test_population_equal_to_cohort_is_the_resident_engine_bit_for_bit(runner):
    base = _cfg(tconfig, 8, 8, compression="topk")
    plain_cfg = dataclasses.replace(base, fed=dataclasses.replace(base.fed, sim=tconfig.SimConfig()))
    plain = TFederation(plain_cfg, seed=0, device="cpu")
    sim = SimFederation(base, seed=0, device="cpu")
    if runner == "step":
        for _ in range(3):
            plain.step()
            sim.step()
    else:
        plain.run_on_device(3)
        sim.run_on_device(3)
    for field in ("params", "opt_state", "comp_state"):
        a, b = getattr(plain.state, field), getattr(sim.state, field)
        for k in a:
            assert torch.equal(a[k], b[k]), (field, k)
    assert torch.equal(plain.state.last_client_loss, sim.state.last_client_loss)
    # A cohort a round, or one for the fused block; every one the identity.
    assert sim.population.times_sampled.tolist() == [3 if runner == "step" else 1] * 8


def test_a_resident_engine_ignores_the_population():
    """fedtpu's ``Federation`` takes a population config and runs its
    cohort as resident clients (the CLI picks the sim engine); so does the
    port's."""
    fed = TFederation(_cfg(tconfig, 64, 4), seed=0, device="cpu")
    assert np.isfinite(float(fed.step().loss))


@pytest.mark.parametrize("layout", ["per_leaf", "flat"])
def test_seat_reset_touches_exactly_the_reassigned_seats(layout):
    cfg = _cfg(tconfig, 64, 4, num_examples=512, compression="topk")
    cfg = dataclasses.replace(cfg, fed=dataclasses.replace(cfg.fed, delta_layout=layout))
    fed = SimFederation(cfg, seed=0, device="cpu")
    fed.step()
    prev = fed._slot_ids.copy()
    before = {k: v.clone() for k, v in fed.state.opt_state.items()}
    res_before = fed.state.comp_state
    res_before = res_before.clone() if layout == "flat" else {k: v.clone() for k, v in res_before.items()}
    fed._install_cohort(fed.state.round_idx)
    fresh = torch.from_numpy(prev != fed._slot_ids)
    assert fresh.any()  # 4 of 64: a whole repeat is all but impossible at seed 0

    def check(now, then):
        assert torch.all(now[fresh] == 0)
        assert torch.equal(now[~fresh], then[~fresh])

    for k, v in fed.state.opt_state.items():
        check(v, before[k])
    if layout == "flat":
        check(fed.state.comp_state, res_before)
    else:
        for k, v in fed.state.comp_state.items():
            check(v, res_before[k])
    np.testing.assert_array_equal(fed.state.last_client_loss.numpy(),
                                  fed.population.last_seen_loss[fed._cohort_ids])
    m = fed.step()  # the installed cohort trains: no second draw
    assert np.isfinite(float(m.loss)) and fed.population.times_sampled.sum() == 8


def test_a_sim_round_holds_to_fedtpus_with_its_gather_keys():
    """Three rounds of a 16-client population through 4 seats, a new
    cohort each round (seats reset), per-leaf top-k with error feedback:
    fedtpu's ``SimFederation`` and the port's from the same weights, the
    port fed fedtpu's gather keys (augmentation off: fedtpu would draw it
    from each seat's threefry key)."""
    kw = dict(scenario="dirichlet:alpha=0.5", num_examples=256, compression="topk", augment=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jfed = JSimFederation(_cfg(jconfig, 16, 4, **kw), seed=0)
    tfed = SimFederation(_cfg(tconfig, 16, 4, **kw), seed=0, device="cpu")
    np.testing.assert_array_equal(tfed.population.idx, jfed.population.idx)
    tfed.state = tfed.state._replace(params=from_flax(jax.tree.map(np.asarray, jfed.state.params)))
    data_key = jax.random.PRNGKey(0)
    seat_mismatches = reassigned = 0
    for r in range(3):
        jfed.step()
        before = tfed._slot_ids.copy()
        tfed._install_cohort(r)
        reassigned += int((before != tfed._slot_ids).sum())
        seat_mismatches += int((tfed._slot_ids != np.where(jfed.alive, jfed._cohort_ids, -1)).sum())
        np.testing.assert_array_equal(tfed._cohort_ids, jfed._cohort_ids)
        keys = np.array(jax.random.uniform(jax.random.fold_in(data_key, r), tfed.client_idx.shape))
        TFederation.step(tfed, tfed.device_batch(r, keys=torch.from_numpy(keys)))
        tfed._observe_back()
        got, want = to_flax(tfed.state.params), jax.tree.map(np.asarray, jfed.state.params)
        for mod in want:
            for leaf in want[mod]:
                np.testing.assert_allclose(got[mod][leaf], want[mod][leaf], atol=1e-5, rtol=1e-4,
                                           err_msg=f"round {r} {mod}/{leaf}")
        np.testing.assert_allclose(tfed.population.last_seen_loss, jfed.population.last_seen_loss,
                                   rtol=1e-5)
    assert seat_mismatches == 0 and reassigned > 0
    np.testing.assert_array_equal(tfed.population.times_sampled, jfed.population.times_sampled)


def test_2k_population_64_seats_keep_cohort_sized_device_state():
    fed = SimFederation(_cfg(tconfig, 2000, 64, scenario="pathological:shards=2", num_examples=4000),
                        seed=0, device="cpu")
    m = fed.run_on_device(2)
    assert m.loss.shape == (2,) and torch.isfinite(m.loss).all()
    assert fed.population.times_sampled.sum() == 64
    assert fed.population.never_sampled() == 2000 - 64
    for leaf in fed.state.opt_state.values():
        assert leaf.shape[0] == 64
    fed.run_on_device(2)
    assert fed.population.times_sampled.sum() == 128
    assert 0 < np.isfinite(fed.population.last_seen_loss).sum() <= 128
    # The sim block of the status board, and fedtpu's sim gauges.
    snap = fed.status_snapshot()
    assert snap["sim"]["cohort_live"] == 64 and snap["round"] == 4 and snap["phase"] == "idle"
    gauges = fed.telemetry.registry.snapshot()
    assert gauges["fedtpu_sim_population"][0]["value"] == 2000
    assert gauges["fedtpu_sim_never_sampled"][0]["value"] == fed.population.never_sampled()


def test_an_admitted_client_is_drawn_into_later_cohorts():
    fed = SimFederation(_cfg(tconfig, 6, 4), seed=0, device="cpu")
    fed.step()
    new_idx = np.arange(16, dtype=np.int32)
    cid = fed.population.admit(new_idx, np.ones(len(new_idx), bool))
    assert cid == 6
    for _ in range(12):
        fed.step()
        if cid in set(fed._cohort_ids[fed.alive].tolist()):
            break
    else:
        pytest.fail("admitted client never sampled into a cohort")
    for leaf in fed.state.opt_state.values():
        assert leaf.shape[0] == 4


def test_population_attackers_take_their_seats():
    """Seeded attackers live at population scope: whichever seat one lands
    in is an attacker's seat for that round."""
    cfg = _cfg(tconfig, 32, 4, num_examples=256, malicious_fraction=0.25, attack="scale:factor=-8")
    fed = SimFederation(cfg, seed=0, device="cpu")
    jcfg = _cfg(jconfig, 32, 4, num_examples=256, malicious_fraction=0.25, attack="scale:factor=-8")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jfed = JSimFederation(jcfg, seed=0)
    np.testing.assert_array_equal(fed._pop_attackers, jfed._pop_attackers)
    for r in range(3):
        fed.step()
        jfed.step()
        np.testing.assert_array_equal(fed._attack_seats, jfed._attack_seats)
        np.testing.assert_array_equal(fed._attack_seats_dev.numpy(), fed._attack_seats)


def test_cohort_label_hist_and_eval_slice_are_fedtpus():
    kw = dict(scenario="label_skew:classes=2", num_examples=256, augment=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jfed = JSimFederation(_cfg(jconfig, 16, 4, **kw), seed=0)
    tfed = SimFederation(_cfg(tconfig, 16, 4, **kw), seed=0, device="cpu")
    np.testing.assert_array_equal(tfed.cohort_label_hist(), jfed.cohort_label_hist())
    eval_labels = _labels(600, seed=3)
    sel = cohort_eval_indices(eval_labels, tfed.cohort_label_hist(), 40, seed=tfed.cfg.data.seed + 2)
    np.testing.assert_array_equal(
        sel, jscenario.cohort_eval_indices(eval_labels, jfed.cohort_label_hist(), 40, seed=2))
    images = np.random.default_rng(3).normal(size=(600, 32, 32, 3)).astype(np.float32)
    loss, acc = tfed.evaluate_cohort(images, eval_labels, num=100, seed=2)
    assert np.isfinite(loss) and 0.0 <= acc <= 1.0
