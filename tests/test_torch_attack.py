"""The port's seeded attackers against fedtpu's (``fedtpu.sim.adversary``).

The attack plans, the attacker ids and the label flip are numpy and must be
bit-equal. fedtpu draws its fire uniforms and its noise from JAX's PRNG;
the port takes them injected (:class:`fedtpu_torch.core.round.RoundDraws`),
and then the fire masks are equal and the rounds track fedtpu's within the
plain round's ``atol=1e-5, rtol=1e-4``.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedtpu import config as jconfig
from fedtpu.core.engine import Federation as JFederation
from fedtpu.sim import adversary as jadv
from fedtpu_torch import config as tconfig
from fedtpu_torch.convert import from_flax, to_flax
from fedtpu_torch.core import round as tround
from fedtpu_torch.core.engine import Federation as TFederation
from fedtpu_torch.sim import adversary as tadv

SPECS = [
    "sign_flip",
    "scale:factor=20,p=0.5",
    "scale:factor=-8",
    "noise:std=2.0,collude=1",
    "noise:std=0.5,seed=7,rounds=3-9",
    "label_flip:offset=3,rounds=10",
    "sign_flip:p=0.25,collude=true",
]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_table_equal(spec):
    got, want = tadv.parse_attack(spec), jadv.parse_attack(spec)
    for field in ("kind", "p", "factor", "std", "label_offset", "collude", "rounds", "seed"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.coef == want.coef


@pytest.mark.parametrize("spec,match", [
    ("", "empty"), ("bogus", "unknown attack kind"), ("scale:factor=0", "nonzero"),
    ("sign_flip:p=0", r"\(0, 1\]"), ("noise:std", "key=value"), ("noise:sigma=1", "unknown attack option"),
])
def test_bad_specs_raise_like_fedtpu(spec, match):
    with pytest.raises(ValueError, match=match):
        tadv.parse_attack(spec)
    with pytest.raises(ValueError, match=match):
        jadv.parse_attack(spec)


@pytest.mark.parametrize("population,fraction,seed", [(64, 0.125, 0), (10, 0.3, 5), (7, 0.1, 1), (100, 0.5, 42)])
def test_attacker_mask_bit_equal(population, fraction, seed):
    np.testing.assert_array_equal(
        tadv.attacker_mask(population, fraction, seed), jadv.attacker_mask(population, fraction, seed)
    )


def test_flip_labels_bit_equal():
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 10, size=40).astype(np.int32)
    idx = rng.permutation(40).astype(np.int32).reshape(4, 10)
    mask = np.ones((4, 10), bool)
    mask[2, 7:] = False
    attackers = np.array([False, True, True, False])
    np.testing.assert_array_equal(
        tadv.flip_labels(labels, idx, mask, attackers, 3, 10),
        jadv.flip_labels(labels, idx, mask, attackers, 3, 10),
    )


@pytest.mark.parametrize("spec", ["sign_flip:p=0.5", "sign_flip:p=0.5,collude=1", "scale:factor=3,rounds=2-4"])
def test_fire_mask_equal_with_fedtpus_uniforms(spec):
    plan_t, plan_j = tadv.parse_attack(spec), jadv.parse_attack(spec)
    seats = np.array([1, 0, 1, 1, 0, 1], np.float32)
    for r in range(6):
        want = np.asarray(jadv.attack_fire_mask(plan_j, jnp.asarray(seats), jnp.int32(r), 6))
        key = jax.random.fold_in(jax.random.PRNGKey(plan_j.seed ^ 0xAD5A17), jnp.int32(r))
        unif = np.array(jax.random.uniform(key, () if plan_j.collude else (6,)))
        got = tadv.attack_fire_mask(plan_t, torch.from_numpy(seats), r, torch.from_numpy(unif))
        np.testing.assert_array_equal(got.numpy(), want)
        # The host mirror reads the port's own draws, the same ones the
        # round takes.
        np.testing.assert_array_equal(
            tadv.fires_this_round(plan_t, seats, r),
            tadv.attack_fire_mask(plan_t, torch.from_numpy(seats), r).numpy(),
        )


def _configs(attack, fraction=0.25, **fed_kw):
    def build(mod):
        return mod.RoundConfig(
            model="smallcnn", steps_per_round=2,
            data=mod.DataConfig(dataset="cifar10", batch_size=8, partition="iid", augment=False),
            fed=mod.FedConfig(num_clients=4, sim=mod.SimConfig(malicious_fraction=fraction, attack=attack), **fed_kw),
        )

    return build(jconfig), build(tconfig)


def _data(seed, n=64):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, size=n).astype(np.int32))


def _fedtpu_attack_draws(plan, n):
    """fedtpu's noise and fire draws for a round, handed to the port."""
    def noise(round_idx, items):
        key = jax.random.fold_in(jax.random.PRNGKey(plan.seed ^ 0x4015E5), jnp.int32(round_idx))
        (name, x), = items.items()  # the flat layout: one leaf
        (k,) = jax.random.split(key, 1)
        shape = tuple(x.shape[1:]) if plan.collude else tuple(x.shape)
        return {name: torch.from_numpy(np.array(jax.random.normal(k, shape, jnp.float32)))}

    def uniforms(round_idx, _n):
        key = jax.random.fold_in(jax.random.PRNGKey(plan.seed ^ 0xAD5A17), jnp.int32(round_idx))
        return torch.from_numpy(np.array(jax.random.uniform(key, () if plan.collude else (n,))))

    return tround.RoundDraws(attack_noise=noise, attack_uniforms=uniforms)


@pytest.mark.parametrize("attack,layout,rounds", [
    ("sign_flip", "per_leaf", 2),
    ("scale:factor=-4", "flat", 2),
    ("noise:std=0.01,p=0.5", "flat", 2),
    ("noise:std=0.01,collude=1", "flat", 1),
])
def test_attacked_rounds_track_fedtpu(attack, layout, rounds):
    jcfg, tcfg = _configs(attack, delta_layout=layout)
    data = _data(1)
    jfed = JFederation(jcfg, seed=0, data=data)
    draws = _fedtpu_attack_draws(jfed._attack_plan, 4) if attack.startswith("noise") else None
    tfed = TFederation(tcfg, seed=0, data=data, device="cpu", draws=draws)
    np.testing.assert_array_equal(tfed.attacker_clients, jfed.attacker_clients)
    assert tfed.attacker_clients.sum() == 1
    tfed.state = tfed.state._replace(params=from_flax(jax.tree.map(np.asarray, jfed.state.params)))
    for r in range(rounds):
        jm, tm = jfed.step(jfed.round_batch(r)), tfed.step(tfed.round_batch(r))
        np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=1e-5)
        np.testing.assert_allclose(float(tm.update_norm), float(jm.update_norm), rtol=1e-4)
        got, want = to_flax(tfed.state.params), jax.tree.map(np.asarray, jfed.state.params)
        for mod in want:
            for leaf in want[mod]:
                np.testing.assert_allclose(got[mod][leaf], want[mod][leaf], atol=1e-5, rtol=1e-4,
                                           err_msg=f"round {r} {mod}/{leaf}")


def test_sign_flip_moves_the_round():
    """The attacker's negated delta changes the mean against a benign run."""
    _, benign = _configs("sign_flip", fraction=0.0)
    _, attacked = _configs("sign_flip")
    data = _data(2)
    out = []
    for cfg in (benign, attacked):
        fed = TFederation(cfg, seed=0, data=data, device="cpu")
        fed.step(fed.round_batch(0))
        out.append(fed.state.params["Dense_1.bias"])
    assert not torch.equal(out[0], out[1])


def test_label_flip_poisons_the_data_like_fedtpu():
    jcfg, tcfg = _configs("label_flip:offset=3")
    data = _data(3)
    jfed = JFederation(jcfg, seed=0, data=data)
    tfed = TFederation(tcfg, seed=0, data=data, device="cpu")
    np.testing.assert_array_equal(tfed.labels, jfed.labels)
    assert not np.array_equal(tfed.labels, data[1])
    assert tfed._attack_seats is None
    tfed.run(1)
    assert tfed.history[-1]["attackers_fired"] == 1


def test_run_records_attackers_fired_and_screened():
    _, tcfg = _configs("sign_flip:p=0.5", weighted=False, screen=tconfig.ScreenConfig(norm_max=1e9))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tfed = TFederation(tcfg, seed=0, data=_data(4), device="cpu")
    tfed.run(4)
    plan = tfed._attack_plan
    for r, rec in enumerate(tfed.history):
        assert rec["attackers_fired"] == int(tadv.fires_this_round(plan, tfed._attack_seats, r).sum())
        assert rec["screened"] == 0
