"""The port's ``PrimaryServer`` against fedtpu's, over real gRPC on
localhost, on the CPU.

Both coordinators drive the same fleet of scripted clients
(``torch_coordinator.ScriptedClient``: seeded numpy deltas on the wire
through fedtpu's own encoders) from the same start, fedtpu's
``model_bytes()``, for 3 rounds each. After every round the global models
are bit-equal, ``model_bytes()`` and ``replica_bytes()`` are byte-equal,
and the round records agree on their participants, alive mask,
stragglers, abort flag and wire bytes (per codec too). The cases: every
codec per leaf and flat, both server pipelines, the robust aggregators
(Krum's choice shows in the bits), the server optimizers, participation
sampling (the same clients asked, with their seats as ranks) and screening
that rejects, then quarantines, a scripted attacker. DP runs clip-only
and is held within 1e-6.

adam and yogi divide by ``sqrt(nu)``: their rounds are bit-equal with
XLA's square root swapped into the port's server optimizer, as
``test_torch_server_opt.py`` does (XLA's f32 ``sqrt`` on the CPU is not
torch's correctly rounded one).

Then real clients: the port's primary drives one fedtpu client and one
port client, against fedtpu's primary driving the same pair, held within
``test_torch_edge.py``'s tolerance.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedtpu.transport import federation as jfederation
from fedtpu_torch.core import server_opt as tserver_opt
from fedtpu_torch.data import datasets as tdatasets
from fedtpu_torch.transport import federation as tfederation
from test_federation import free_port
from test_torch_edge import _hold
from torch_coordinator import (
    RECORD_FIELDS,
    Fleet,
    assert_bit_equal,
    configs,
    fedtpu_primary,
    host_tree,
    model_like,
)


def _xla_sqrt(t: torch.Tensor) -> torch.Tensor:
    return torch.tensor(np.asarray(jnp.sqrt(jnp.asarray(t.numpy()))))


def _run(primary, rounds=3):
    """Each round's record, global tree, model payload and replica."""
    out = []
    for _ in range(rounds):
        rec = primary.round()
        out.append((rec, host_tree(primary), primary.model_bytes(), primary.replica_bytes()))
    return out


def _side_by_side(fed_kw, screen=None, scales=None, bits=4):
    """fedtpu's federation, then the port's, on one fleet (so the replica's
    roster names the same addresses); returns both runs and the fleet's
    StartTrain logs of each."""
    jcfg, tcfg = configs(screen=screen, **fed_kw)
    like = model_like(jcfg)
    fleet = Fleet(like, codec=fed_kw.get("compression", "none"),
                  layout=fed_kw.get("delta_layout", "per_leaf"), scales=scales, bits=bits)
    try:
        jp = fedtpu_primary(jcfg, fleet.addrs)
        start = jp.model_bytes()
        want = _run(jp)
        want_calls = [list(a.calls) for a in fleet.agents]
        for a in fleet.agents:
            a.calls.clear()
        tp = tfederation.PrimaryServer(tcfg, fleet.addrs, initial_model=start, device="cpu")
        got = _run(tp)
        got_calls = [list(a.calls) for a in fleet.agents]
    finally:
        fleet.stop()
    return want, got, want_calls, got_calls, tp


def _assert_same(want, got):
    for r, ((jrec, jtree, jmodel, jrep), (trec, ttree, tmodel, trep)) in enumerate(zip(want, got)):
        assert_bit_equal(ttree, jtree, f"round {r} global")
        assert tmodel == jmodel, f"round {r} model_bytes"
        assert trep == jrep, f"round {r} replica_bytes"
        for k in RECORD_FIELDS:
            assert trec.get(k) == jrec.get(k), (r, k, trec.get(k), jrec.get(k))


CASES = {
    "per_leaf-none": dict(compression="none"),
    "per_leaf-topk": dict(compression="topk"),
    "per_leaf-int8": dict(compression="int8"),
    **{
        f"flat-{codec}-{pipe}": dict(compression=codec, delta_layout="flat", server_pipeline=pipe)
        for codec in ("none", "topk", "int8", "rotq", "randk")
        for pipe in ("barrier", "stream")
    },
    "median": dict(aggregator="median"),
    "trimmed_mean": dict(aggregator="trimmed_mean", trim_fraction=0.25),
    "momentum-stream": dict(server_optimizer="momentum", server_lr=0.3, delta_layout="flat"),
    "sampling": dict(participation_fraction=0.5),
    "unweighted-quorum": dict(weighted=False, round_quorum=0.75),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_primary_is_fedtpus_bit_for_bit(case):
    want, got, want_calls, got_calls, _ = _side_by_side(CASES[case])
    _assert_same(want, got)
    assert got_calls == want_calls  # the same clients asked, same ranks and rounds
    assert got[0][0]["pipeline"] == want[0][0]["pipeline"]
    if case == "sampling":
        assert all(rec["participants"] == 2 for rec, *_ in got)


def test_krum_picks_fedtpus_client():
    """Krum with a far-off client: the chosen row is the same (the global
    models' bits show it) and it is not the outlier's."""
    want, got, *_ = _side_by_side(dict(aggregator="krum", trim_fraction=0.25), scales={2: 40.0})
    _assert_same(want, got)


@pytest.mark.parametrize("name,layout", [("adam", "per_leaf"), ("yogi", "per_leaf"), ("yogi", "flat")])
def test_adaptive_server_optimizers_bit_for_bit(name, layout, monkeypatch):
    monkeypatch.setattr(tserver_opt, "_sqrt", _xla_sqrt)
    want, got, *_ = _side_by_side(dict(server_optimizer=name, server_lr=0.3, delta_layout=layout))
    _assert_same(want, got)


@pytest.mark.parametrize("pipeline", ["barrier", "stream"])
def test_screening_rejects_then_quarantines_the_attacker(pipeline):
    """A client whose deltas are 60x the others': rejected by the z-score
    in rounds 0 and 1 (suspicion 0.5, then 0.75 and quarantine), its
    update ignored in round 2; the same verdicts and the same suspicion in
    the replicated roster."""
    screen = dict(zmax=3.0)
    want, got, _, _, tp = _side_by_side(
        dict(delta_layout="flat", server_pipeline=pipeline), screen=screen, scales={1: 60.0})
    _assert_same(want, got)
    attacker = tp.registry.clients[1]
    assert [rec["screened"] for rec, *_ in got] == [[attacker], [attacker], [attacker]]
    assert [rec["quarantined"] for rec, *_ in got] == [[], [attacker], [attacker]]
    assert [rec["aggregated"] for rec, *_ in got] == [3, 3, 3]
    assert tp.registry.suspicion(attacker) == 0.875
    for (jrec, *_), (trec, *_) in zip(want, got):
        assert (trec["screened"], trec["quarantined"]) == (jrec["screened"], jrec["quarantined"])


def test_dp_clipping_tracks_fedtpu():
    """DP clip-only (no noise: the port cannot draw fedtpu's jax noise,
    which ``test_torch_edge.py`` injects at the level of the combine): the
    clip norms sum over a leaf's inner axes in XLA's vectorized order, so
    the globals are held within 1e-6, the records exactly."""
    want, got, want_calls, got_calls, _ = _side_by_side(
        dict(weighted=False, dp_clip_norm=0.5, dp_noise_multiplier=0.0))
    assert got_calls == want_calls
    for r, ((jrec, jtree, *_), (trec, ttree, *_)) in enumerate(zip(want, got)):
        for a, b in zip(jax.tree_util.tree_leaves(ttree), jax.tree_util.tree_leaves(jtree)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=f"round {r}")
        for k in RECORD_FIELDS:
            assert trec.get(k) == jrec.get(k), (r, k)


def test_stream_and_barrier_agree_in_the_port():
    """The port's two pipelines over the same flat replies: bit-equal."""
    runs = []
    for pipe in ("barrier", "stream"):
        _, got, *_ = _side_by_side(dict(compression="topk", delta_layout="flat", server_pipeline=pipe))
        runs.append(got)
    for (_, a, *_), (_, b, *_) in zip(*runs):
        assert_bit_equal(a, b, "barrier vs stream")


# ------------------------------------------------------------ real clients


@pytest.fixture(scope="module")
def fedtpu_load():
    """fedtpu's client ``load``, memoised: its client loads the split
    whole, once for the reference's pair and once for the port primary's."""
    load = functools.lru_cache(maxsize=None)(jfederation.load)
    yield load
    load.cache_clear()


@pytest.fixture(scope="module")
def port_data():
    return (tdatasets.load("cifar10", "train", seed=0, num=64),
            tdatasets.load("cifar10", "test", seed=0, num=64))


def _mixed(primary_of, jcfg, tcfg, port_data, rounds=3):
    """A fedtpu client and a port client on localhost, driven by the
    primary ``primary_of(addrs)`` builds; the global tree after each round."""
    servers, addrs = [], []
    try:
        for i in range(2):
            addr = f"localhost:{free_port()}"
            if i == 1:
                server, _ = tfederation.serve_client(
                    addr, tcfg, seed=i, device="cpu", data=port_data[0], eval_data=port_data[1])
            else:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    server, _ = jfederation.serve_client(addr, jcfg, seed=i)
            servers.append(server)
            addrs.append(addr)
        primary = primary_of(addrs)
        out = []
        for _ in range(rounds):
            rec = primary.round()
            assert rec["participants"] == 2 and rec["alive"] == [True, True], rec
            out.append(host_tree(primary))
        return out
    finally:
        for server in servers:
            server.stop(0)


@pytest.fixture(scope="module")
def mixed_reference(port_data, fedtpu_load):
    """fedtpu's primary over the mixed pair, and its start."""
    jcfg, tcfg = configs(num_clients=2)
    start = {}

    def build(addrs):
        p = fedtpu_primary(jcfg, addrs)
        start["model"] = p.model_bytes()
        return p

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfederation, "load", fedtpu_load)
        trees = _mixed(build, jcfg, tcfg, port_data)
    return trees, start["model"]


def test_port_primary_drives_fedtpu_and_port_clients(port_data, mixed_reference, fedtpu_load):
    """The port's primary over a fedtpu client and a port client tracks
    fedtpu's primary over the same pair, within the edge tests' tolerance
    on every coordinate, rounds 0 and 1; every round finite."""
    want, start = mixed_reference
    jcfg, tcfg = configs(num_clients=2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfederation, "load", fedtpu_load)
        got = _mixed(lambda addrs: tfederation.PrimaryServer(tcfg, addrs, initial_model=start, device="cpu"),
                     jcfg, tcfg, port_data)
    for r in (0, 1):
        _hold(got[r], want[r], False, f"round {r}")
    for tree in got:
        assert all(np.isfinite(a).all() for a in jax.tree_util.tree_leaves(tree))
