"""The port's adaptive codec policy
(``fedtpu_torch/transport/codec_policy.py``) and the coordinator's
adaptive path against fedtpu's, on the CPU.

- The policy: the same observations give the same choices and the same
  cost table as fedtpu's ``AdaptiveCodecPolicy``, float for float, over
  recorded sequences with warmup, ties and codecs it does not know.
- Validation: ``codec_policy='adaptive'`` is refused with fedtpu's
  messages where fedtpu refuses it.
- The federation: both coordinators get the same scripted policy object
  (the RTT is wall time, so a real policy's later choices are not
  reproducible) over one fleet that answers in the codec it is asked for:
  the same codec requests, the same observations and bit-equal globals.
  With the real policy, five rounds warm every client through the
  candidates in order and the sixth takes the cheapest.
"""

import warnings

import numpy as np
import pytest

from fedtpu.transport import codec_policy as jpolicy
from fedtpu_torch.transport import codec_policy as tpolicy
from fedtpu_torch.transport import federation as tfederation
from torch_coordinator import Fleet, assert_bit_equal, configs, fedtpu_primary, host_tree, model_like


@pytest.mark.parametrize("seed", range(4))
def test_policy_matches_fedtpu_on_recorded_sequences(seed):
    rng = np.random.default_rng(seed)
    cands = jpolicy.DEFAULT_CANDIDATES if seed % 2 == 0 else ("int8", "topk", "randk")
    j, t = jpolicy.AdaptiveCodecPolicy(cands), tpolicy.AdaptiveCodecPolicy(cands)
    for _ in range(600):
        rank = int(rng.integers(6))
        if rng.random() < 0.4:
            assert t.choose(rank) == j.choose(rank)
            continue
        codec = ["none", "int8", "topk", "rotq", "randk", "gzip"][rng.integers(6)]
        # Ties on purpose: a few byte counts and RTTs, zeros among them.
        nbytes = int(rng.choice([0, 1, 100, 4096, 10**6]))
        rtt = float(rng.choice([0.0, 1e-5, 0.01, 0.25, rng.random()]))
        j.observe(rank, codec, nbytes, rtt)
        t.observe(rank, codec, nbytes, rtt)
    assert t.snapshot() == j.snapshot()
    assert [t.choose(r) for r in range(8)] == [j.choose(r) for r in range(8)]
    with pytest.raises(ValueError, match="candidate"):
        tpolicy.AdaptiveCodecPolicy(())


def test_validation_messages_match_fedtpu():
    for fed_kw in (dict(codec_policy="adaptive"),
                   dict(codec_policy="adaptive", delta_layout="flat", aggregator="median"),
                   dict(codec_policy="adaptive", delta_layout="flat", dp_clip_norm=1.0, weighted=False),
                   dict(codec_policy="nope")):
        jcfg, tcfg = configs(**fed_kw)
        with pytest.raises(ValueError) as want:
            fedtpu_primary(jcfg, [])
        with pytest.raises(ValueError) as got:
            tfederation.PrimaryServer(tcfg, [], device="cpu")
        assert str(got.value) == str(want.value), fed_kw
    _, tcfg = configs(codec_policy="adaptive", delta_layout="flat")
    assert isinstance(tfederation.PrimaryServer(tcfg, [], device="cpu")._codec_policy,
                      tpolicy.AdaptiveCodecPolicy)


class ScriptedPolicy:
    """A policy whose choices are a table keyed by (rank, its n-th choice)
    and which records what it is taught, less the wall-time RTT."""

    TABLE = ("rotq", "int8", "none", "randk", "topk")

    def __init__(self):
        self.asked = {}
        self.observed = []

    def choose(self, rank):
        n = self.asked.get(rank, 0)
        self.asked[rank] = n + 1
        return self.TABLE[(rank + n) % len(self.TABLE)]

    def observe(self, rank, codec, nbytes, rtt_s):
        self.observed.append((rank, codec, nbytes))

    def snapshot(self):
        return {}


def test_scripted_policy_federation_matches_fedtpu():
    jcfg, tcfg = configs(codec_policy="adaptive", delta_layout="flat", compression="int8")
    fleet = Fleet(model_like(jcfg), codec="int8", layout="flat", obey_codec=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jp = fedtpu_primary(jcfg, fleet.addrs)
        jp._codec_policy = jpol = ScriptedPolicy()
        start = jp.model_bytes()
        want = []
        for _ in range(3):
            rec = jp.round()
            want.append((rec["bytes_up_by_codec"], host_tree(jp)))
        want_codecs = [list(a.codecs) for a in fleet.agents]
        tp = tfederation.PrimaryServer(tcfg, fleet.addrs, initial_model=start, device="cpu")
        tp._codec_policy = tpol = ScriptedPolicy()
        for i, (by_codec, tree) in enumerate(want):
            rec = tp.round()
            assert rec["bytes_up_by_codec"] == by_codec
            assert_bit_equal(host_tree(tp), tree, f"round {i}")
        assert sorted(tpol.observed) == sorted(jpol.observed) and len(tpol.observed) == 12
        assert {c for _, c, _ in tpol.observed} == set(ScriptedPolicy.TABLE)
        assert [a.codecs[3:] for a in fleet.agents] == want_codecs
    finally:
        fleet.stop()


def test_adaptive_rounds_warm_every_codec_then_take_the_cheapest():
    _, tcfg = configs(codec_policy="adaptive", delta_layout="flat", compression="int8")
    jcfg, _ = configs()
    fleet = Fleet(model_like(jcfg), codec="int8", layout="flat", obey_codec=True)
    try:
        p = tfederation.PrimaryServer(tcfg, fleet.addrs, device="cpu")
        recs = [p.round() for _ in range(5)]
        costs = p._codec_policy.snapshot()["0"]
        recs.append(p.round())
        codes = fleet.agents[0].codecs
        assert codes[:5] == list(tpolicy.DEFAULT_CANDIDATES)
        for rec, codec in zip(recs[:5], tpolicy.DEFAULT_CANDIDATES):
            assert list(rec["bytes_up_by_codec"]) == [codec]
        cheapest = min(tpolicy.DEFAULT_CANDIDATES,
                       key=lambda c: (costs[c]["ewma_cost"], tpolicy.DEFAULT_CANDIDATES.index(c)))
        assert codes[5] == cheapest
        snap = p.status_snapshot()
        assert set(snap["codec_bytes_up"]) == set(tpolicy.DEFAULT_CANDIDATES)
        assert snap["codec_policy"] == p._codec_policy.snapshot()
    finally:
        fleet.stop()
