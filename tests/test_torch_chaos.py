"""The port's fault injection (``fedtpu_torch/ft/chaos.py``) against
fedtpu's (``fedtpu/ft/chaos.py``), on the CPU.

- Parsing: DSL and JSON specs give the same rules, field for field, the
  same seed and the same ``describe()``; bad specs raise the same
  ``ValueError`` text.
- Decisions: the same spec makes the same decision on every call, over
  thousands of calls on several (rpc, peer) streams with rounds moving,
  ``max`` and ``consec`` caps, ``peer=a|b`` groups, a ``window=`` on a
  patched clock, and kind classes that never cross.
- Attacks: ``apply_attack_delta`` is bit-equal for sign_flip, scale, noise
  and colluding noise; the port's trainer sends the attacked payload while
  its own state stays honest, and label_flip shifts its labels.
- Rounds over gRPC: both coordinators drive one scripted fleet under one
  schedule (StartTrain errors and corruptions, SendModel delays, a
  client's server interceptor) and give bit-equal globals, the same
  injections and retries; a corrupted reply from a real port client is
  retried and the retry sends the same payload (the client rolls back);
  a rule outlasting the retries aborts a quorum round with the global
  model bit-identical.
"""

import dataclasses
import json
import os

import grpc
import numpy as np
import pytest
import torch

from fedtpu.ft import chaos as jchaos
from fedtpu_torch.data import datasets as tdatasets
from fedtpu_torch.ft import chaos as tchaos
from fedtpu_torch.obs import FlightRecorder, MetricsRegistry
from fedtpu_torch.transport import federation as tfederation
from fedtpu_torch.transport import wire as twire
from test_federation import free_port
from torch_coordinator import Fleet, assert_bit_equal, configs, fedtpu_primary, host_tree, model_like

SPECS = [
    "error@StartTrain:p=0.3,seed=7;"
    "delay@SendModel:p=0.5,delay=0.25,peer=localhost:1,rounds=3-5;"
    "kill@StartTrain:rounds=8,max=1;corrupt@StartTrain:p=0.1,code=UNAVAILABLE",
    "partition@StartTrain:peer=a|b,window=0-30;flaky@CheckIfPrimaryUp:p=0.5,delay=0.05,code=UNAVAILABLE,seed=3",
    "ckpt_rot:p=1.0,rounds=4,max=1;ckpt_torn@Disk:p=1.0,rounds=5;ckpt_fail:p=0.5",
    "sign_flip:p=1;scale:factor=4.5,p=0.5;noise:std=0.25,collude=1;label_flip:offset=3,rounds=2",
    "error@*:p=0.9,consec=2,max=40;drop@HeartBeat:delay=0,p=0.4;error@SubmitPartial:code=INTERNAL",
    '{"seed": 3, "rules": [{"kind": "error", "rpc": "StartTrain", "p": 0.5, "max_injections": 2}]}',
    '{"rules": [{"kind": "noise", "noise_std": 2, "collude": 1, "rounds": [1, 4]},'
    ' {"kind": "partition", "rpc": "FetchModel", "window": [1, 2.5]}]}',
]

BAD = [
    "explode@StartTrain", "error@NoSuchRpc", "error@StartTrain:p=1.5", "error@StartTrain:frequency=2",
    "error@StartTrain:p", '{"rules": []}', "{not json", "ckpt_rot@StartTrain:p=1", "error@Disk:p=1",
    "kill@Attack:p=1", "partition@Round:p=1", "partition@Attack:p=1", "partition@Disk:p=1",
    "flaky@Round:p=1", "partition@StartTrain:window=5-2", "partition@StartTrain:window=30",
    "error@StartTrain:consec=0", "error@StartTrain:max=0", "scale:factor=0", "noise:std=-1",
    "label_flip:offset=0", "delay@SendModel:delay=-1", "sign_flip@StartTrain:p=1", "  ;  ",
]


def _rules(sched):
    return [dataclasses.asdict(r) for r in sched.rules]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_matches_fedtpu(spec):
    j, t = jchaos.parse_spec(spec), tchaos.parse_spec(spec)
    assert _rules(t) == _rules(j)
    assert t.seed == j.seed
    assert t.describe() == j.describe()
    assert tchaos.parse_spec(None) is None and tchaos.parse_spec("  ") is None


@pytest.mark.parametrize("bad", BAD)
def test_parse_errors_match_fedtpu(bad):
    with pytest.raises(ValueError) as want:
        jchaos.parse_spec(bad)
    with pytest.raises(ValueError) as got:
        tchaos.parse_spec(bad)
    assert str(got.value) == str(want.value)


def _decisions(mod, spec, calls):
    sched = mod.parse_spec(spec)
    out = []
    for rnd, rpc, peer in calls:
        if rnd is not None:
            sched.set_round(rnd)
        rule = sched.decide(rpc, peer)
        out.append(None if rule is None else sched.rules.index(rule))
    return out, sched.injected_total()


DECIDE_SPECS = [
    "error@StartTrain:p=0.3,consec=1,seed=7;corrupt@StartTrain:p=0.25,consec=1;"
    "delay@SendModel:p=0.2,delay=0.2",
    "error@StartTrain:p=0.9,consec=2,seed=4;corrupt@StartTrain:p=0.9,consec=1",
    "error@StartTrain:p=1.0,rounds=2-4,max=3;delay@SendModel:peer=a,p=1.0;error@*:p=0.05,seed=11",
    "partition@StartTrain:peer=a|b,p=0.7;flaky@*:peer=c|d,p=0.3,consec=3,max=50,seed=2",
    "error@*:p=0.5,seed=5;sign_flip:p=0.5;ckpt_fail:p=0.5;kill@Round:p=0.01,max=1",
]


@pytest.mark.parametrize("spec", DECIDE_SPECS)
def test_decide_sequences_match_fedtpu(spec):
    """5000 calls over eight streams, the round moving every 50 calls: the
    same rule fires, or none, on every call."""
    rng = np.random.default_rng(0)
    rpcs = ["StartTrain", "SendModel", "HeartBeat", "SubmitPartial", "Attack", "Disk", "Round"]
    peers = ["a", "b", "c", "d", "localhost:1", "*"]
    calls = [
        (i // 50 if i % 50 == 0 else None, rpcs[rng.integers(len(rpcs))], peers[rng.integers(len(peers))])
        for i in range(5000)
    ]
    want, want_total = _decisions(jchaos, spec, calls)
    got, got_total = _decisions(tchaos, spec, calls)
    assert got == want
    assert got_total == want_total and got_total > 0


def test_consec_and_max_caps_bound_every_run():
    """``consec``: no stream fires more than its cap in a row, and only a
    drawn pass re-arms it; ``max``: a rule at its cap takes no draw, so
    the rules after it see the same draws in both packages."""
    for seed in range(5):
        spec = f"error@StartTrain:p=0.9,consec=2,seed={seed};corrupt@StartTrain:p=0.9,consec=1"
        t = tchaos.parse_spec(spec)
        run = worst = 0
        for _ in range(400):
            if t.decide("StartTrain", "peerX") is not None:
                run += 1
                worst = max(worst, run)
            else:
                run = 0
        assert 0 < worst <= 5
    spec = "error@StartTrain:p=1,max=3;error@StartTrain:p=0.5,seed=9"
    calls = [(None, "StartTrain", "x")] * 40
    assert _decisions(tchaos, spec, calls) == _decisions(jchaos, spec, calls)
    assert _decisions(tchaos, spec, calls)[0][:4] == [0, 0, 0, _decisions(jchaos, spec, calls)[0][3]]


class _Clock:
    """A module's ``time``, its monotonic clock set by the test."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    def sleep(self, s):
        self.now += s


def test_window_follows_the_patched_clock(monkeypatch):
    """``window=lo-hi`` keys on seconds since the schedule was built, read
    from the module's clock: both packages open and close the cut at the
    same instants."""
    spec = "partition@StartTrain:peer=a,window=5-10;delay@*:window=2-3,delay=0"
    got = {}
    for mod in (jchaos, tchaos):
        clock = _Clock()
        monkeypatch.setattr(mod, "time", clock)
        sched = mod.parse_spec(spec)
        seen = []
        for t in (0.0, 2.5, 4.99, 5.0, 7.0, 9.99, 10.0, 12.0):
            clock.now = 1000.0 + t
            rule = sched.decide("StartTrain", "a")
            seen.append(None if rule is None else rule.kind)
        got[mod.__name__] = seen
    assert got["fedtpu_torch.ft.chaos"] == got["fedtpu.ft.chaos"]
    assert got["fedtpu_torch.ft.chaos"] == [None, "delay", None, "partition", "partition", "partition", None, None]


def test_kind_classes_never_cross():
    for mod in (jchaos, tchaos):
        wire = mod.parse_spec("error@*:p=1.0")
        assert wire.decide("Disk") is None and wire.decide("Attack", "me") is None
        assert wire.decide("StartTrain", "x").kind == "error"
        disk = mod.parse_spec("ckpt_fail:p=1.0")
        assert disk.decide("StartTrain", "peer") is None and disk.decide("Disk").kind == "ckpt_fail"
        atk = mod.parse_spec("sign_flip:p=1;noise:std=1,peer=a|b")
        assert atk.decide("StartTrain", "a") is None
        assert atk.decide_attack("a", 3).kind == "sign_flip"


def test_injected_errors_are_rpc_errors_and_kill_signals_the_process(monkeypatch):
    sched = tchaos.parse_spec("error@StartTrain:code=INTERNAL;partition@SendModel;kill@Round:max=1")
    with pytest.raises(grpc.RpcError) as exc:
        sched.apply_precall(sched.rules[0], "StartTrain")
    assert exc.value.code() == grpc.StatusCode.INTERNAL and exc.value.details() == "chaos: injected error"
    with pytest.raises(grpc.RpcError) as exc:
        sched.apply_precall(sched.rules[1], "SendModel")
    assert exc.value.code() == grpc.StatusCode.UNAVAILABLE
    killed = []
    monkeypatch.setattr(tchaos.os, "kill", lambda pid, sig: killed.append((pid, sig)))
    sched.tick_round(0)
    sched.tick_round(1)
    assert killed == [(os.getpid(), tchaos.signal.SIGKILL)]
    assert sched.injected_total() == 1
    # attach() hooks a registry and a flight recorder: the next injection
    # is counted and recorded, and a later attach() with None keeps both.
    reg, flight = MetricsRegistry(), FlightRecorder(role="chaos")
    assert sched.attach(metrics=reg, flight=flight) is sched
    assert sched.attach() is sched
    assert sched.decide("StartTrain", "a").kind == "error"
    assert reg.counter("fedtpu_chaos_injected_total", labels={"kind": "error", "rpc": "StartTrain"}).value == 1
    assert [(e["kind"], e["fault"], e["rpc"]) for e in flight.snapshot()] == [("chaos", "error", "StartTrain")]


def test_corrupt_picks_the_largest_bytes_field():
    from fedtpu.transport import proto as jproto
    from fedtpu_torch.transport import proto as tproto

    cases = (("TrainReply", dict(message=b"abc"), "message"),
             ("SendModelRequest", dict(model=b"xyz", epoch=3), "model"),
             ("SubmitPartialReply", dict(record=b"rec", clients=2), "record"))
    for name, kw, field in cases:
        want = jchaos._corrupt_message(getattr(jproto, name)(**kw))
        got = tchaos._corrupt_message(getattr(tproto, name)(**kw))
        assert getattr(got, field) == getattr(want, field) == kw[field][:-1] + bytes([kw[field][-1] ^ 0xFF])
    assert tchaos._corrupt_message(tproto.Request()) == tproto.Request()


# --------------------------------------------------------------- attacks


def _delta_tree(seed=0):
    jcfg, _ = configs()
    rng = np.random.default_rng(seed)
    import jax

    return jax.tree.map(lambda a: rng.normal(size=np.shape(a)).astype(np.float32) * 1e-2, model_like(jcfg))


@pytest.mark.parametrize("spec", ["sign_flip:p=1", "scale:factor=7.5", "noise:std=0.3",
                                  "noise:std=0.3,collude=1"])
def test_attack_delta_bit_equal(spec):
    delta = _delta_tree()
    for peer, rnd in (("localhost:5001", 0), ("localhost:5002", 3)):
        j, t = jchaos.parse_spec(spec + ",seed=5"), tchaos.parse_spec(spec + ",seed=5")
        want = j.apply_attack_delta(j.rules[0], delta, peer, rnd)
        got = t.apply_attack_delta(t.rules[0], delta, peer, rnd)
        assert_bit_equal(got, want, f"{spec} {peer}")
    if "collude" in spec:
        a = t.apply_attack_delta(t.rules[0], delta, "x:1", 2)
        b = t.apply_attack_delta(t.rules[0], delta, "y:2", 2)
        assert_bit_equal(a, b, "colluders")


@pytest.fixture(scope="module")
def port_data():
    return (tdatasets.load("cifar10", "train", seed=0, num=64),
            tdatasets.load("cifar10", "test", seed=0, num=64))


def _trainer(tcfg, port_data, chaos=None):
    from fedtpu_torch.transport.trainer import LocalTrainer

    t = LocalTrainer(tcfg, seed=0, device="cpu", data=port_data[0], eval_data=port_data[1])
    t.identity = "localhost:7001"
    t.chaos = chaos
    return t


@pytest.mark.parametrize("codec", ["none", "int8"])
@pytest.mark.parametrize("spec", ["sign_flip:p=1", "scale:factor=3", "noise:std=0.01"])
def test_trainer_sends_the_attacked_payload_and_stays_honest(port_data, spec, codec):
    """An attacker's reply carries ``sent = start + attack(trained -
    start)`` in f32, the attack fedtpu's ``apply_attack_delta`` of the
    honest delta: dense, the weights ``sent`` bit for bit; synced with flat
    int8, the record of ``sent - start`` byte for byte. Its own state is
    the honest twin's, bit for bit."""
    _, tcfg = configs(compression=codec, delta_layout="flat")
    honest, attacker = _trainer(tcfg, port_data), _trainer(tcfg, port_data, tchaos.parse_spec(spec + ",seed=2"))
    if codec != "none":
        model = twire.encode(honest.host_model())
        honest.set_global(model)
        attacker.set_global(model)
    start = honest.host_model()
    honest.train_round(0, 2)
    payload = attacker.train_round(0, 2)
    for a, b in zip(twire.tree_leaves(attacker.host_model()), twire.tree_leaves(honest.host_model())):
        assert np.array_equal(a, b)
    sched = jchaos.parse_spec(spec + ",seed=2")
    honest_delta = twire.tree_map(lambda a, b: a - b, honest.host_model(), start)
    hostile = sched.apply_attack_delta(sched.rules[0], honest_delta, attacker.identity, 0)
    sent = twire.tree_map(lambda s, d: (s + d).astype(np.float32), start, hostile)
    if codec == "none":
        got = twire.decode(payload, dict(start, num_examples=np.zeros((), np.float32)))
        assert_bit_equal({k: got[k] for k in ("params", "batch_stats")}, sent, spec)
    else:
        from fedtpu.transport import sparse as jsparse

        want, _ = jsparse.encode_int8_flat(twire.tree_map(lambda a, b: a - b, sent, start),
                                           extra={"num_examples": np.float32(32.0)})
        assert payload == want
    assert attacker.chaos.injected_total() == 1


def test_trainer_label_flip_shifts_the_round_labels(port_data):
    _, tcfg = configs()
    seen = {}
    for name, chaos in (("honest", None), ("flip", tchaos.parse_spec("label_flip:offset=3"))):
        t = _trainer(tcfg, port_data, chaos)
        update = t._local_update

        def spy(*args, _update=update, _name=name):
            seen[_name] = args[4].clone()
            return _update(*args)

        t._local_update = spy
        t.train_round(1, 2)
    assert torch.equal(seen["flip"], (seen["honest"] + 3) % tcfg.num_classes)


# ------------------------------------------------------- rounds over gRPC

FAST = dict(max_attempts=4, backoff_s=0.01, backoff_max_s=0.02, probe_timeout_s=0.5)
ROUND_SPEC = ("error@StartTrain:p=0.3,consec=1;corrupt@StartTrain:p=0.25,consec=1;"
              "delay@SendModel:p=0.2,delay=0.01,seed=7")


def test_chaos_round_matches_fedtpu():
    """One fleet, one spec: fedtpu's primary, then the port's from the same
    start, three flat int8 rounds; one client's server carries an
    interceptor of the port's (reset between the runs). Bit-equal globals,
    full participation, the same injections and StartTrain retries, the
    same seeded jitter."""
    jcfg, tcfg = configs(retry=FAST, delta_layout="flat", compression="int8")
    client_chaos = tchaos.parse_spec("error@SendModel:p=0.3,consec=1,seed=3")
    fleet = Fleet(model_like(jcfg), codec="int8", layout="flat")
    from fedtpu_torch.transport import service as tservice
    from torch_coordinator import ScriptedClient

    agent = ScriptedClient(4, model_like(jcfg), "int8", "flat", examples=40)
    addr = f"localhost:{free_port()}"
    server = tservice.create_server(addr, agent, chaos=client_chaos)
    server.start()
    addrs = fleet.addrs + [addr]
    try:
        jc = jchaos.parse_spec(ROUND_SPEC)
        jp = fedtpu_primary(jcfg, addrs, chaos=jc)
        start = jp.model_bytes()
        want = []
        for _ in range(3):
            rec = jp.round()
            want.append((rec, host_tree(jp)))
        want_retries = jp.telemetry.registry.counter("fedtpu_rpc_retries_total", labels={"rpc": "StartTrain"}).value
        want_client = client_chaos.injected_total()
        client_chaos.__init__(client_chaos.rules, client_chaos.seed)
        tc = tchaos.parse_spec(ROUND_SPEC)
        tp = tfederation.PrimaryServer(tcfg, addrs, chaos=tc, initial_model=start, device="cpu")
        for i, (wrec, wtree) in enumerate(want):
            rec = tp.round()
            assert rec["participants"] == 5 and all(rec["alive"]), rec
            assert rec["participants"] == wrec["participants"] and rec["alive"] == wrec["alive"]
            assert_bit_equal(host_tree(tp), wtree, f"round {i}")
        assert tc.injected_total() == jc.injected_total() > 0
        assert tp.telemetry.registry.counter(
            "fedtpu_rpc_retries_total", labels={"rpc": "StartTrain"}).value == want_retries > 0
        assert client_chaos.injected_total() == want_client > 0
    finally:
        fleet.stop()
        server.stop(0)


def test_seeded_retry_jitter_matches_fedtpu():
    jcfg, tcfg = configs(retry=FAST)
    jp = fedtpu_primary(jcfg, [], chaos=jchaos.parse_spec("error@StartTrain:p=0.5,seed=77"))
    tp = tfederation.PrimaryServer(tcfg, [], chaos=tchaos.parse_spec("error@StartTrain:p=0.5,seed=77"),
                                   device="cpu")
    assert [tp._retry_rand() for _ in range(5)] == [jp._retry_rand() for _ in range(5)]
    assert tfederation.PrimaryServer(tcfg, [], device="cpu")._retry_rand is None


def test_corrupt_reply_is_rejected_and_retried(port_data):
    """Two real port clients; the first StartTrain reply is corrupted in
    flight. The coordinator rejects it (FTP1's CRC) inside the attempt and
    asks again; the client, a round ahead, rolls back to its snapshot and
    sends the same payload: the global equals a run without the fault."""
    _, tcfg = configs(retry=dict(max_attempts=3, backoff_s=0.01), num_clients=2)
    globals_ = []
    for spec in ("corrupt@StartTrain:p=1.0,max=1,seed=0", None):
        servers, addrs = [], []
        try:
            for i in range(2):
                addr = f"localhost:{free_port()}"
                server, _ = tfederation.serve_client(addr, tcfg, seed=i, device="cpu",
                                                     data=port_data[0], eval_data=port_data[1])
                servers.append(server)
                addrs.append(addr)
            chaos = tchaos.parse_spec(spec)
            p = tfederation.PrimaryServer(tcfg, addrs, chaos=chaos, device="cpu", seed=3)
            rec = p.round()
            assert rec["participants"] == 2 and rec["alive"] == [True, True]
            if chaos is not None:
                assert p.telemetry.registry.counter(
                    "fedtpu_rpc_retries_total", labels={"rpc": "StartTrain"}).value == 1
                assert chaos.injected_total() == 1
            globals_.append(host_tree(p))
        finally:
            for s in servers:
                s.stop(0)
    assert_bit_equal(globals_[0], globals_[1], "corrupted-and-retried round vs clean round")


def test_quorum_abort_under_chaos_matches_fedtpu():
    """A rule that outlasts the retry budget on one client: with quorum 1
    the round aborts in both packages, the global model bit-identical to
    the start, the client marked dead; the records agree."""
    jcfg, tcfg = configs(retry=dict(max_attempts=2, backoff_s=0.01), round_quorum=1.0)
    fleet = Fleet(model_like(jcfg), n=3)
    try:
        spec = json.dumps({"seed": 1, "rules": [{"kind": "error", "rpc": "StartTrain", "peer": fleet.addrs[1]}]})
        jp = fedtpu_primary(jcfg, fleet.addrs, chaos=jchaos.parse_spec(spec))
        start = jp.model_bytes()
        before = host_tree(jp)
        jrec = jp.round()
        tp = tfederation.PrimaryServer(tcfg, fleet.addrs, chaos=tchaos.parse_spec(spec), initial_model=start,
                                       device="cpu")
        trec = tp.round()
        assert trec["aborted"] and jrec["aborted"]
        for k in ("participants", "alive", "quorum_needed", "world"):
            assert trec[k] == jrec[k], k
        assert trec["alive"] == [True, False, True]
        assert_bit_equal(host_tree(tp), before, "aborted round")
    finally:
        fleet.stop()


def test_backup_chaos_arms_its_server_and_its_acting_primary():
    """The backup's schedule fires on its inbound replication (retried by
    the primary) and passes to the primary it promotes."""
    jcfg, tcfg = configs(retry=FAST)
    fleet = Fleet(model_like(jcfg), n=2)
    sched = tchaos.parse_spec("error@SendModel:p=1,max=1,seed=1")
    addr = f"localhost:{free_port()}"
    backup = tfederation.BackupServer(tcfg, fleet.addrs, watchdog_timeout=3600.0, chaos=sched, device="cpu")
    server = backup.start(addr)
    try:
        p = tfederation.PrimaryServer(tcfg, fleet.addrs, backup_address=addr, device="cpu")
        p.round()
        assert backup.latest_model == p.replica_bytes()
        assert sched.injected_total() == 1
        assert p.telemetry.registry.counter("fedtpu_rpc_retries_total", labels={"rpc": "SendModel"}).value == 1
        backup._promote()
        assert backup.acting.chaos is sched and backup.acting._retry_rand is not None
    finally:
        backup._stop_acting(wait=30)
        server.stop(0)
        fleet.stop()
