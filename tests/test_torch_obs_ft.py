"""The port's ft classes, chaos schedule and checkpoint store count into a
registry and a flight recorder as fedtpu's do, on the same events.

One script of membership churn (join, rejoin, evict, a non-member's
operations), deaths and recoveries, screening verdicts and quarantine,
heartbeat misses and a failed resync, a forced failover and its demotion,
and backup pings goes through fedtpu's ``fedtpu.ft`` with a
``fedtpu.obs.MetricsRegistry`` and through the port's with the port's.
The Prometheus text must be byte-equal once the timed
``fedtpu_ft_rpc_seconds`` series are left out; of those, the counts are
equal. The flight events agree but for their clocks. A chaos schedule
with wire, disk and attack rules, attached to both packages' registries,
counts the same injections; two checkpoint stores with the same disk
faults count the same saves, failures and fallbacks. Mirrors
``tests/test_observability.py`` and ``tests/test_obs_propagation.py``.
"""

import json

import numpy as np

import fedtpu.obs as jobs
from fedtpu import ft as jft
from fedtpu.checkpoint import checkpoint as jck
from fedtpu.ft import chaos as jchaos
import fedtpu_torch.obs as tobs
from fedtpu_torch import ft as tft
from fedtpu_torch.checkpoint import checkpoint as tck
from fedtpu_torch.ft import chaos as tchaos

TIMED = "fedtpu_ft_rpc_seconds"


def _untimed(text):
    return "\n".join(line for line in text.splitlines() if TIMED not in line)


def _events(flight):
    return [{k: v for k, v in e.items() if k != "t"} for e in flight.snapshot()]


def _drive(ft, obs, tmp_path, tag):
    reg = obs.MetricsRegistry()
    flight = obs.FlightRecorder(role="backup", artifacts_dir=str(tmp_path / tag))
    t = ft.ClientRegistry(["a", "b", "c"], metrics=reg)
    t.admit("d")
    t.admit("d")  # a member keeps its seat: no event
    t.mark_alive("d")
    t.mark_failed("a")
    t.mark_failed("a")  # already dead: no event
    t.mark_alive("a")
    t.mark_failed("zz")
    t.evict("b", reason="leave")
    t.evict("b")
    t.admit("e")
    for flagged in (True, True, False):
        t.observe_screening("c", flagged)
    t.observe_screening("gone", True)
    t.quarantine("c")
    t.quarantine("c")
    t.quarantine("nobody")
    t.tick_quarantine("c")
    t.release("c")
    t.quarantine("d")
    t.restore(t.snapshot())
    t.mark_failed("c")
    t.mark_failed("e")
    answers = {"c": [False, True], "e": [True, True]}
    resync_fails = {"e": 1}

    def resync(client):
        if resync_fails.get(client):
            resync_fails[client] -= 1
            raise RuntimeError("push failed")

    monitor = ft.HeartbeatMonitor(t, probe=lambda c: answers[c].pop(0), resync=resync, metrics=reg)
    recovered = [monitor.tick(), monitor.tick()]
    clock = [0.0]
    machine = ft.FailoverStateMachine(timeout=10.0, clock=lambda: clock[0], metrics=reg, flight=flight)
    machine.on_ping(False)
    clock[0] = 11.0
    promoted = machine.check_watchdog()
    dump = json.loads(open(flight.dump_path()).read())
    demoted = machine.on_ping(True)
    sent = []
    pinger = ft.PrimaryPinger(lambda recovering: sent.append(recovering) or (None if len(sent) == 1 else 0),
                              metrics=reg)
    pinger.tick()
    pinger.tick()
    return reg, flight, dict(recovered=recovered, promoted=promoted, demoted=demoted, sent=sent,
                             reason=dump["reason"], status=t.status())


def test_ft_counts_fedtpus_events_byte_for_byte(tmp_path):
    jreg, jflight, jout = _drive(jft, jobs, tmp_path, "j")
    treg, tflight, tout = _drive(tft, tobs, tmp_path, "t")
    assert tout == jout and tout["reason"] == "failover:acting_primary"
    ttext, jtext = tobs.prometheus_text(treg), jobs.prometheus_text(jreg)
    assert _untimed(ttext) == _untimed(jtext)
    for name in ("fedtpu_membership_joins_total", "fedtpu_membership_evictions_total",
                 "fedtpu_membership_quarantine_total", "fedtpu_membership_unknown_total",
                 "fedtpu_ft_client_deaths_total", "fedtpu_ft_client_recoveries_total",
                 "fedtpu_ft_heartbeat_misses_total", "fedtpu_ft_resync_failures_total",
                 "fedtpu_ft_failover_transitions_total", "fedtpu_membership_version"):
        assert f"# TYPE {name} " in ttext, name
    count = lambda reg: {tuple(e["labels"].items()): e["count"] for e in reg.snapshot()[TIMED]}
    assert count(treg) == count(jreg) == {(("rpc", "CheckIfPrimaryUp"),): 2, (("rpc", "HeartBeat"),): 4}
    assert _events(tflight) == _events(jflight)
    assert [e["dst"] for e in _events(tflight)] == ["acting_primary", "backup"]


SPEC = ("error@StartTrain:p=0.5,seed=7;corrupt@SendModel:p=0.5,max=2;ckpt_fail:p=0.5;"
        "sign_flip:p=0.5,peer=x|y;noise:std=1,p=0.3")


def test_chaos_attach_counts_the_same_injections(tmp_path):
    out = {}
    for name, chaos, obs in (("j", jchaos, jobs), ("t", tchaos, tobs)):
        reg = obs.MetricsRegistry()
        flight = obs.FlightRecorder(role="chaos", artifacts_dir=str(tmp_path))
        sched = chaos.parse_spec(SPEC).attach(metrics=reg, flight=flight)
        for r in range(12):
            sched.set_round(r)
            sched.decide("StartTrain", "x")
            sched.decide("SendModel", "y")
            sched.decide("Disk")
            sched.decide_attack("x" if r % 2 else "y", r)
        out[name] = (obs.prometheus_text(reg), _events(flight), sched.injected_total())
    assert out["t"] == out["j"]
    text = out["t"][0]
    assert "fedtpu_chaos_injected_total{kind=" in text and "fedtpu_attack_injected_total{kind=" in text
    assert out["t"][2] == len(out["t"][1]) > 0


def test_checkpointer_counts_saves_failures_and_fallbacks_as_fedtpus(tmp_path):
    state = {"w": np.arange(12, dtype=np.float32).reshape(3, 4), "b": np.ones(3, np.float32)}
    out = {}
    for name, ck, chaos, obs in (("j", jck, jchaos, jobs), ("t", tck, tchaos, tobs)):
        reg = obs.MetricsRegistry()
        flight = obs.FlightRecorder(role="ckpt", artifacts_dir=str(tmp_path))
        store = ck.Checkpointer(str(tmp_path / name), keep=3, backend="wire", metrics=reg, flight=flight,
                                chaos=chaos.parse_spec("ckpt_fail:p=0.4,seed=3;ckpt_rot:p=0.4"))
        saved = [store.save(r, state) is not None for r in range(6)]
        latest = store.restore_latest(like=state)
        snap = reg.snapshot()
        write = snap.pop("fedtpu_checkpoint_write_seconds")[0]
        events = [{k: v for k, v in e.items() if k != "error"} for e in _events(flight)]
        out[name] = (saved, latest[0], snap, write["count"], events)
    assert out["t"] == out["j"]
    saved, _, snap, writes, events = out["t"]
    assert writes == sum(saved) == snap["fedtpu_checkpoint_saves_total"][0]["value"]
    assert snap["fedtpu_checkpoint_save_failures_total"][0]["value"] == len(saved) - sum(saved) > 0
    assert {e["event"] for e in events} == {"save_failed", "fallback"}
