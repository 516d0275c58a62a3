"""The port's ``fedtpu_torch.ft`` against ``fedtpu.ft``, on the CPU.

- ``MembershipTable``: one seeded sequence of admit / evict / mark_failed /
  mark_alive / observe_screening / quarantine / release / tick_quarantine
  on both tables gives the same return values, seats, masks, versions,
  capacities and ``snapshot()`` after every step, and the same
  ``json.dumps`` bytes (the replica's ``membership`` leaf);
  ``restore`` round-trips, across the packages too.
- ``FailoverStateMachine`` under a fake clock: the same pings and watchdog
  checks make the same transitions and callbacks in both.
- ``HeartbeatMonitor.tick`` by hand: resync before revive, a failed resync
  leaves the client dead, concurrent probes of several dead clients.
- ``PrimaryPinger``: the recovering flag clears once a ping is delivered.
"""

import json

import numpy as np
import pytest

from fedtpu import ft as jft
from fedtpu_torch import ft as tft
from fedtpu_torch.obs import FlightRecorder, MetricsRegistry

OPS = ("admit", "evict", "mark_failed", "mark_alive", "observe_screening",
       "quarantine", "release", "tick_quarantine")


def _state(t):
    return (t.clients, t.size, t.version, t.capacity(), t.seat_map(), t.active_clients(),
            t.dead_clients(), t.alive_mask().tolist(), t.quarantined_clients(),
            t.suspicion_map(), t.snapshot(), t.status())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_membership_sequence_matches_fedtpu(seed):
    rng = np.random.default_rng(seed)
    start = [f"c{i}" for i in range(4)]
    j, t = jft.MembershipTable(start), tft.MembershipTable(start)
    assert _state(t) == _state(j)
    names = [f"c{i}" for i in range(8)]
    for step in range(300):
        op = OPS[rng.integers(len(OPS))]
        c = names[rng.integers(len(names))]
        args = (c,)
        kw = {}
        if op == "evict":
            kw = {"reason": "leave"}
        if op == "observe_screening":
            args = (c, bool(rng.integers(2)))
            kw = {"ewma": float(rng.choice([0.5, 0.3, 1.0]))}
        got = getattr(t, op)(*args, **kw)
        want = getattr(j, op)(*args, **kw)
        assert got == want, (step, op, c)
        assert _state(t) == _state(j), (step, op, c)
        assert json.dumps(t.snapshot()).encode() == json.dumps(j.snapshot()).encode()
        assert t.is_alive(c) == j.is_alive(c) and t.is_member(c) == j.is_member(c)
        assert t.seat_of(c) == j.seat_of(c) and t.suspicion(c) == j.suspicion(c)


def test_restore_round_trips_across_packages():
    t = tft.MembershipTable(["a", "b", "c"])
    t.evict("b")
    t.admit("d")
    t.admit("e")
    t.mark_failed("c")
    t.observe_screening("a", True, ewma=0.3)
    t.quarantine("a")
    t.tick_quarantine("a")
    snap = json.loads(json.dumps(t.snapshot()))
    for table in (tft.MembershipTable(["x"]), jft.MembershipTable(["x"])):
        table.restore(snap)
        assert table.snapshot() == t.snapshot()
        assert table.capacity() == t.capacity() == 4
        assert table.admit("f") == 4  # no free seat left: capacity grows
    # Rows of the pre-reputation layout restore with a clean slate; the
    # version never goes backwards.
    old = {"version": 1, "capacity": 3, "members": [["a", 0, True], ["b", 2, False]]}
    for table in (tft.MembershipTable(), jft.MembershipTable()):
        table.restore(old)
    fresh = tft.MembershipTable()
    fresh.restore(old)
    assert fresh.snapshot() == {"version": 1, "capacity": 3,
                                "members": [["a", 0, True, 0.0, -1], ["b", 2, False, 0.0, -1]]}
    assert fresh.admit("c") == 1
    t.restore(old)
    assert t.version == 3  # kept: higher than the snapshot's
    with pytest.raises(ValueError, match="duplicate seats"):
        t.restore({"version": 0, "capacity": 2, "members": [["a", 0, True], ["b", 0, True]]})
    with pytest.raises(ValueError, match="duplicate client id"):
        tft.MembershipTable(["a", "a"])


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _machine(mod, clock, events, arm=False):
    return mod.FailoverStateMachine(
        timeout=2.0,
        on_promote=lambda: events.append("promote"),
        on_demote=lambda: events.append("demote"),
        clock=clock,
        arm_without_ping=arm,
    )


@pytest.mark.parametrize("arm", [False, True])
def test_failover_state_machine_matches_fedtpu(arm):
    rng = np.random.default_rng(7)
    cj, ct = _Clock(), _Clock()
    ej, et = [], []
    mj, mt = _machine(jft, cj, ej, arm), _machine(tft, ct, et, arm)
    for step in range(400):
        dt = float(rng.choice([0.1, 0.5, 1.0, 2.5]))
        cj.t += dt
        ct.t += dt
        ev = rng.integers(3)
        if ev == 0:
            rec = bool(rng.integers(2))
            assert mt.on_ping(rec) == mj.on_ping(rec), step
        else:
            assert mt.check_watchdog() == mj.check_watchdog(), step
        assert mt.role.value == mj.role.value, step
        assert mt.seconds_since_ping() == mj.seconds_since_ping(), step
    assert et == ej and "promote" in et and "demote" in et


def test_watchdog_never_promotes_before_a_ping():
    clock, events = _Clock(), []
    m = _machine(tft, clock, events)
    clock.t += 1000
    assert not m.check_watchdog() and m.role is tft.Role.BACKUP
    assert m.seconds_since_ping() == float("inf")
    m.on_ping(False)
    clock.t += 1.9
    assert not m.check_watchdog()
    clock.t += 0.2
    assert m.check_watchdog() and m.role is tft.Role.ACTING_PRIMARY
    assert not m.check_watchdog()  # once
    assert m.on_ping(False) == 0 and m.role is tft.Role.ACTING_PRIMARY
    assert m.on_ping(True) == 1 and m.role is tft.Role.BACKUP
    assert events == ["promote", "demote"]


def test_heartbeat_tick_resyncs_before_reviving():
    reg = tft.MembershipTable(["a", "b", "c"])
    up = {"a": True, "b": True, "c": False}
    order = []

    def resync(c):
        assert not reg.is_alive(c)  # the model lands before the revive
        order.append(c)
        if c == "b":
            raise RuntimeError("send failed")

    mon = tft.HeartbeatMonitor(reg, probe=lambda c: up[c], resync=resync, period=0.01,
                               probe_deadline_s=5.0)
    assert mon.tick() == []  # nobody dead
    for c in "abc":
        reg.mark_failed(c)
    assert mon.tick() == ["a"]
    assert sorted(order) == ["a", "b"]
    assert reg.dead_clients() == ["b", "c"]
    up["c"] = True
    order.clear()
    reg.mark_failed("a")
    mon.resync = order.append
    assert mon.tick() == ["a", "b", "c"]
    assert reg.active_clients() == ["a", "b", "c"]
    mon.start()
    mon.stop()
    assert isinstance(tft.ClientRegistry(["a"]), tft.MembershipTable)


def test_primary_pinger_clears_recovering_once_delivered():
    sent = []
    answers = iter([None, 0, 0])

    def send(recovering):
        sent.append(recovering)
        return next(answers)

    p = tft.PrimaryPinger(send)
    assert p.tick() is None and p.recovering
    assert p.tick() == 0 and not p.recovering
    p.tick()
    assert sent == [True, True, False]


def test_ft_takes_no_metrics_registry(tmp_path):
    """The ft classes take a registry and a flight recorder since slice 8
    part 5a (the name stays from when they refused them)."""
    reg = MetricsRegistry()
    t = tft.MembershipTable(["a"], metrics=reg)
    t.mark_failed("a")
    assert reg.counter("fedtpu_ft_client_deaths_total").value == 1
    flight = FlightRecorder(role="backup", artifacts_dir=str(tmp_path))
    clock = [0.0]
    m = tft.FailoverStateMachine(timeout=1.0, clock=lambda: clock[0], arm_without_ping=True,
                                 metrics=reg, flight=flight)
    clock[0] = 2.0
    assert m.check_watchdog()
    assert reg.counter("fedtpu_ft_failover_transitions_total", labels={"to": "acting_primary"}).value == 1
    assert [e["kind"] for e in flight.snapshot()] == ["failover"]
    assert json.loads(open(flight.dump_path()).read())["reason"] == "failover:acting_primary"
