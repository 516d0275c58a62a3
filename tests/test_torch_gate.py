"""The port's membership gate (``PrimaryServer.start_gate``, the Join and
Leave RPCs on the primary and the backup) against fedtpu's, over real gRPC
on localhost, on the CPU, with scripted clients
(``torch_coordinator.ScriptedClient``).

- Churn: a client joins mid-run and trains from the next round, a member
  leaves silently and is marked dead, returns stale and is revived and
  resynced by the heartbeat, leaves gracefully, and a later joiner takes
  the freed seat. Both packages run the same script on fleets of the same
  clients: the same replies (admitted, seat, world, version, message), the
  same round records and bit-equal globals.
- Across the packages: the port's ``announce_join`` / ``announce_leave``
  against fedtpu's gate and fedtpu's against the port's.
- The backup: in its role Join answers ``admitted=0, "not primary"``;
  while acting, a join lands in the acting primary's roster, trains in
  its rounds and rides its replica back to the recovering primary.
"""

import time

from fedtpu.transport import federation as jfederation
from fedtpu.transport import proto as jproto
from fedtpu.transport import service as jservice
from fedtpu_torch.ft import Role
from fedtpu_torch.transport import federation as tfederation
from fedtpu_torch.transport import proto as tproto
from fedtpu_torch.transport import service as tservice
from test_federation import free_port
from torch_coordinator import Fleet, assert_bit_equal, configs, fedtpu_primary, host_tree, model_like

FAST = dict(max_attempts=2, backoff_s=0.01, backoff_max_s=0.05, probe_timeout_s=0.5,
            backup_ping_timeout_s=0.5)
KEYS = ("participants", "world", "membership_version", "alive", "aborted", "stragglers")


def _churn(pkg, jcfg, tcfg):
    """fedtpu's churn drill on a fresh fleet of 4 scripted clients (the
    last one joins later); returns what the drill saw."""
    fleet = Fleet(model_like(jcfg), n=4, codec="int8", layout="flat")
    addrs, seen = fleet.addrs, []
    if pkg == "fedtpu":
        p = fedtpu_primary(jcfg, addrs[:3])
    else:
        p = tfederation.PrimaryServer(tcfg, addrs[:3], device="cpu", initial_model=_churn.start)
    _churn.start = _churn.start or p.model_bytes()
    gate = f"localhost:{free_port()}"
    p.start_gate(gate)
    stub = (jservice if pkg == "fedtpu" else tservice).TrainerStub(
        (jservice if pkg == "fedtpu" else tservice).create_channel(gate))
    proto = jproto if pkg == "fedtpu" else tproto
    try:
        def rnd(label):
            rec = p.round()
            seen.append((label, {k: rec.get(k) for k in KEYS}, host_tree(p)))

        def reply(r, label):
            fields = ("admitted", "seat", "world", "version", "message") if hasattr(r, "seat") else ("left", "version")
            seen.append((label, {f: getattr(r, f) for f in fields}, None))

        rnd("start")
        reply(stub.Join(proto.JoinRequest(address=addrs[3].encode()), timeout=10), "join")
        assert fleet.agents[3].installs == 1  # resynced before its first round
        rnd("after join")
        fleet.agents[1].down = True
        rnd("silent leave")
        seen.append(("dead", [addrs.index(c) for c in p.registry.dead_clients()], None))
        fleet.agents[1].down = False
        seen.append(("revived", [addrs.index(c) for c in p.monitor.tick()], None))
        rnd("stale rejoin")
        reply(stub.Leave(proto.LeaveRequest(address=addrs[1].encode()), timeout=10), "leave")
        reply(stub.Leave(proto.LeaveRequest(address=addrs[1].encode()), timeout=10), "leave again")
        reply(stub.Join(proto.JoinRequest(address=b""), timeout=10), "empty join")
        rnd("after leave")
        out = p.admit_client(addrs[1])
        seen.append(("readmit", {k: out[k] for k in ("admitted", "seat", "world", "version")}, None))
        rnd("after readmit")
        seen.append(("ranks", [[c[1] for c in a.calls] for a in fleet.agents], None))
        return seen
    finally:
        p.stop_gate()
        fleet.stop()


def test_join_silent_leave_stale_rejoin_matches_fedtpu():
    jcfg, tcfg = configs(retry=FAST, ft_heartbeat_period_s=1e6, delta_layout="flat", compression="int8")
    _churn.start = None
    want = _churn("fedtpu", jcfg, tcfg)
    got = _churn("port", jcfg, tcfg)
    assert [s[0] for s in got] == [s[0] for s in want]
    for (label, g, gtree), (_, w, wtree) in zip(got, want):
        assert g == w, label
        if wtree is not None:
            assert_bit_equal(gtree, wtree, label)
    recs = {label: rec for label, rec, _ in got}
    assert recs["join"] == dict(admitted=1, seat=3, world=4, version=1, message=b"resynced")
    assert recs["after join"]["participants"] == 4 and recs["after join"]["world"] == 4
    assert recs["dead"] == [1] and recs["revived"] == [1]
    assert recs["leave"] == dict(left=1, version=2) and recs["leave again"]["left"] == 0
    assert recs["empty join"]["admitted"] == 0
    assert recs["after leave"]["participants"] == 3 and recs["after leave"]["world"] == 4
    assert recs["readmit"]["seat"] == 1  # the freed seat, not a new one


def _gate_and_fleet(pkg, jcfg, tcfg):
    fleet = Fleet(model_like(jcfg), n=2)
    if pkg == "fedtpu":
        p = fedtpu_primary(jcfg, fleet.addrs[:1])
    else:
        p = tfederation.PrimaryServer(tcfg, fleet.addrs[:1], device="cpu")
    gate = f"localhost:{free_port()}"
    p.start_gate(gate)
    return p, gate, fleet


def test_announce_join_across_the_packages():
    """The port's client half against fedtpu's gate, and fedtpu's against
    the port's: the joiner is admitted at seat 1 and resynced, then leaves
    and frees the seat."""
    jcfg, tcfg = configs(retry=FAST, ft_heartbeat_period_s=1e6)
    for gate_pkg, client_service in (("fedtpu", tservice), ("port", jservice)):
        p, gate, fleet = _gate_and_fleet(gate_pkg, jcfg, tcfg)
        try:
            stub = client_service.announce_join(gate, fleet.addrs[1], timeout_s=20.0, poll_s=0.05)
            assert stub is not None, gate_pkg
            assert p.registry.seat_of(fleet.addrs[1]) == 1 and p.registry.version == 1
            assert p.registry.is_alive(fleet.addrs[1]) and fleet.agents[1].installs == 1
            rec = p.round()
            assert rec["participants"] == 2 and rec["world"] == 2
            assert client_service.announce_leave(stub, fleet.addrs[1])
            assert p.registry.clients == fleet.addrs[:1] and p.registry.version == 2
        finally:
            p.stop_gate()
            fleet.stop()
    # An unreachable gate: the join gives up at its timeout.
    assert tservice.announce_join(f"localhost:{free_port()}", "x:1", timeout_s=0.3, poll_s=0.05) is None


def test_backup_gate_refuses_then_takes_joins_while_acting():
    """In the backup role Join and Leave are refused (``not primary``);
    promoted, the backup's address admits a joiner into the acting
    primary's roster, which trains it, and the recovering primary fetches
    that roster with the state."""
    jcfg, tcfg = configs(retry=FAST, ft_heartbeat_period_s=1e6)
    fleet = Fleet(model_like(jcfg), n=3)
    backup_addr = f"localhost:{free_port()}"
    rounds = []
    backup = tfederation.BackupServer(tcfg, fleet.addrs[:2], watchdog_timeout=1.0, device="cpu",
                                      on_acting_round=lambda r, rec: rounds.append(rec))
    server = backup.start(backup_addr)
    try:
        stub = tservice.TrainerStub(tservice.create_channel(backup_addr))
        reply = stub.Join(tproto.JoinRequest(address=fleet.addrs[2].encode()), timeout=10)
        assert (reply.admitted, reply.message) == (0, b"not primary")
        assert stub.Leave(tproto.LeaveRequest(address=fleet.addrs[0].encode()), timeout=10).left == 0
        p = tfederation.PrimaryServer(tcfg, fleet.addrs[:2], backup_address=backup_addr, device="cpu")
        p.round()
        assert p.pinger.tick() == 0  # arms the watchdog
        deadline = time.monotonic() + 20
        while (backup.acting is None or not rounds) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert backup.machine.role is Role.ACTING_PRIMARY and rounds, "never promoted"
        reply = stub.Join(tproto.JoinRequest(address=fleet.addrs[2].encode()), timeout=10)
        assert reply.admitted == 1 and reply.seat == 2 and reply.message == b"resynced"
        seen = len(rounds)
        while len(rounds) <= seen + 1 and time.monotonic() < deadline + 20:
            time.sleep(0.05)
        assert rounds[-1]["participants"] == 3 and rounds[-1]["world"] == 3
        assert fleet.agents[2].calls, "the joiner never trained"
        p2 = tfederation.PrimaryServer(tcfg, fleet.addrs[:2], backup_address=backup_addr, device="cpu")
        p2.run(num_rounds=0)
        assert backup.machine.role is Role.BACKUP
        assert p2.registry.clients == fleet.addrs and p2.registry.version == backup.acting.registry.version
        reply = stub.Join(tproto.JoinRequest(address=b"x:1"), timeout=10)
        assert (reply.admitted, reply.message) == (0, b"not primary")
    finally:
        backup.watchdog.stop()
        backup._stop_acting(wait=30)
        server.stop(0)
        fleet.stop()
