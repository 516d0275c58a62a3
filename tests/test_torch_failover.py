"""The coordinator's fault drills on the port, over real gRPC on
localhost, on the CPU: fedtpu's drills of ``tests/test_federation.py``
with the port's ``PrimaryServer`` and ``BackupServer`` and scripted
clients (``torch_coordinator.ScriptedClient``).

- a client that dies is marked dead and the round survives; the heartbeat
  resyncs and revives it;
- a deadline straggler is recorded, stays alive, and rejoins; one still in
  flight is not launched a second time; a broadcast still in flight is not
  raced;
- a round below quorum aborts with the global model and the server
  optimizer bit-identical, and the counter frozen;
- a truncated, bit-flipped or config-mismatched replica raises
  ``WireError``; older replica layouts install;
- the backup receives the replica, promotes on its watchdog, continues the
  round counter, and the recovering primary's ping demotes it and fetches
  its state;
- a fenced round is voided and ``handle_fence`` re-bases past the winner's
  epoch;
- replication across the packages: a fedtpu ``BackupServer`` promotes
  from the port primary's replica and the port's from fedtpu's, and each
  acting primary continues that lineage's counter and moments, bit-equal to
  the round the original primary runs itself;
- every option the port does not run raises ``NotImplementedError``
  naming its ROADMAP item, and the backup refuses Join and Leave in its
  role;
- ``_stop_acting`` survives a second caller that clears the promotion
  thread while it joins it (fedtpu's copy raises ``AttributeError``).
"""

import threading
import time

import pytest
import torch

from fedtpu.transport import federation as jfederation
from fedtpu_torch.convert import to_flax
from fedtpu_torch.ft import Role
from fedtpu_torch.transport import federation as tfederation
from fedtpu_torch.transport import proto as tproto
from fedtpu_torch.transport import service as tservice
from fedtpu_torch.transport import wire as twire
from test_federation import free_port
from torch_coordinator import (
    Fleet,
    assert_bit_equal,
    configs,
    fedtpu_primary,
    host_tree,
    model_like,
)

FAST = dict(max_attempts=2, backoff_s=0.01, backoff_max_s=0.05, probe_timeout_s=0.5,
            backup_ping_timeout_s=0.5)


def _fleet(n=3, codec="none", **fed_kw):
    jcfg, tcfg = configs(num_clients=n, retry=FAST, compression=codec, **fed_kw)
    return jcfg, tcfg, Fleet(model_like(jcfg), n=n, codec=codec)


def _primary(tcfg, addrs, **kw):
    return tfederation.PrimaryServer(tcfg, addrs, device="cpu", **kw)


def test_client_death_marks_dead_and_the_heartbeat_revives():
    _, tcfg, fleet = _fleet(2)
    dead = f"localhost:{free_port()}"  # nothing listens: fails fast
    try:
        p = _primary(tcfg, fleet.addrs + [dead])
        rec = p.round()
        assert rec["participants"] == 2 and rec["alive"] == [True, True, False]
        assert rec["world"] == 3 and p.registry.active_clients() == fleet.addrs
        assert p.monitor.tick() == []  # still dead
        p.registry.mark_failed(fleet.addrs[1])
        before = fleet.agents[1].installs
        assert p.monitor.tick() == [fleet.addrs[1]]
        assert fleet.agents[1].installs == before + 1  # resynced with the global
        assert p.registry.alive_mask().tolist() == [True, True, False]
        rec = p.round()
        assert rec["participants"] == 2 and fleet.agents[1].calls[-1][:2] == (1, 1)
    finally:
        fleet.stop()


def test_deadline_straggler_stays_alive_and_rejoins():
    _, tcfg, fleet = _fleet(3)
    try:
        p = _primary(tcfg, fleet.addrs, round_deadline_s=None)
        assert p.round()["participants"] == 3
        p.round_deadline_s = 1.0
        fleet.agents[2].delay_s = 4.0
        t0 = time.monotonic()
        rec = p.round()
        assert time.monotonic() - t0 < 4.0  # did not wait for it
        assert (rec["participants"], rec["stragglers"], rec["alive"]) == (2, 1, [True] * 3)
        fleet.agents[2].delay_s = 0.0
        rec = p.round()  # its StartTrain still runs: it sits out, not launched again
        assert (rec["participants"], rec["stragglers"]) == (2, 1)
        assert len(fleet.agents[2].calls) == 2
        p._inflight[fleet.addrs[2]].join(timeout=10)
        rec = p.round()  # drained: it rejoins
        assert (rec["participants"], rec["stragglers"]) == (3, 0)
        assert len(fleet.agents[2].calls) == 3
    finally:
        fleet.stop()


def test_inflight_straggler_is_not_launched_twice():
    _, tcfg, fleet = _fleet(3, codec="topk")
    gate = threading.Event()
    try:
        p = _primary(tcfg, fleet.addrs, round_deadline_s=1.0)
        p.round()
        fleet.agents[0].gate = gate
        recs = [p.round() for _ in range(3)]
        assert [r["stragglers"] for r in recs] == [1, 1, 1]
        assert len(fleet.agents[0].calls) == 2  # one warm-up, one held: never a third
        assert p._inflight[fleet.addrs[0]].is_alive()
        gate.set()
        p._inflight[fleet.addrs[0]].join(timeout=10)
        assert p.round()["participants"] == 3
    finally:
        gate.set()
        fleet.stop()


def test_broadcast_in_flight_is_not_raced():
    """A SendModel still running from the previous round: the next
    broadcast skips the client, and with a codec it sits out training
    (its baseline is stale)."""
    _, tcfg, fleet = _fleet(3, codec="topk")
    gate = threading.Event()
    agent = fleet.agents[0]
    try:
        p = _primary(tcfg, fleet.addrs, round_deadline_s=1.0)
        p.round()
        agent.send_gate = gate
        installs = agent.installs
        p.round()
        held = p._sends[fleet.addrs[0]]
        assert held.is_alive()
        rec = p.round()
        assert p._sends[fleet.addrs[0]] is held  # no second SendModel was started
        assert rec["stragglers"] == 1 and rec["participants"] == 2  # unsynced, sat out
        assert len(agent.calls) == 2
        gate.set()
        p._sends[fleet.addrs[0]].join(timeout=10)
        assert agent.installs == installs + 1
    finally:
        gate.set()
        fleet.stop()


def test_round_below_quorum_aborts_with_the_global_untouched():
    _, tcfg, fleet = _fleet(3, round_quorum=1.0, server_optimizer="momentum", server_lr=0.3)
    try:
        p = _primary(tcfg, fleet.addrs)
        p.round()
        before = host_tree(p)
        opt_before = {k: v.clone() for k, v in p._server_opt_state["trace"].items()}
        counter = p._round_counter
        fleet.stop(2)
        rec = p.round()
        assert rec["aborted"] and rec["quorum_needed"] == 3 and rec["participants"] == 2
        assert rec["bytes_down"] == 0 and not p._did_initial_sync
        assert_bit_equal(host_tree(p), before, "global after the abort")
        for k, v in p._server_opt_state["trace"].items():
            assert torch.equal(v, opt_before[k])
        assert p._round_counter == counter
        assert p.health() == (False, "quorum unmet: last round aborted")
        p.remove_client(fleet.addrs[2])  # the operator shrinks the federation
        rec = p.round()
        assert not rec.get("aborted") and rec["participants"] == 2 and p.health()[0]
        assert p._round_counter == counter + 1
    finally:
        fleet.stop()


def test_truncated_or_mismatched_replica_raises():
    _, tcfg = configs(server_optimizer="momentum")
    p = _primary(tcfg, ["a:1"])
    p._round_counter = 3
    data = p.replica_bytes()
    other = _primary(tcfg, [])
    with pytest.raises(twire.WireError):
        other._install(data[: len(data) // 2])
    flipped = bytearray(data)
    flipped[-1] ^= 0xFF
    with pytest.raises(twire.WireError):
        other._install(bytes(flipped))
    _, plain = configs()
    with pytest.raises(twire.WireError, match="does not match"):
        other._install(_primary(plain, []).replica_bytes())
    other._install(data)
    assert other._round_counter == 3 and other.registry.clients == ["a:1"]
    other._install(p.model_bytes())  # a plain model leaves the counter
    assert other._round_counter == 3
    # A replica of the layout before fencing and elastic membership.
    old = p.state_tree()
    del old["coord_epoch"], old["membership"]
    fresh = _primary(tcfg, ["b:1"])
    fresh._install(twire.encode(old, kind="replica"))
    assert fresh._round_counter == 3 and fresh.registry.clients == ["b:1"]
    assert_bit_equal(host_tree(fresh), host_tree(p), "older replica")


def test_backup_promotes_continues_the_counter_and_is_demoted():
    _, tcfg, fleet = _fleet(2, codec="topk", server_optimizer="momentum", server_lr=0.3)
    backup_addr = f"localhost:{free_port()}"
    backup = tfederation.BackupServer(tcfg, fleet.addrs, watchdog_timeout=1.0, device="cpu")
    server = backup.start(backup_addr)
    try:
        p = _primary(tcfg, fleet.addrs, backup_address=backup_addr)
        p.round()
        p.round()
        assert backup.latest_model == p.replica_bytes()
        assert p.pinger.tick() == 0  # arms the watchdog
        deadline = time.monotonic() + 15
        while (backup.acting is None or not backup.acting.history) and time.monotonic() < deadline:
            time.sleep(0.05)
        acting = backup.acting
        assert acting is not None and acting.history, "never promoted"
        assert backup.machine.role is Role.ACTING_PRIMARY
        assert acting._role == 2 and acting._coord_epoch == 2
        assert acting.history[0]["round"] == 2  # the lineage continues
        assert fleet.agents[0].calls[2][0] == 2 and fleet.agents[0].calls[2][3] == 2
        # The primary returns: its recovering ping demotes the backup and
        # pulls the acting primary's state.
        p2 = _primary(tcfg, fleet.addrs, backup_address=backup_addr)
        p2.run(num_rounds=0)
        assert backup.machine.role is Role.BACKUP
        assert p2._round_counter == acting._round_counter >= 3
        assert_bit_equal(host_tree(p2), host_tree(acting), "fetched state")
        for k, v in acting._server_opt_state["trace"].items():
            assert torch.equal(p2._server_opt_state["trace"][k], v)
        assert p2._coord_epoch == 2  # adopted by max from the replica
    finally:
        backup.watchdog.stop()
        backup._stop_acting(wait=30)
        server.stop(0)
        fleet.stop()


def test_fenced_round_is_voided_and_handle_fence_rebases():
    _, tcfg, fleet = _fleet(2)
    backup_addr = f"localhost:{free_port()}"
    backup = tfederation.BackupServer(tcfg, fleet.addrs, watchdog_timeout=3600.0, device="cpu")
    server = backup.start(backup_addr)
    try:
        p = _primary(tcfg, fleet.addrs, backup_address=backup_addr)
        p.round()
        before = host_tree(p)
        fleet.agents[1].fence_at = 5
        rec = p.round()
        assert rec["aborted"] and rec["fenced"] and p._fenced
        assert p.registry.is_alive(fleet.addrs[1])  # the peer is healthy: we are stale
        assert_bit_equal(host_tree(p), before, "global after the fence")
        assert p._round_counter == 1 and p._epoch_seen == 5
        assert p.health() == (False, "fenced: stale coordinator pending re-base")
        p.handle_fence()
        assert not p._fenced and p._coord_epoch == 6
        rec = p.round()
        assert not rec.get("aborted") and rec["epoch"] == 6 and rec["participants"] == 2
        # No channel to the winner: the fence holds.
        q = _primary(tcfg, fleet.addrs)
        q._fence_retry_s = 0.01
        fleet.agents[1].fence_at = 9
        assert q.round()["fenced"]
        q.handle_fence()
        assert q._fenced
    finally:
        backup.watchdog.stop()
        server.stop(0)
        fleet.stop()


def _stop_after_one(backup):
    def on_round(r, rec):
        backup._acting_stop.set()

    return on_round


@pytest.mark.parametrize("direction", ["port-to-fedtpu", "fedtpu-to-port"])
def test_replication_across_the_packages(direction):
    """The original primary runs rounds 0-1, replicating to the other
    package's backup; the backup promotes and its acting primary runs
    round 2; the original runs round 2 itself. The two rounds 2 agree bit
    for bit, moments too."""
    jcfg, tcfg, fleet = _fleet(2, codec="topk", server_optimizer="momentum", server_lr=0.3)
    backup_addr = f"localhost:{free_port()}"
    if direction == "port-to-fedtpu":
        backup = jfederation.BackupServer(jcfg, fleet.addrs, watchdog_timeout=3600.0)
        primary = _primary(tcfg, fleet.addrs, backup_address=backup_addr)
    else:
        backup = tfederation.BackupServer(tcfg, fleet.addrs, watchdog_timeout=3600.0, device="cpu")
        primary = fedtpu_primary(jcfg, fleet.addrs, backup_address=backup_addr)
    backup.on_acting_round = _stop_after_one(backup)
    server = backup.start(backup_addr)
    try:
        primary.round()
        primary.round()
        assert backup.latest_model == primary.replica_bytes()
        backup._promote()
        backup._promote_thread.join(timeout=60)
        acting = backup.acting
        assert [rec["round"] for rec in acting.history] == [2]
        assert acting._round_counter == 3
        primary.round()
        assert primary._round_counter == 3
        assert_bit_equal(host_tree(acting), host_tree(primary), "round 2")
        def trace(p):
            if isinstance(p, tfederation.PrimaryServer):
                return to_flax(p._server_opt_state["trace"])
            return p._server_opt_state[0].trace

        assert_bit_equal(trace(acting), trace(primary), "momentum")
    finally:
        backup.watchdog.stop()
        server.stop(0)
        fleet.stop()


def test_promotion_survives_a_corrupted_replica():
    _, tcfg = configs()
    backup = tfederation.BackupServer(tcfg, [], watchdog_timeout=3600.0, device="cpu")
    blob = bytearray(_primary(tcfg, []).replica_bytes())
    blob[-1] ^= 0xFF
    backup.latest_model = bytes(blob)
    backup._promote()
    try:
        assert backup.acting is not None and backup.acting._coord_epoch == 2
    finally:
        backup._stop_acting(wait=30)


class _RacedThread:
    """A promotion thread whose ``join`` lets a second caller of
    ``_stop_acting`` (the watchdog's demotion beside a FetchModel) finish
    first and clear the backup's ``_promote_thread``."""

    def __init__(self, backup):
        self.backup = backup

    def join(self, timeout=None):
        self.backup._promote_thread = None

    def is_alive(self):
        return False


def test_stop_acting_survives_a_second_caller():
    """fedtpu's ``_stop_acting`` reads ``_promote_thread`` again after the
    join, and raised ``AttributeError: 'NoneType' object has no attribute
    'is_alive'`` when another caller had cleared it meanwhile; the port's
    reads it once."""
    _, tcfg = configs()
    backup = tfederation.BackupServer(tcfg, [], watchdog_timeout=3600.0, device="cpu")
    backup._acting_stop = threading.Event()
    backup._promote_thread = _RacedThread(backup)
    backup._stop_acting(wait=1)
    assert backup._acting_stop.is_set() and backup._promote_thread is None
    later = threading.Thread(target=lambda: None)
    backup._promote_thread = raced = _RacedThread(backup)
    raced.join = lambda timeout=None: setattr(backup, "_promote_thread", later)
    backup._stop_acting(wait=1)
    assert backup._promote_thread is later  # a newer promotion's thread stays


def test_options_the_coordinator_does_not_run_raise(tmp_path):
    _, tcfg = configs()
    rebuild = lambda **kw: tcfg.__class__(**{**tcfg.__dict__, "fed": tcfg.fed.__class__(
        **{**tcfg.fed.__dict__, **kw})})
    with pytest.raises(NotImplementedError, match="slice 8"):
        _primary(rebuild(telemetry="trace"), [])
    with pytest.raises(NotImplementedError, match="slice 8"):
        tfederation.BackupServer(rebuild(telemetry="trace"), [], device="cpu")
    for cls in (tfederation.PrimaryServer, tfederation.BackupServer):
        with pytest.raises(NotImplementedError, match="slice 8"):
            cls(tcfg, [], flight=object(), device="cpu")
    p = _primary(tcfg, [])
    # run_async runs since slice 8 part 3 (tests/test_torch_async_edge.py):
    # what it refuses, it refuses with fedtpu's guards.
    with pytest.raises(ValueError, match="buffer_k must be >= 1"):
        p.run_async(4, buffer_k=0)
    with pytest.raises(ValueError, match="run_async requires compression='none'"):
        _primary(rebuild(compression="topk"), []).run_async(4)
    # A cold start runs since slice 8 part 1 (tests/test_torch_disaster.py):
    # an empty directory is a fresh start.
    from fedtpu_torch.checkpoint import Checkpointer

    assert p.restore_from_checkpoint(Checkpointer(str(tmp_path / "none"))) is None
    with pytest.raises(ValueError, match="round_quorum"):
        _primary(rebuild(round_quorum=1.5), [])
    with pytest.raises(ValueError, match="codec_policy"):
        _primary(rebuild(codec_policy="nope"), [])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tfederation.PrimaryServer(tcfg, [])


def test_backup_refuses_the_membership_rpcs():
    """In the backup role Join and Leave are refused as fedtpu's backup
    refuses them: ``admitted=0, "not primary"`` and ``left=0``."""
    _, tcfg = configs()
    addr = f"localhost:{free_port()}"
    backup = tfederation.BackupServer(tcfg, [], watchdog_timeout=3600.0, device="cpu")
    server = backup.start(addr)
    try:
        stub = tservice.TrainerStub(tservice.create_channel(addr))
        reply = stub.Join(tproto.JoinRequest(address=b"x:1"), timeout=30)
        assert (reply.admitted, reply.message) == (0, b"not primary")
        assert stub.Leave(tproto.LeaveRequest(address=b"x:1"), timeout=30) == tproto.LeaveReply(left=0)
        assert stub.HeartBeat(tproto.Request(), timeout=30).status == 1
    finally:
        backup.watchdog.stop()
        server.stop(0)
