"""The coordinator's telemetry over real gRPC on localhost, against
fedtpu's: the port's ``PrimaryServer``, ``BackupServer`` and
``AggregatorServer`` feed their registries, flight recorders and status
boards on fedtpu's events.

- A primary of each package drives one scripted fleet
  (``tests/torch_coordinator.py``) for 2 rounds: the registries hold the
  same names, kinds and labels, the same counter values and histogram
  counts; the byte counters equal the round records' sums, each phase
  histogram counts the rounds, the flight ring holds one ``round`` event a
  round, and ``status_snapshot()`` has fedtpu's keys and values but for the
  clock and the memory axes.
- A backup promoted on its watchdog dumps its flight recorder into the
  test's directory (``failover:acting_primary``), its acting primary
  records its rounds there, and the demotion dumps again.
- A simulated aggregator of each package, through SendModel and two
  SubmitPartials, counts the same bytes, partials and phases.

``run_async``'s staleness histogram is held against its records in
``tests/test_torch_async_edge.py``.
"""

import json
import time

import numpy as np

from fedtpu.transport import aggregator as jaggregator
from fedtpu.transport import wire as jwire
from fedtpu_torch.ft import Role
from fedtpu_torch.obs import FlightRecorder
from fedtpu_torch.transport import aggregator as taggregator
from fedtpu_torch.transport import federation as tfederation
from fedtpu_torch.transport import proto as tproto
from fedtpu_torch.transport import service as tservice
from test_federation import free_port
from test_torch_tiers import TEMPLATE, encode
from torch_coordinator import Fleet, configs, fedtpu_primary, model_like

# Set from the clock or the process, not from the events.
TIMED_GAUGES = {"fedtpu_process_rss_bytes", "fedtpu_step_time_seconds"}


def _shape(registry):
    out = {}
    for name, entries in registry.snapshot().items():
        out[name] = [
            (e["labels"], e["kind"],
             e["count"] if e["kind"] == "histogram" else None if name in TIMED_GAUGES else e["value"])
            for e in entries
        ]
    return out


def _untimed(snap):
    snap = dict(snap)
    snap.pop("updated_at")
    snap.pop("pid")
    snap["mem"] = {k: v for k, v in snap["mem"].items() if k != "rss_bytes"}
    snap["last_round"] = {k: v for k, v in snap["last_round"].items()
                          if not k.startswith("t_") and k != "client_latency"}
    return snap


def test_primary_feeds_fedtpus_registry_flight_and_board():
    jcfg, tcfg = configs(compression="topk", delta_layout="flat", server_pipeline="stream")
    fleet = Fleet(model_like(jcfg), codec="topk", layout="flat")
    try:
        jp = fedtpu_primary(jcfg, fleet.addrs)
        start = jp.model_bytes()
        jrecs = [jp.round() for _ in range(2)]
        tp = tfederation.PrimaryServer(tcfg, fleet.addrs, initial_model=start, device="cpu")
        trecs = [tp.round() for _ in range(2)]
    finally:
        fleet.stop()
    assert [r["bytes_up"] for r in trecs] == [r["bytes_up"] for r in jrecs]
    assert _shape(tp.telemetry.registry) == _shape(jp.telemetry.registry)
    snap = tp.telemetry.registry.snapshot()
    value = lambda name, **labels: next(e["value"] for e in snap[name] if e["labels"] == labels)
    assert value("fedtpu_rounds_completed_total") == 2
    assert value("fedtpu_rpc_bytes_up_total") == sum(r["bytes_up"] for r in trecs)
    assert value("fedtpu_rpc_bytes_up_total", codec="topk") == sum(r["bytes_up"] for r in trecs)
    assert value("fedtpu_rpc_bytes_down_total") == sum(r["bytes_down"] for r in trecs)
    assert {e["labels"]["phase"]: e["count"] for e in snap["fedtpu_round_phase_seconds"]} == {
        "collect": 2, "decode": 2, "h2d": 2, "aggregate": 2}
    assert snap["fedtpu_client_rpc_seconds"][0]["count"] == 8
    rounds = [e for e in tp.flight.snapshot() if e["kind"] == "round"]
    assert [e["round"] for e in rounds] == [0, 1] and tp.flight.role == "primary"
    assert [e["participants"] for e in rounds] == [4, 4]
    tsnap, jsnap = tp.status_snapshot(), jp.status_snapshot()
    assert set(tsnap) == set(jsnap) and set(tsnap["mem"]) == set(jsnap["mem"])
    assert _untimed(tsnap) == _untimed(jsnap)
    assert (tsnap["phase"], tsnap["round"], tsnap["stragglers_in_flight"]) == ("idle", 1, [])
    assert tsnap["heartbeat_misses"] == 0 and tsnap["mem"]["partial_rows_buffered"] == 0
    assert tp.health() == (True, "ok")


def test_a_promoted_backup_dumps_its_flight_recorder(tmp_path):
    jcfg, tcfg = configs(num_clients=2)
    fleet = Fleet(model_like(jcfg), n=2)
    flight = FlightRecorder(role="backup", artifacts_dir=str(tmp_path))
    backup = tfederation.BackupServer(tcfg, fleet.addrs, watchdog_timeout=0.5, flight=flight, device="cpu")
    addr = f"localhost:{free_port()}"
    server = backup.start(addr)
    try:
        p = tfederation.PrimaryServer(tcfg, fleet.addrs, backup_address=addr, device="cpu")
        p.round()
        assert p.pinger.tick() == 0  # arms the watchdog, then silence
        deadline = time.monotonic() + 15
        while (backup.acting is None or not backup.acting.history) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert backup.machine.role is Role.ACTING_PRIMARY and backup.acting.flight is flight
        doc = json.loads(open(flight.dump_path()).read())
        assert doc["reason"] == "failover:acting_primary" and doc["role"] == "backup"
        assert doc["events"][-1]["kind"] == "failover" and doc["events"][-1]["dst"] == "acting_primary"
        assert str(tmp_path) in flight.dump_path()
        assert backup.machine.on_ping(True) == 1
        doc = json.loads(open(flight.dump_path()).read())
        assert doc["reason"] == "failover:backup" and doc["dump_count"] == 2
        kinds = [e["kind"] for e in doc["events"]]
        assert "round" in kinds[kinds.index("failover"):]  # the acting primary's rounds
        transitions = backup.telemetry.registry.snapshot()["fedtpu_ft_failover_transitions_total"]
        assert {e["labels"]["to"]: e["value"] for e in transitions} == {"acting_primary": 1, "backup": 1}
    finally:
        backup.watchdog.stop()
        backup._stop_acting(wait=30)
        server.stop(0)
        fleet.stop()


def test_aggregator_counts_as_fedtpus():
    jcfg, tcfg = configs(delta_layout="flat", tier_fanout=2)
    rng = np.random.default_rng(3)
    delta = lambda: {"params": {k: rng.normal(size=v.shape).astype(np.float32)
                                for k, v in TEMPLATE["params"].items()}, "batch_stats": {}}
    payloads = [encode("int8", delta(), w) for w in (1.0, 3.0)]
    shapes = []
    for mod, kw in ((jaggregator, {}), (taggregator, {"device": "cpu"})):
        server, agg = mod.serve_aggregator(f"localhost:{free_port()}", jcfg if mod is jaggregator else tcfg,
                                           template=TEMPLATE, cohort_source=lambda r, b, w: list(payloads), **kw)
        stub = tservice.TrainerStub(tservice.create_channel(agg.identity))
        try:
            stub.SendModel(tproto.SendModelRequest(model=jwire.encode(TEMPLATE), epoch=1), timeout=30)
            for r in range(2):
                stub.SubmitPartial(tproto.SubmitPartialRequest(rank_base=0, world=2, round=r, epoch=1),
                                   timeout=30)
            shapes.append((_shape(agg.telemetry.registry), agg.status_snapshot()["mem"]["partial_rows_buffered"]))
        finally:
            server.stop(0)
    assert shapes[1] == shapes[0]
    shape = shapes[1][0]
    assert shape["fedtpu_rounds_completed_total"] == [({}, "counter", 2.0)]
    assert shape["fedtpu_rpc_bytes_up_total"] == [({}, "counter", float(2 * sum(map(len, payloads))))]
    assert [(lab["phase"], n) for lab, _, n in shape["fedtpu_round_phase_seconds"]] == [
        ("partial_reduce", 2), ("submit_partial", 2)]
