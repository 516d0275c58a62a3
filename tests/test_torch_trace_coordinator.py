"""The coordinator's spans over real gRPC on localhost, against fedtpu's,
and the backup's ``/statusz`` feed.

- A primary of each package drives one scripted fleet
  (``tests/torch_coordinator.py``; ``mlp_tiny``, whose programs fedtpu
  compiles in a fraction of smallcnn's time: the spans do not depend on
  the model) for 2 rounds under ``telemetry="trace"``,
  replicating to a sink that stands in for the backup: flat top-k on the
  stream pipeline, and per-leaf top-k on the barrier. Their span trees are
  equal: ``client_rpc`` parented to the round by id across the collect
  threads, ``decode`` (and ``h2d`` on the stream) under it, ``replicate``
  and ``broadcast`` under the round's id. The flight ring holds every span.
- A simulated aggregator of each package takes a SendModel and two
  SubmitPartials that carry a root's context: it adopts the root's trace
  id, and the two span trees are equal.
- A backup of each package, before and after its promotion (its acting
  primary runs one round over the fleet): ``status_snapshot()`` agrees in
  every key but ``pid`` and ``seconds_since_primary_ping``.
"""

import json
import threading

import numpy as np
import pytest

from fedtpu import config as jconfig
from fedtpu.transport import aggregator as jaggregator
from fedtpu.transport import federation as jfederation
from fedtpu.transport import proto as jproto
from fedtpu.transport import service as jservice
from fedtpu.transport import wire as jwire
from fedtpu_torch import config as tconfig
from fedtpu_torch.obs import propagate as tprop
from fedtpu_torch.transport import aggregator as taggregator
from fedtpu_torch.transport import federation as tfederation
from fedtpu_torch.transport import proto as tproto
from fedtpu_torch.transport import service as tservice
from test_federation import free_port
from test_torch_obs_grpc import _untimed
from test_torch_tiers import TEMPLATE, encode
from torch_coordinator import Fleet, configs, fedtpu_primary, model_like

IDS = ("span_id", "parent_id")


def _configs(**fed_kw):
    def build(mod):
        return mod.RoundConfig(
            model="mlp_tiny", num_classes=10, opt=mod.OptimizerConfig(learning_rate=0.01),
            data=mod.DataConfig(dataset="synthetic", batch_size=8, eval_batch_size=16,
                                partition="iid", augment=False, num_examples=64),
            fed=mod.FedConfig(**{"num_clients": 4, "topk_fraction": 0.05, **fed_kw}),
        )

    return build(jconfig), build(tconfig)


def _args(event):
    return json.dumps({k: v for k, v in event["args"].items() if k not in IDS}, sort_keys=True)


def span_tree(events):
    """Each span as its path of (name, args) from its root, sorted: the
    structure the parent ids encode, whatever order threads ran in."""
    by_id = {e["args"]["span_id"]: e for e in events}
    paths = []
    for e in events:
        path, node = [], e
        while node is not None:
            path.append((node["name"], _args(node)))
            node = by_id.get(node["args"].get("parent_id"))
        paths.append(tuple(reversed(path)))
    return sorted(paths)


def parent_names(events):
    by_id = {e["args"]["span_id"]: e["name"] for e in events}
    return {(e["name"], by_id.get(e["args"].get("parent_id"))) for e in events}


class _Sink(jservice.TrainerServicer):
    """Takes a replica and answers ok: the backup's place in the round."""

    def SendModel(self, request, context):
        return jproto.SendModelReply(reply=b"ok")


@pytest.mark.parametrize("fed_kw,codec,layout", [
    (dict(compression="topk", delta_layout="flat", server_pipeline="stream"), "topk", "flat"),
    (dict(compression="topk", server_pipeline="barrier"), "topk", "per_leaf"),
], ids=["stream-flat-topk", "barrier-per_leaf-topk"])
def test_primary_span_trees_match_fedtpus(fed_kw, codec, layout):
    jcfg, tcfg = _configs(telemetry="trace", **fed_kw)
    fleet = Fleet(model_like(jcfg), codec=codec, layout=layout)
    sink_addr = f"localhost:{free_port()}"
    sink = jservice.create_server(sink_addr, _Sink())
    sink.start()
    try:
        jp = fedtpu_primary(jcfg, fleet.addrs, backup_address=sink_addr)
        start = jp.model_bytes()
        jrecs = [jp.round() for _ in range(2)]
        tp = tfederation.PrimaryServer(tcfg, fleet.addrs, backup_address=sink_addr, initial_model=start,
                                       device="cpu")
        trecs = [tp.round() for _ in range(2)]
    finally:
        fleet.stop()
        sink.stop(0)
    assert [r["participants"] for r in trecs] == [r["participants"] for r in jrecs] == [4, 4]
    jev, tev = jp.telemetry.trace_events(), tp.telemetry.trace_events()
    assert span_tree(tev) == span_tree(jev)
    stream = fed_kw["server_pipeline"] == "stream"
    per_round = {"round": 1, "collect": 1, "client_rpc": 4, "decode": 4, "h2d": 4 if stream else 0,
                 "aggregate": 1, "replicate": 1, "broadcast": 4}
    assert {n: sum(e["name"] == n for e in tev) for n in per_round} == {n: 2 * k for n, k in per_round.items()}
    assert parent_names(tev) == {("round", None), ("collect", "round"), ("client_rpc", "round"),
                                 ("decode", "client_rpc"), ("aggregate", "round"), ("replicate", "round"),
                                 ("broadcast", "round")} | ({("h2d", "client_rpc")} if stream else set())
    rounds = sorted(e["args"]["round"] for e in tev if e["name"] == "round")
    assert rounds == [0, 1]
    assert {e["tid"] for e in tev if e["name"] == "client_rpc"} != {e["tid"] for e in tev if e["name"] == "round"}
    ring = [e for e in tp.flight.snapshot() if e["kind"] == "span"]
    assert sorted(e["name"] for e in ring) == sorted(e["name"] for e in tev)
    assert tp.status_snapshot()["trace_id"] == tp.telemetry.tracer.trace_id


def test_aggregator_adopts_the_roots_context_as_fedtpus():
    jcfg, tcfg = configs(delta_layout="flat", tier_fanout=2, telemetry="trace")
    rng = np.random.default_rng(3)
    delta = lambda: {"params": {k: rng.normal(size=v.shape).astype(np.float32)
                                for k, v in TEMPLATE["params"].items()}, "batch_stats": {}}
    payloads = [encode("int8", delta(), w) for w in (1.0, 3.0)]
    root = {"round": 0}
    source = lambda: tprop.TraceContext("r00t", span_id=9, role="primary", round=root["round"])
    trees = []
    for mod, kw in ((jaggregator, {}), (taggregator, {"device": "cpu"})):
        server, agg = mod.serve_aggregator(f"localhost:{free_port()}", jcfg if mod is jaggregator else tcfg,
                                           template=TEMPLATE, cohort_source=lambda r, b, w: list(payloads), **kw)
        root["round"] = 0
        channel = tservice.create_channel(agg.identity, trace_source=source)
        stub = tservice.TrainerStub(channel)
        try:
            stub.SendModel(tproto.SendModelRequest(model=jwire.encode(TEMPLATE), epoch=1), timeout=30)
            for r in range(2):
                root["round"] = r
                stub.SubmitPartial(tproto.SubmitPartialRequest(rank_base=0, world=2, round=r, epoch=1),
                                   timeout=30)
        finally:
            channel.close()
            server.stop(0)
        assert agg.telemetry.tracer.trace_id == "r00t"
        trees.append((agg.telemetry.trace_events(), span_tree(agg.telemetry.trace_events())))
    (jev, jtree), (tev, ttree) = trees
    assert ttree == jtree
    assert parent_names(tev) == {("install_global", None), ("submit_partial", None), ("collect", "submit_partial"),
                                 ("decode", "collect"), ("partial_reduce", "submit_partial")}
    partials = [e["args"] for e in tev if e["name"] == "submit_partial"]
    assert [(a["round"], a["coord_round"], a["remote_parent"], a["remote_role"], a["trace_id"]) for a in partials] == [
        (0, 0, 9, "primary", "r00t"), (1, 1, 9, "primary", "r00t")]
    assert sum(e["name"] == "decode" for e in tev) == 4


def _one_round(self, num_rounds=None, stop=None, on_round=None):
    return [self.round()]


def test_backup_status_snapshot_is_fedtpus(monkeypatch):
    jcfg, tcfg = _configs(compression="topk", delta_layout="flat", server_pipeline="stream")
    fleet = Fleet(model_like(jcfg), codec="topk", layout="flat")
    # The acting primary runs one round, so what it reports is the same
    # in both packages.
    monkeypatch.setattr(jfederation.PrimaryServer, "run", _one_round)
    monkeypatch.setattr(tfederation.PrimaryServer, "run", _one_round)
    snaps = []
    try:
        replica = fedtpu_primary(jcfg, fleet.addrs).replica_bytes()
        for mod, cfg, kw in ((jfederation, jcfg, {}), (tfederation, tcfg, {"device": "cpu"})):
            backup = mod.BackupServer(cfg, fleet.addrs, watchdog_timeout=1e-6, **kw)
            fresh = backup.status_snapshot()
            backup.SendModel(jproto.SendModelRequest(model=replica, epoch=1), None)
            held = backup.status_snapshot()
            backup.CheckIfPrimaryUp(jproto.PingRequest(req=b"0", epoch=1), None)
            threading.Event().wait(0.01)
            assert backup.machine.check_watchdog()
            backup._promote_thread.join(60)
            acting = backup.status_snapshot()
            snaps.append((fresh, held, acting))
    finally:
        fleet.stop()
    for (jsnap, tsnap) in zip(*snaps):
        jsnap, tsnap = dict(jsnap), dict(tsnap)
        assert set(tsnap) == set(jsnap)
        assert tsnap.pop("pid") == jsnap.pop("pid")
        tsince, jsince = tsnap.pop("seconds_since_primary_ping"), jsnap.pop("seconds_since_primary_ping")
        assert (tsince is None) == (jsince is None)
        if "acting" in tsnap:
            assert _untimed(tsnap.pop("acting")) == _untimed(jsnap.pop("acting"))
        assert tsnap == jsnap
    fresh, held, acting = snaps[1]
    assert fresh == dict(fresh, role="backup", seconds_since_primary_ping=None, has_replica=False, epoch_seen=-1)
    assert "acting" not in fresh and "acting" not in held and held["has_replica"]
    assert (acting["role"], acting["epoch_seen"], acting["acting"]["rounds_completed"]) == ("acting_primary", 2, 1)
    assert acting["acting"]["fencing"] == {"epoch": 2, "role": "acting", "fenced": False}
