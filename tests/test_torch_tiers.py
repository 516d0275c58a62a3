"""The port's two-tier federation (``fedtpu_torch/transport/aggregator.py``
and the root ``PrimaryServer`` with ``tier_fanout``) against fedtpu's, over
real gRPC on localhost, on the CPU.

- Exactness: on dyadic inputs, where every f32 add is exact, the partials
  of fedtpu's ``AggregatorServer`` and of the port's, combined at the
  root, are the flat weighted mean byte for byte, for every flat codec.
- Topologies: a root of each package over aggregators of each package,
  each fronting 2 scripted clients: the same ranks reach the same clients
  (aggregator seat j relays ranks ``[2j, 2j + 2)`` of a world of 4) and
  the four topologies' globals are bit-equal; the flat federation of the
  same clients agrees to f32 rounding.
- Faults: an aggregator fences a stale root and relays a cohort client's
  ``STALE_COORDINATOR`` up, which fences the root; a cohort below quorum
  or an unsynced dense cohort aborts typed and the root masks that row
  (a stopped aggregator too); aggregators join the root's gate and leave
  it when they stop.
"""

import grpc
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedtpu.core.round import flat_weighted_mean as jflat_weighted_mean
from fedtpu.transport import aggregator as jaggregator
from fedtpu.transport import sparse as jsparse
from fedtpu.transport import wire as jwire
from fedtpu_torch.transport import aggregator as taggregator
from fedtpu_torch.transport import federation as tfederation
from fedtpu_torch.transport import proto as tproto
from fedtpu_torch.transport import service as tservice
from fedtpu_torch.transport import sparse as tsparse
from fedtpu_torch.transport import wire as twire
from fedtpu_torch.ops import flat as tflat
from test_federation import free_port
from torch_coordinator import Fleet, assert_bit_equal, configs, fedtpu_primary, host_tree, model_like

# fedtpu's two-leaf surface: 40 real coordinates, padded to 128.
TEMPLATE = {
    "params": {"bias": np.zeros((8,), np.float32), "dense": np.zeros((4, 8), np.float32)},
    "batch_stats": {},
}
SIZES = [8, 32]
PADDED = 128


def dyadic_deltas(rng, n):
    """Multiples of 1/4 with max |leaf| 127/4: int8's scale is exactly 1/4."""
    out = []
    for _ in range(n):
        tree = {"params": {}, "batch_stats": {}}
        for name, leaf in TEMPLATE["params"].items():
            vals = rng.integers(-126, 127, size=leaf.shape).astype(np.float32) * np.float32(0.25)
            vals.flat[0] = np.float32(31.75)
            tree["params"][name] = vals
        out.append(tree)
    return out


BASE = {"params": {k: np.ones_like(v) for k, v in TEMPLATE["params"].items()}, "batch_stats": {}}


def encode(codec, delta, w):
    extra = {"num_examples": np.float32(w)}
    if codec == "topk":
        return jsparse.encode_topk_flat(delta, 1.0, extra=extra)[0]
    if codec == "int8":
        return jsparse.encode_int8_flat(delta, extra=extra)[0]
    if codec == "randk":
        return jsparse.encode_randk_flat(delta, 0.5, extra=extra, collect_residual=False, seed=5)[0]
    tree = {"params": {k: BASE["params"][k] + delta["params"][k] for k in BASE["params"]},
            "batch_stats": {}, "num_examples": np.float32(w)}
    return jwire.encode(tree)


def _sim_aggregators(pkg, cfg, holders):
    mod = jaggregator if pkg == "fedtpu" else taggregator
    kw = {} if pkg == "fedtpu" else {"device": "cpu"}
    out = []
    for h in holders:
        server, agg = mod.serve_aggregator(
            f"localhost:{free_port()}", cfg, template=TEMPLATE,
            cohort_source=lambda rnd, base, world, h=h: list(h["payloads"]), **kw)
        out.append((server, agg, tservice.TrainerStub(tservice.create_channel(agg.identity))))
    return out


@pytest.mark.parametrize("codec", ["dense", "int8", "topk", "randk"])
def test_two_tier_parity_bitwise(codec):
    """6 dyadic clients through their codec, two aggregators of 3 (of each
    package) and the root's single division: the flat mean's bytes."""
    rng = np.random.default_rng(7)
    deltas = dyadic_deltas(rng, 6)
    weights = [1.0, 2.0, 4.0, 8.0, 1.0, 2.0]
    payloads = [encode(codec, d, w) for d, w in zip(deltas, weights)]
    rows = np.zeros((6, PADDED), np.float32)
    like = dict(TEMPLATE, num_examples=np.zeros((), np.float32))
    for i, data in enumerate(payloads):
        if tsparse.is_sparse_payload(data):
            tsparse.decode_into_row(data, SIZES, rows[i])
        else:
            twire.decode_into_row(data, like, BASE, rows[i])
    flat = np.asarray(jflat_weighted_mean(jnp.asarray(rows), jnp.asarray(np.float32(weights))))
    assert np.abs(flat).max() > 0
    jcfg, tcfg = configs(delta_layout="flat", tier_fanout=3)
    for pkg, cfg in (("fedtpu", jcfg), ("port", tcfg)):
        holders = [{"payloads": payloads[:3]}, {"payloads": payloads[3:]}]
        aggs = _sim_aggregators(pkg, cfg, holders)
        try:
            sums = np.zeros((2, PADDED), np.float32)
            wsums = []
            for j, (_, _, stub) in enumerate(aggs):
                stub.SendModel(tproto.SendModelRequest(model=jwire.encode(BASE), epoch=1), timeout=30)
                reply = stub.SubmitPartial(tproto.SubmitPartialRequest(rank_base=3 * j, world=6, round=0,
                                                                       epoch=1), timeout=30)
                assert reply.clients == 3
                wsums.append(float(tsparse.decode_into_row(reply.record, SIZES, sums[j])["weight_sum"]))
            assert wsums == [7.0, 11.0]
            two_tier = tflat.combine_partial_rows(torch.from_numpy(sums), torch.tensor(wsums))
            assert two_tier.numpy().tobytes() == flat.tobytes(), pkg
        finally:
            for server, _, _ in aggs:
                server.stop(0)


def _topology(root_pkg, agg_pkg, fleets, jcfg, tcfg, start, rounds=2):
    """A root of ``root_pkg`` over two aggregators of ``agg_pkg``, each
    fronting one fleet; the globals after each round."""
    aggs = []
    for fleet in fleets:
        if agg_pkg == "fedtpu":
            aggs.append(jaggregator.serve_aggregator(f"localhost:{free_port()}", jcfg, clients=fleet.addrs))
        else:
            aggs.append(taggregator.serve_aggregator(f"localhost:{free_port()}", tcfg, clients=fleet.addrs,
                                                     device="cpu"))
    addrs = [a.identity for _, a in aggs]
    try:
        if root_pkg == "fedtpu":
            root = fedtpu_primary(jcfg, addrs, initial_model=start)
        else:
            root = tfederation.PrimaryServer(tcfg, addrs, initial_model=start, device="cpu")
        out = []
        for _ in range(rounds):
            rec = root.round()
            assert rec["participants"] == 2 and rec["clients_aggregated"] == 4, rec
            assert rec["world"] == 4 and rec["tier_fanout"] == 2 and rec["bytes_up_by_codec"].keys() == {"partial"}
            out.append(host_tree(root))
        return out
    finally:
        for server, agg in aggs:
            server.stop(0)


def test_mixed_topologies_match():
    jcfg, tcfg = configs(delta_layout="flat", compression="int8", tier_fanout=2)
    like = model_like(jcfg)
    fleets = [Fleet(like, n=2, codec="int8", layout="flat"), Fleet(like, n=2, codec="int8", layout="flat")]
    for k, a in enumerate(fleets[1].agents):
        a.index, a.examples = 2 + k, 8 * (3 + k)
    try:
        start = fedtpu_primary(jcfg, []).model_bytes()
        runs = {}
        for root_pkg, agg_pkg in (("fedtpu", "fedtpu"), ("port", "port"), ("fedtpu", "port"), ("port", "fedtpu")):
            for f in fleets:
                for a in f.agents:
                    a.calls.clear()
            runs[(root_pkg, agg_pkg)] = _topology(root_pkg, agg_pkg, fleets, jcfg, tcfg, start)
            ranks = [[c[1] for c in a.calls] for f in fleets for a in f.agents]
            assert ranks == [[0, 0], [1, 1], [2, 2], [3, 3]], (root_pkg, agg_pkg, ranks)
        want = runs[("fedtpu", "fedtpu")]
        for key, got in runs.items():
            for r, (g, w) in enumerate(zip(got, want)):
                assert_bit_equal(g, w, f"{key} round {r}")
        # The flat federation of the same four clients: equal to rounding.
        flat_cfg = configs(delta_layout="flat", compression="int8")[1]
        flat = tfederation.PrimaryServer(flat_cfg, [a for f in fleets for a in f.addrs], initial_model=start,
                                         device="cpu")
        for r in range(2):
            flat.round()
            for g, w in zip(twire.tree_leaves(host_tree(flat)), twire.tree_leaves(want[r])):
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)
    finally:
        for f in fleets:
            f.stop()


def test_fencing_is_relayed_across_the_tier():
    """Parent face: a SubmitPartial below the highest epoch seen is
    refused STALE_COORDINATOR. Cohort face: a client that has seen a newer
    lineage rejects the relayed epoch; the aggregator aborts the pull with
    the same text, and the root is fenced, its round voided, the client
    never marked dead."""
    jcfg, tcfg = configs(delta_layout="flat", compression="int8", tier_fanout=2)
    holder = {"payloads": [encode("int8", d, 8.0) for d in dyadic_deltas(np.random.default_rng(1), 2)]}
    (server, agg, stub), = _sim_aggregators("port", configs(delta_layout="flat", tier_fanout=2)[1], [holder])
    try:
        stub.SubmitPartial(tproto.SubmitPartialRequest(rank_base=0, world=2, round=0, epoch=2), timeout=30)
        with pytest.raises(grpc.RpcError) as err:
            stub.SubmitPartial(tproto.SubmitPartialRequest(rank_base=0, world=2, round=1, epoch=1), timeout=30)
        assert err.value.code() == grpc.StatusCode.FAILED_PRECONDITION
        assert "STALE_COORDINATOR" in err.value.details() and agg._max_epoch == 2
    finally:
        server.stop(0)
    fleet = Fleet(model_like(jcfg), n=2, codec="int8", layout="flat")
    fleet.agents[1].fence_at = 5
    server, agg = taggregator.serve_aggregator(f"localhost:{free_port()}", tcfg, clients=fleet.addrs, device="cpu")
    try:
        root = tfederation.PrimaryServer(tcfg, [agg.identity], device="cpu")
        rec = root.round()
        assert rec["aborted"] and rec["fenced"] and root._fenced and root._epoch_seen == 5
        assert root.registry.is_alive(agg.identity) and agg.registry.is_alive(fleet.addrs[1])
    finally:
        server.stop(0)
        fleet.stop()


def test_sub_quorum_and_unsynced_abort_typed():
    jcfg, tcfg = configs(delta_layout="flat", tier_fanout=2, round_quorum=1.0)
    (server, agg, stub), = _sim_aggregators("port", tcfg, [{"payloads": []}])
    try:
        with pytest.raises(grpc.RpcError) as err:
            stub.SubmitPartial(tproto.SubmitPartialRequest(rank_base=0, world=2, round=0, epoch=1), timeout=30)
        assert err.value.code() == grpc.StatusCode.FAILED_PRECONDITION
        assert err.value.details() == "SUB_QUORUM: 0/1 cohort members alive"
    finally:
        server.stop(0)
    fleet = Fleet(model_like(jcfg), n=2)
    fleet.agents[1].down = True
    _, dense_cfg = configs(delta_layout="flat", tier_fanout=2, round_quorum=1.0,
                           retry=dict(max_attempts=1, backoff_s=0.01))
    for want in ("UNSYNCED_AGGREGATOR: no global model installed yet", "SUB_QUORUM: 1/2 cohort replies < quorum 1.0"):
        server, agg = taggregator.serve_aggregator(f"localhost:{free_port()}", dense_cfg, clients=fleet.addrs,
                                                   device="cpu")
        stub = tservice.TrainerStub(tservice.create_channel(agg.identity))
        try:
            if want.startswith("SUB"):
                stub.SendModel(tproto.SendModelRequest(model=jwire.encode(model_like(jcfg)), epoch=1), timeout=30)
            with pytest.raises(grpc.RpcError) as err:
                stub.SubmitPartial(tproto.SubmitPartialRequest(rank_base=0, world=4, round=0, epoch=1), timeout=30)
            assert err.value.code() == grpc.StatusCode.FAILED_PRECONDITION and err.value.details() == want
        finally:
            server.stop(0)
    fleet.stop()


def test_root_masks_a_failed_aggregator_row():
    """One aggregator's cohort is empty (SUB_QUORUM), then one is stopped:
    both roots, fedtpu's and the port's, commit from the other with that
    row masked, and agree bit for bit."""
    jcfg, tcfg = configs(delta_layout="flat", compression="int8", tier_fanout=3, round_quorum=0.5,
                         retry=dict(max_attempts=1, backoff_s=0.01))
    like = model_like(jcfg)
    rng = np.random.default_rng(3)
    payloads = [jsparse.encode_int8_flat(jax.tree.map(lambda a: rng.normal(size=np.shape(a)).astype(np.float32)
                                                       * 1e-3, like), extra={"num_examples": np.float32(8.0)})[0]
                for _ in range(3)]
    got = {}
    for pkg in ("fedtpu", "port"):
        holders = [{"payloads": payloads}, {"payloads": []}]
        aggs = []
        for h in holders:
            if pkg == "fedtpu":
                aggs.append(jaggregator.serve_aggregator(
                    f"localhost:{free_port()}", jcfg, cohort_source=lambda r, b, w, h=h: list(h["payloads"])))
            else:
                aggs.append(taggregator.serve_aggregator(
                    f"localhost:{free_port()}", tcfg, cohort_source=lambda r, b, w, h=h: list(h["payloads"]),
                    device="cpu"))
        addrs = [a.identity for _, a in aggs]
        try:
            root = (fedtpu_primary(jcfg, addrs) if pkg == "fedtpu"
                    else tfederation.PrimaryServer(tcfg, addrs, initial_model=got["fedtpu"][0], device="cpu"))
            start = root.model_bytes()
            rec = root.round()
            assert not rec.get("aborted") and rec["world"] == 6 and rec["participants"] == 1
            assert rec["aggregated"] == 1 and rec["clients_aggregated"] == 3 and rec["alive"] == [True, False]
            first = host_tree(root)
            holders[1]["payloads"] = payloads[:2]
            root.registry.mark_alive(addrs[1])
            aggs[0][0].stop(0)
            rec = root.round()
            assert rec["participants"] == 1 and rec["clients_aggregated"] == 2 and rec["alive"] == [False, True]
            got[pkg] = (start, first, host_tree(root))
        finally:
            for server, _ in aggs:
                server.stop(0)
    assert_bit_equal(got["port"][1], got["fedtpu"][1], "masked row, round 0")
    assert_bit_equal(got["port"][2], got["fedtpu"][2], "stopped aggregator, round 1")


def test_aggregators_join_and_leave_the_root_gate():
    jcfg, tcfg = configs(delta_layout="flat", compression="int8", tier_fanout=2)
    fleets = [Fleet(model_like(jcfg), n=2, codec="int8", layout="flat") for _ in range(2)]
    root = tfederation.PrimaryServer(tcfg, [], device="cpu")
    gate = f"localhost:{free_port()}"
    root.start_gate(gate)
    aggs = []
    try:
        for f in fleets:
            aggs.append(taggregator.serve_aggregator(f"localhost:{free_port()}", tcfg, clients=f.addrs,
                                                     parent=gate, device="cpu"))
        assert root.registry.clients == [a.identity for _, a in aggs] and root.registry.version == 2
        rec = root.round()
        assert rec["participants"] == 2 and rec["clients_aggregated"] == 4
        assert aggs[1][1].status_snapshot()["last_partial"]["cohort"] == 2
        aggs[1][1].stop(0)
        assert root.registry.clients == [aggs[0][1].identity] and root.registry.version == 3
        rec = root.round()
        assert rec["participants"] == 1 and rec["clients_aggregated"] == 2 and rec["world"] == 4
    finally:
        root.stop_gate()
        for server, _ in aggs:
            server.stop(0)
        for f in fleets:
            f.stop()
