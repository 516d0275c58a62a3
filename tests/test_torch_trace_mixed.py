"""One trace across the two packages: a fedtpu primary over two port
clients, and a port primary over two fedtpu clients, on real gRPC.

fedtpu's MLP federation of ``tests/test_obs_propagation.py`` (2 clients,
2 local steps, 2 rounds, ``telemetry="trace"``), cut down. In each
direction the clients adopt the primary's ``trace_id``, each process's
export merges under ``tools/trace_merge.py --check``, and every merged
``client_train`` roots at a ``round`` in the ``primary`` lane with a
``client_rpc`` as its immediate parent.
"""

import json
import os
import sys
import warnings

import pytest

from fedtpu import config as jconfig
from fedtpu.transport import federation as jfederation
from fedtpu_torch import config as tconfig
from fedtpu_torch.transport import federation as tfederation
from test_federation import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import trace_merge  # noqa: E402


def _cfg(mod):
    return mod.RoundConfig(
        model="mlp", num_classes=10, steps_per_round=2,
        opt=mod.OptimizerConfig(learning_rate=0.05, weight_decay=0.0),
        data=mod.DataConfig(dataset="synthetic", batch_size=8, eval_batch_size=8, num_examples=64),
        fed=mod.FedConfig(num_clients=2, num_rounds=2, telemetry="trace"),
    )


def _port_clients(addrs):
    return [tfederation.serve_client(a, _cfg(tconfig), seed=i, device="cpu") for i, a in enumerate(addrs)]


def _fedtpu_clients(addrs):
    return [jfederation.serve_client(a, _cfg(jconfig), seed=i) for i, a in enumerate(addrs)]


@pytest.mark.parametrize("primary_of,clients_of", [
    (lambda addrs: jfederation.PrimaryServer(_cfg(jconfig), addrs), _port_clients),
    (lambda addrs: tfederation.PrimaryServer(_cfg(tconfig), addrs, device="cpu"), _fedtpu_clients),
], ids=["fedtpu-primary-port-clients", "port-primary-fedtpu-clients"])
@pytest.mark.filterwarnings("ignore::DeprecationWarning")
def test_one_trace_merges_across_the_packages(primary_of, clients_of, tmp_path):
    addrs = [f"localhost:{free_port()}" for _ in range(2)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        served = clients_of(addrs)
        try:
            primary = primary_of(addrs)
            recs = [primary.round() for _ in range(2)]
        finally:
            for server, _ in served:
                server.stop(0)
    assert [r["participants"] for r in recs] == [2, 2]
    coord = primary.telemetry.tracer.trace_id
    paths = [str(tmp_path / "primary.json")]
    primary.telemetry.export_trace(paths[0])
    for i, (_, agent) in enumerate(served):
        tel = agent.trainer.telemetry
        assert tel.tracer.trace_id == coord
        trains = [e for e in tel.trace_events() if e["name"] == "client_train"]
        assert len(trains) == 2
        for e in trains:
            assert e["args"]["trace_id"] == coord and e["args"]["remote_role"] == "primary"
            assert e["args"]["remote_parent"] > 0
        paths.append(str(tmp_path / f"client{i}.json"))
        tel.export_trace(paths[-1])
    merged = str(tmp_path / "merged.json")
    assert trace_merge.main(paths + ["-o", merged, "--check"]) == 0
    with open(merged) as fh:
        doc = json.load(fh)
    assert doc["metadata"]["trace_ids"] == [coord] and doc["metadata"]["merged_roles"][0] == "primary"
    index = trace_merge.span_index(doc)
    trains = [e for e in doc["traceEvents"] if e.get("name") == "client_train"]
    assert len(trains) == 4
    for e in trains:
        root = trace_merge.root_of(index, e)
        assert root["name"] == "round" and root["args"]["span_id"].startswith("primary/")
        assert index[e["args"]["parent_id"]]["name"] == "client_rpc"
