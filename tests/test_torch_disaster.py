"""Disaster recovery in the port, on the CPU: the counterparts of
``tests/test_disaster.py`` on port processes (a port ``PrimaryServer`` and
port ``serve_client``s over real gRPC on localhost), fedtpu's tiny MLP
config (2 clients, batch 8, 2 local steps).

A primary checkpoints every round while a seeded ``ckpt_rot`` rots its
newest generation; the primary is dropped (no handoff, no replica), a new
one cold-starts from the directory, falls back a generation, re-runs the
voided round through the clients' rollback and ends bit-equal to a run
that never crashed. The roster and its suspicion scores survive; a client
restarted on its ``state_dir`` sends the bytes the uninterrupted client
would; a replayed round rolls a client back, within its ring.

Across packages, fedtpu's and the port's primaries drive one fleet of
scripted clients: after the same rounds their generations (file and
manifest) are byte-equal, and each package's ``restore_from_checkpoint``
takes the other's directory.
"""

import os
import warnings

import numpy as np
import pytest
import torch

from fedtpu.checkpoint import Checkpointer as JCheckpointer
from fedtpu_torch import config as tconfig
from fedtpu_torch.checkpoint import Checkpointer
from fedtpu_torch.ft import parse_chaos_spec
from fedtpu_torch.transport import wire as twire
from fedtpu_torch.transport.federation import LocalTrainer, PrimaryServer, serve_client
from test_federation import free_port
from torch_coordinator import Fleet, assert_bit_equal, configs, fedtpu_primary, host_tree, model_like


def tiny_cfg(num_clients=2, rounds=6, **fed_kw) -> tconfig.RoundConfig:
    """fedtpu's ``tests/test_disaster.py`` config, in the port."""
    return tconfig.RoundConfig(
        model="mlp",
        num_classes=10,
        opt=tconfig.OptimizerConfig(learning_rate=0.05, weight_decay=0.0),
        data=tconfig.DataConfig(dataset="synthetic", batch_size=8, eval_batch_size=8, num_examples=128),
        fed=tconfig.FedConfig(num_clients=num_clients, num_rounds=rounds, **fed_kw),
        steps_per_round=2,
    )


def _clients(cfg, n, state_dirs=None):
    servers, addrs = [], []
    for i in range(n):
        addr = f"localhost:{free_port()}"
        server, _ = serve_client(
            addr, cfg, seed=i, device="cpu",
            state_dir=None if state_dirs is None else state_dirs[i],
        )
        servers.append(server)
        addrs.append(addr)
    return servers, addrs


def _stop(servers):
    for s in servers:
        s.stop(0)


def _params(primary):
    return {k: v.clone() for k, v in primary.params.items()}


def _equal(a, b) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


# ------------------------------------------------------------ the fast drill
@pytest.mark.parametrize("client_state", [False, True], ids=["ring", "state_dir"])
def test_cold_restart_with_generation_fallback_matches_control(tmp_path, client_state):
    """The coordinator is lost with its newest generation rotted; the
    clients survive (with a ``state_dir`` each, or their rings only). The
    recovered lineage re-runs the voided round and ends bit-equal to the
    control; the server optimizer's moments come back from disk."""
    n, rounds, crash_after = 2, 6, 5
    cfg = tiny_cfg(n, rounds, server_optimizer="momentum")
    servers, addrs = _clients(cfg, n)
    try:
        primary = PrimaryServer(cfg, addrs, device="cpu")
        lineage = [int(primary.round()["round"]) for _ in range(rounds)]
        control = _params(primary)
        control_trace = {k: v.clone() for k, v in primary._server_opt_state["trace"].items()}
    finally:
        _stop(servers)
    assert lineage == list(range(rounds))

    dirs = [str(tmp_path / f"client{i}") for i in range(n)] if client_state else None
    servers, addrs = _clients(cfg, n, dirs)
    try:
        chaos = parse_chaos_spec(f"ckpt_rot:p=1.0,rounds={crash_after - 1},max=1")
        ckpt1 = Checkpointer(str(tmp_path / "ckpt"), keep=4, chaos=chaos)
        primary1 = PrimaryServer(cfg, addrs, chaos=chaos, device="cpu")
        first = []
        for r in range(crash_after):
            first.append(int(primary1.round()["round"]))
            ckpt1.save(r, primary1.state_tree())
        assert first == list(range(crash_after))
        assert not os.path.exists(tmp_path / "ckpt" / "round_0.fckpt")  # keep=4
        del primary1  # the crash: the disk is the only copy

        primary2 = PrimaryServer(cfg, addrs, device="cpu")
        start = primary2.restore_from_checkpoint(Checkpointer(str(tmp_path / "ckpt"), keep=4))
        assert start == crash_after - 1  # generation 4 rotted: 3 restores
        assert primary2._round_counter == start
        second = []
        for _ in range(rounds - start):
            rec = primary2.round()
            second.append(int(rec["round"]))
            assert rec["participants"] == n
        assert [r for r in first if r < start] + second == list(range(rounds))
        assert _equal(_params(primary2), control)
        assert _equal(primary2._server_opt_state["trace"], control_trace)
    finally:
        _stop(servers)
    if client_state:
        for d in dirs:
            assert sorted(os.listdir(d))[-2:] == ["round_6.fckpt", "round_6.fckpt.manifest.json"]


def test_cold_restart_all_generations_corrupt_raises(tmp_path):
    cfg = tiny_cfg(2, 2)
    primary = PrimaryServer(cfg, [], device="cpu")
    ckpt = Checkpointer(str(tmp_path), keep=3)
    ckpt.save(0, primary.state_tree())
    path = tmp_path / "round_0.fckpt"
    data = bytearray(path.read_bytes())
    data[-3] ^= 0x55
    path.write_bytes(bytes(data))
    with pytest.raises(twire.WireError, match="checkpoint generations"):
        PrimaryServer(cfg, [], device="cpu").restore_from_checkpoint(Checkpointer(str(tmp_path)))
    assert PrimaryServer(cfg, [], device="cpu").restore_from_checkpoint(
        Checkpointer(str(tmp_path / "empty"))) is None


def test_membership_and_reputation_survive_cold_restart(tmp_path):
    cfg = tiny_cfg(2, 4)
    servers, addrs = _clients(cfg, 3)
    try:
        static, joiner = addrs[:2], addrs[2]
        primary1 = PrimaryServer(cfg, static, device="cpu")
        out = primary1.admit_client(joiner)
        assert out["admitted"] and out["resynced"]
        version1 = primary1.registry.version
        primary1.registry.observe_screening(joiner, True, ewma=0.5)
        suspicion1 = primary1.registry.suspicion(joiner)
        assert suspicion1 > 0
        primary1.round()
        Checkpointer(str(tmp_path), keep=3).save(0, primary1.state_tree())
        del primary1

        primary2 = PrimaryServer(cfg, static, device="cpu")
        assert primary2.restore_from_checkpoint(Checkpointer(str(tmp_path))) == 1
        assert primary2.registry.is_member(joiner)
        assert primary2.registry.version == version1
        assert primary2.registry.suspicion(joiner) == pytest.approx(suspicion1)
        assert primary2.round()["participants"] == 3  # the adopted roster is dialable
    finally:
        _stop(servers)


def test_older_layouts_and_a_model_only_generation_restore(tmp_path):
    """The template ladder: a generation without the roster and epoch (an
    older coordinator's) keeps the startup roster; a model-only one takes
    its counter from the generation's index."""
    cfg = tiny_cfg(2, 2, server_optimizer="momentum")
    primary = PrimaryServer(cfg, [], device="cpu")
    tree = primary.state_tree()
    tree["round_counter"] = np.asarray(7, np.int64)
    old = {k: v for k, v in tree.items() if k not in ("membership", "coord_epoch")}
    Checkpointer(str(tmp_path / "old")).save(6, old)
    fresh = PrimaryServer(cfg, [], device="cpu")
    assert fresh.restore_from_checkpoint(Checkpointer(str(tmp_path / "old"))) == 7
    assert fresh._round_counter == 7
    model_only = {"params": tree["params"], "batch_stats": tree["batch_stats"]}
    Checkpointer(str(tmp_path / "model")).save(4, model_only)
    fresh = PrimaryServer(cfg, [], device="cpu")
    assert fresh.restore_from_checkpoint(Checkpointer(str(tmp_path / "model"))) == 5
    assert fresh._round_counter == 5


# ----------------------------------------------------- client-side durability
def test_client_state_dir_restart_resumes_bit_identically(tmp_path):
    cfg = tiny_cfg(1, 8, compression="topk", topk_fraction=0.05)
    state_dir = str(tmp_path / "client_state")

    def fresh(state_dir_=None):
        return LocalTrainer(cfg, seed=0, state_dir=state_dir_, device="cpu")

    proto_trainer = fresh()
    global_payload = twire.encode(proto_trainer.host_model())

    def run_rounds(trainer, k):
        out = None
        for _ in range(k):
            trainer.set_global(global_payload)
            out = trainer.train_round(0, 1)
        return out

    control_payload = run_rounds(fresh(), 3)
    t1 = fresh(state_dir)
    run_rounds(t1, 2)
    assert t1.edge_residual is not None
    del t1  # the process dies
    t2 = fresh(state_dir)
    assert t2.round_idx == 2 and t2.edge_residual is not None
    assert run_rounds(t2, 1) == control_payload
    # A restart without state_dir diverges: the hazard the option closes.
    t3 = fresh()
    run_rounds(t3, 2)
    assert run_rounds(fresh(), 1) != control_payload


def test_client_rollback_on_coordinator_replay():
    cfg = tiny_cfg(1, 8)
    t = LocalTrainer(cfg, seed=0, device="cpu")
    payloads = {r: t.train_round(0, 1, coord_round=r) for r in range(4)}
    assert t.round_idx == 4
    assert t.train_round(0, 1, coord_round=2) == payloads[2]
    assert t.round_idx == 3
    assert t.train_round(0, 1, coord_round=3) == payloads[3]
    before = t.round_idx
    t.train_round(0, 1, coord_round=before + 5)  # ahead: no rollback
    assert t.round_idx == before + 1


@pytest.mark.parametrize("state_dir", [False, True], ids=["ring", "disk"])
def test_client_rollback_depth_is_ring_bounded(tmp_path, state_dir):
    """A replay deeper than the ring has no snapshot: the client trains
    forward. A client restarted on its ``state_dir`` seeds its ring with
    its newest cut only; an older round still on disk (keep 3) takes it
    back, a pruned one does not."""
    cfg = tiny_cfg(1, 16)
    d = str(tmp_path) if state_dir else None
    t = LocalTrainer(cfg, seed=0, device="cpu", state_dir=d)
    for r in range(8):
        t.train_round(0, 1, coord_round=r)
    target = 8 - LocalTrainer.SNAPSHOT_KEEP - 1
    assert not t._rollback(target)
    t.train_round(0, 1, coord_round=target)  # no raise: forward training
    assert t.round_idx == 9
    if state_dir:
        restarted = LocalTrainer(cfg, seed=0, device="cpu", state_dir=d)
        assert restarted.round_idx == 9 and sorted(restarted._snapshots) == [9]
        assert not restarted._rollback(6)  # pruned from the disk too
        assert restarted._rollback(8)  # read back from generation 8
        assert restarted.round_idx == 8 and not restarted._snapshots


# ------------------------------------------------------------ across packages
def test_primary_generations_are_fedtpus_bytes_and_cross_restore(tmp_path):
    """fedtpu's primary and the port's drive one scripted fleet from the
    same start for 2 rounds, saving each round: the generations are
    byte-equal, and each package's cold start takes the other's
    directory."""
    jcfg, tcfg = configs(compression="topk", server_optimizer="momentum", server_lr=0.3)
    like = model_like(jcfg)
    fleet = Fleet(like, codec="topk")
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jp = fedtpu_primary(jcfg, fleet.addrs)
        start = jp.model_bytes()
        jck = JCheckpointer(jdir, keep=3, backend="wire")
        for r in range(2):
            jp.round()
            jck.save(r, jp.state_tree())
        tp = PrimaryServer(tcfg, fleet.addrs, initial_model=start, device="cpu")
        tck = Checkpointer(tdir, keep=3)
        for r in range(2):
            tp.round()
            tck.save(r, tp.state_tree())
        for name in ("round_1.fckpt", "round_1.fckpt.manifest.json"):
            assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name

        t2 = PrimaryServer(tcfg, fleet.addrs, device="cpu")
        assert t2.restore_from_checkpoint(Checkpointer(jdir)) == 2
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            j2 = fedtpu_primary(jcfg, fleet.addrs)
        assert j2.restore_from_checkpoint(JCheckpointer(tdir, backend="wire")) == 2
        assert_bit_equal(host_tree(t2), host_tree(jp), "port restored from fedtpu's directory")
        assert_bit_equal(host_tree(j2), host_tree(tp), "fedtpu restored from the port's directory")
        assert t2._round_counter == j2._round_counter == 2
        assert t2.replica_bytes() == j2.replica_bytes()
    finally:
        fleet.stop()
