"""The port's ``PrimaryServer.run_async`` (FedBuff over the gRPC edge)
against fedtpu's, on the CPU.

- the guards refuse compression, robust aggregators, DP, screening and a
  buffer below 1 with fedtpu's messages;
- the FedBuff apply (``aggregation.fedbuff_apply``) is fedtpu's arithmetic
  in ``run_async`` (the discounted weights in Python floats, the damping
  factor in f32 with each product cast back to its leaf's dtype, then
  ``PrimaryServer._aggregate``) on the same buffer, bit for bit: damped
  and undamped, FedAvg and server momentum, with bf16 leaves in the buffer;
- a port primary with a fast and a slow port client keeps fedtpu's
  invariants (``tests/test_async.py``): no barrier, the fast client carries
  most updates, the versions climb, the staleness is recorded, and the
  final sync leaves every client on the primary's model;
- below ``round_quorum`` of the membership the buffered update is held and
  the global model untouched.
"""

import time
import warnings

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from fedtpu import config as jconfig
from fedtpu.transport import federation as jfederation
from fedtpu_torch import config as tconfig
from fedtpu_torch.convert import from_flax, to_flax
from fedtpu_torch.transport import aggregation
from fedtpu_torch.transport import federation as tfederation
from fedtpu_torch.transport.service import create_server
from test_federation import free_port
from torch_coordinator import configs


def tiny_cfg(mod, **fed_kw):
    """fedtpu's ``tests/test_async.py`` config: mlp, 2 clients, batch 8,
    256 synthetic examples, 2 steps."""
    fed_kw.setdefault("num_clients", 2)
    return mod.RoundConfig(
        model="mlp",
        num_classes=10,
        opt=mod.OptimizerConfig(learning_rate=0.05, weight_decay=0.0),
        data=mod.DataConfig(dataset="synthetic", batch_size=8, eval_batch_size=8, num_examples=256),
        fed=mod.FedConfig(**fed_kw),
        steps_per_round=2,
    )


def test_guards_raise_fedtpus_messages():
    cases = [
        (dict(compression="topk"), {}),
        (dict(aggregator="median"), {}),
        (dict(weighted=False, dp_clip_norm=0.1), {}),
        ({}, dict(buffer_k=0)),
    ]
    for fed_kw, call_kw in cases:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jp = jfederation.PrimaryServer(tiny_cfg(jconfig, **fed_kw), clients=[], seed=0)
        tp = tfederation.PrimaryServer(tiny_cfg(tconfig, **fed_kw), clients=[], device="cpu")
        with pytest.raises(ValueError) as want:
            jp.run_async(1, **call_kw)
        with pytest.raises(ValueError) as got:
            tp.run_async(1, **call_kw)
        assert str(got.value) == str(want.value)
    _, screened = configs(screen=dict(norm_max=5.0))
    with pytest.raises(ValueError, match="run_async does not support update screening"):
        tfederation.PrimaryServer(screened, [], device="cpu").run_async(1)


# --------------------------------------------------------- the FedBuff apply
def fedtpu_apply(jp, deltas, raw, stalenesses, power, damping, version):
    """fedtpu's update of ``run_async`` on a buffer, verbatim but for the
    threads (``fedtpu/transport/federation.py``'s ``async_update``)."""
    disc = [w / (1.0 + s) ** power for w, s in zip(raw, stalenesses)]
    weights = jnp.asarray(disc, jnp.float32)
    stacked = jax.tree.map(lambda *leaves: jnp.stack(leaves), *deltas)
    if damping:
        damp = jnp.asarray(sum(disc) / max(sum(raw), 1e-9), jnp.float32)
        stacked = jax.tree.map(lambda l: (l.astype(jnp.float32) * damp).astype(l.dtype), stacked)
    new_global, jp._server_opt_state = jp._aggregate(
        {"params": jp.params, "batch_stats": jp.batch_stats}, stacked, weights, jp._server_opt_state,
        jnp.asarray(version, jnp.int32),
    )
    jp.params, jp.batch_stats = new_global["params"], new_global["batch_stats"]
    return jax.tree.map(np.asarray, new_global)


@pytest.mark.parametrize("server_optimizer", ["none", "momentum"])
@pytest.mark.parametrize("damping", [True, False])
def test_fedbuff_apply_is_fedtpus_arithmetic_bit_for_bit(server_optimizer, damping):
    jcfg, tcfg = configs(server_optimizer=server_optimizer, server_lr=0.7)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jp = jfederation.PrimaryServer(jcfg, [], seed=0)
    tp = tfederation.PrimaryServer(tcfg, [], initial_model=jp.model_bytes(), device="cpu")
    template = jax.tree.map(np.asarray, {"params": jp.params, "batch_stats": jp.batch_stats})
    rng = np.random.default_rng(5)
    for v, (k, power) in enumerate([(3, 0.5), (2, 0.3), (4, 1.0)]):
        deltas = [jax.tree.map(lambda a: (0.01 * rng.normal(size=a.shape)).astype(np.float32), template)
                  for _ in range(k)]
        if v == 1:
            # A buffer of narrow leaves: damping's f32 product is cast back.
            for d in deltas:
                d["params"]["Dense_1"]["kernel"] = d["params"]["Dense_1"]["kernel"].astype(ml_dtypes.bfloat16)
        raw = [float(n) for n in rng.integers(8, 64, k)]
        stalenesses = [int(s) for s in rng.integers(0, 6, k)]
        want = fedtpu_apply(jp, deltas, raw, stalenesses, power, damping, v)
        stacked = {col: from_flax(jax.tree.map(lambda *ls: np.stack(ls), *[d[col] for d in deltas]))
                   for col in ("params", "batch_stats")}
        if v == 1:
            assert stacked["params"]["Dense_1.weight"].dtype == torch.bfloat16
        new, tp._server_opt_state = aggregation.fedbuff_apply(
            tcfg, tp.global_tree, stacked, raw, stalenesses, power, damping, tp._server_opt_state, v,
            server=tp._server_opt,
        )
        tp.global_tree = new
        got = {col: to_flax(new[col]) for col in new}
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want), strict=True):
            np.testing.assert_array_equal(np.asarray(a).view(np.int32), np.asarray(b).view(np.int32),
                                          err_msg=f"update {v}")


# ------------------------------------------------------------- the loop
class _SlowAgent(tfederation.ClientAgent):
    """A client whose every StartTrain after the first sleeps."""

    delay = 2.0

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.calls = 0

    def StartTrain(self, request, context):
        self.calls += 1
        if self.calls > 1:
            time.sleep(self.delay)
        return super().StartTrain(request, context)


def _fleet(cfg, classes):
    addrs, servers, agents = [], [], []
    for seed, cls in enumerate(classes):
        addr = f"localhost:{free_port()}"
        agent = cls(cfg, seed=seed, device="cpu")
        agent.trainer.identity = addr
        server = create_server(addr, agent)
        server.start()
        addrs.append(addr)
        servers.append(server)
        agents.append(agent)
    return addrs, servers, agents


def test_async_progresses_on_the_fast_client_and_discounts_the_stale():
    cfg = tiny_cfg(tconfig, async_poll_s=0.2)
    addrs, servers, agents = _fleet(cfg, (tfederation.ClientAgent, _SlowAgent))
    try:
        primary = tfederation.PrimaryServer(cfg, addrs, device="cpu")
        seen = []
        history = primary.run_async(num_updates=6, buffer_k=1, staleness_power=0.5,
                                    on_update=lambda v, rec: seen.append(v))
        assert len(history) >= 6 and seen == [rec["update"] for rec in history]
        assert [rec["update"] for rec in history] == list(range(1, len(history) + 1))
        # No barrier: the fast client carries updates while the slow one
        # sleeps (held by counts, not by the wall clock, which a loaded
        # host stretches).
        contributors = [c for rec in history for c in rec["contributors"]]
        assert contributors.count(addrs[0]) >= 3, contributors
        assert contributors.count(addrs[1]) < contributors.count(addrs[0]), contributors
        assert all(s >= 0 for rec in history for s in rec["staleness"])
        assert all(rec["alive"] == [True, True] for rec in history)
        assert primary._round_counter == len(history)
        snap = primary.telemetry.registry.snapshot()
        assert snap["fedtpu_async_updates_total"][0]["value"] == len(history)
        assert snap["fedtpu_rpc_bytes_up_total"][0]["value"] > 0
        # The final sync: every client holds the primary's model.
        want = primary._host_model()
        for a in agents:
            got = a.trainer.host_model()
            for x, y in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want), strict=True):
                np.testing.assert_array_equal(x, y)
        assert agents[0].last_eval is not None
        # The staleness histogram holds every record's staleness, bucket
        # by bucket, at fedtpu's bounds.
        stale = [s for rec in history for s in rec["staleness"]]
        (hist,) = snap["fedtpu_async_staleness"]
        bounds = (0, 1, 2, 4, 8, 16, 32, 64)
        assert hist["count"] == len(stale) and hist["sum"] == sum(stale)
        assert hist["buckets"] == {float(b): sum(s <= b for s in stale) for b in bounds}
        assert [e["update"] for e in primary.flight.snapshot() if e["kind"] == "async_update"] == seen
    finally:
        for s in servers:
            s.stop(0)


def test_below_quorum_the_update_is_held_and_the_global_untouched():
    cfg = tiny_cfg(tconfig, round_quorum=1.0, async_poll_s=0.2, ft_heartbeat_period_s=0.5)
    addrs, servers, agents = _fleet(cfg, (tfederation.ClientAgent, tfederation.ClientAgent))
    servers[1].stop(0)  # a member that stays dead: the quorum of 2 is never met
    try:
        primary = tfederation.PrimaryServer(cfg, addrs, device="cpu")
        primary.registry.mark_failed(addrs[1])
        before = primary._host_model()
        t_end = time.monotonic() + 3.0
        history = primary.run_async(num_updates=2, buffer_k=1, stop=lambda: time.monotonic() > t_end)
        assert history == [] and primary._async_version == 0 and primary._round_counter == 0
        assert primary.telemetry.registry.snapshot()["fedtpu_round_aborts_total"][0]["value"] >= 1
        after = primary._host_model()
        for x, y in zip(jax.tree_util.tree_leaves(after), jax.tree_util.tree_leaves(before), strict=True):
            np.testing.assert_array_equal(x, y)
    finally:
        for s in servers:
            s.stop(0)
