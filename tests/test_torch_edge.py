"""The port's side of the gRPC edge against fedtpu's, on the CPU.

- ``LocalTrainer``: the port's and fedtpu's trainers from the same weights
  (the dense first reply) and the same synced global model, a round per
  codec, replies decoded and held within the slices' tolerance
  (``atol=1e-5, rtol=1e-4``; for a lossy codec at most 0.1% of coordinates
  beyond it, since a 1e-7 difference of training can cross a top-k
  threshold or a rounding step); ``num_examples`` and the shard equal.
- The rollback ring: a replayed round re-encodes the first run's bytes.
- Fencing over real gRPC: a stale coordinator epoch is aborted with
  ``FAILED_PRECONDITION``.
- The coordinator's math (``aggregate``, ``finalize_stream``,
  ``finalize_partial``, the partial rows) against the programs fedtpu's
  ``PrimaryServer`` jits, on the same inputs: bit-equal for the mean,
  the median and the trimmed mean, Krum's choice equal; the 2-tier mean
  bit-identical to the flat one where the f32 adds are exact.
- A localhost federation: fedtpu's ``PrimaryServer`` driving one fedtpu
  client and one fedtpu_torch client, against an all-fedtpu federation with
  the same seeds.

The runs use a learning rate of 0.01. rotq quantizes the rotated delta
with stochastic rounding, so a 1e-7 difference of training can move one
code of 2^20 by a step, and that moves every coordinate of the client's
row by ``scale / sqrt(h)``: at 0.05, four codes move in the first round,
each by 6e-6, and the federations part by more than the tolerance from
then on; at 0.01 the step is 7e-7 and no code moves in the first round.
A later round of rotq still parts (the next round trains from globals a
code apart), so the rotq federation is held through round 1, as the flat
slice's rotq round is held for one round.
"""

import functools
import warnings

import grpc
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedtpu import config as jconfig
from fedtpu import native
from fedtpu.core import round as jround
from fedtpu.core import server_opt as jserver_opt
from fedtpu.ops import flat as jflat
from fedtpu.transport import federation as jfederation
from fedtpu.transport import service as jservice
from fedtpu.transport import sparse as jsparse
from fedtpu.transport import wire as jwire
from fedtpu_torch import config as tconfig
from fedtpu_torch.convert import from_flax, to_flax
from fedtpu_torch.core import round as tround
from fedtpu_torch.core import server_opt as tserver_opt
from fedtpu_torch.data import datasets as tdatasets
from fedtpu_torch.ops import flat as tflat
from fedtpu_torch.transport import aggregation
from fedtpu_torch.transport import federation as tfederation
from fedtpu_torch.transport import proto as tproto
from fedtpu_torch.transport import retry as tretry
from fedtpu_torch.transport import service as tservice
from fedtpu_torch.transport import trainer as ttrainer
from test_federation import free_port

ATOL, RTOL = 1e-5, 1e-4


@pytest.fixture(scope="module", autouse=True)
def shared_loads():
    """fedtpu's trainers load the dataset once for the module (the loader
    is deterministic; each trainer would otherwise draw the synthetic
    CIFAR-10 again), and its native codec is loaded."""
    assert native.ensure_built()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfederation, "load", functools.lru_cache(maxsize=None)(jfederation.load))
        yield


@pytest.fixture(scope="module")
def port_data():
    return (tdatasets.load("cifar10", "train", seed=0, num=64),
            tdatasets.load("cifar10", "test", seed=0, num=64))


def configs(**fed_kw):
    """smallcnn on CIFAR-10's synthetic fallback, 64 examples, iid, batch
    8 (4 steps a round for each of 2 clients), no augmentation."""
    def build(mod):
        return mod.RoundConfig(
            model="smallcnn",
            opt=mod.OptimizerConfig(learning_rate=0.01),
            data=mod.DataConfig(dataset="cifar10", batch_size=8, eval_batch_size=16,
                                partition="iid", augment=False, num_examples=64),
            fed=mod.FedConfig(**{"num_clients": 2, "topk_fraction": 0.1, **fed_kw}),
        )

    return build(jconfig), build(tconfig)


def _beyond(got, want) -> int:
    return int((~np.isclose(got, want, atol=ATOL, rtol=RTOL)).sum())


def _hold(got_tree, want_tree, lossy: bool, what: str) -> None:
    got = jax.tree_util.tree_leaves(got_tree)
    want = jax.tree_util.tree_leaves(want_tree)
    assert [np.shape(a) for a in got] == [np.shape(a) for a in want], what
    bad = sum(_beyond(np.asarray(a), np.asarray(b)) for a, b in zip(got, want))
    total = sum(np.size(b) for b in want)
    assert bad <= (0.001 * total if lossy else 0), f"{what}: {bad} of {total} coordinates differ"


def _model_like(jt):
    return {"params": jax.tree.map(np.asarray, jt.params), "batch_stats": jax.tree.map(np.asarray, jt.batch_stats)}


def _decode_reply(data, like):
    """A reply as ``(model tree or delta tree, num_examples)``."""
    if jsparse.is_sparse_payload(data):
        delta, extra = jsparse.decode(data, like)
        return delta, float(extra["num_examples"])
    tree = jwire.decode(data, dict(like, num_examples=np.zeros((), np.float32)))
    return {k: tree[k] for k in like}, float(tree["num_examples"])


def _trainers(jcfg, tcfg, port_data):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jt = jfederation.LocalTrainer(jcfg, seed=0)
    tt = ttrainer.LocalTrainer(tcfg, seed=0, device="cpu", data=port_data[0], eval_data=port_data[1])
    return jt, tt


# ----------------------------------------------------------------- trainer


@pytest.mark.parametrize("layout,codec,chain", [
    ("per_leaf", "topk", [None, "int8", "none", "topk", "none"]),
    ("flat", "rotq", [None, "topk", "int8", "randk", "none"]),
])
def test_trainer_tracks_fedtpu_for_every_codec(port_data, layout, codec, chain):
    """From the same weights, the dense first reply (unsynced; zlib, since
    a codec is configured); then, from one synced global model, a round per
    codec (``None`` the configured one, the others as a coordinator's
    per-round choice), the error-feedback residual carried through the
    switches and flushed by ``none``."""
    jcfg, tcfg = configs(compression=codec, delta_layout=layout)
    jt, tt = _trainers(jcfg, tcfg, port_data)
    np.testing.assert_array_equal(tt._shard(1, 2)[0], jt._shard(1, 2)[0])
    tt.params = from_flax(jax.tree.map(np.asarray, jt.params))
    like = _model_like(jt)
    a, b = jt.train_round(1, 2), tt.train_round(1, 2)
    sent = [len(b)]
    assert not jsparse.is_sparse_payload(b) and b[5] == a[5] == 1  # zlib flag
    (got, n_got), (want, n_want) = _decode_reply(b, like), _decode_reply(a, like)
    assert n_got == n_want == 32.0
    _hold(got, want, False, "dense first reply")
    g = jwire.encode(_model_like(jt))
    jt.set_global(g)
    tt.set_global(g)
    assert tt.synced and jt.synced
    for r, override in enumerate(chain):
        # A dense reply after a lossy round carries the flushed residual,
        # which the lossy rule holds.
        lossy = (override or codec) != "none" or jt.edge_residual is not None
        a = jt.train_round(1, 2, codec_override=override)
        b = tt.train_round(1, 2, codec_override=override)
        sent.append(len(b))
        assert b[:4] == a[:4], (r, override)
        (got, n_got), (want, n_want) = _decode_reply(b, like), _decode_reply(a, like)
        assert n_got == n_want == 32.0
        _hold(got, want, lossy, f"round {r} ({override or codec})")
        if jt.edge_residual is None:
            assert tt.edge_residual is None
        else:
            _hold(tt.edge_residual, jt.edge_residual, True, f"round {r} residual")
    assert tt.round_idx == jt.round_idx == len(chain) + 1
    assert tt.tx_bytes == sum(sent) and tt.rx_bytes == len(g)  # telemetry="basic"
    _hold(to_flax(tt.params), jax.tree.map(np.asarray, jt.params), False, "final weights")
    le, ae = tt.evaluate()
    lj, aj = jt.evaluate()
    np.testing.assert_allclose(le, lj, rtol=1e-5)
    assert ae == aj


def test_replayed_round_rolls_back_and_reencodes(port_data):
    """A StartTrain whose lineage round is behind the local counter rolls
    the state back to that round's snapshot (weights, momentum, residual,
    the augmentation generator), and the replayed round's reply is the
    first run's, byte for byte; a round older than the ring trains on."""
    _, tcfg = configs(compression="rotq", delta_layout="flat")
    tcfg = tcfg.__class__(**{**tcfg.__dict__, "data": tcfg.data.__class__(
        **{**tcfg.data.__dict__, "augment": True})})
    tt = ttrainer.LocalTrainer(tcfg, seed=3, device="cpu", data=port_data[0], eval_data=port_data[1])
    tt.set_global(jwire.encode(tt.host_model()))
    first = [tt.train_round(0, 2) for _ in range(6)]
    assert tt.round_idx == 6 and sorted(tt._snapshots) == [2, 3, 4, 5]
    assert tt.train_round(0, 2, coord_round=4) == first[4]
    assert tt.round_idx == 5 and sorted(tt._snapshots) == [2, 3, 4]
    assert tt.train_round(0, 2) == first[5]
    tt.train_round(0, 2, coord_round=1)  # behind the ring: trains forward
    assert tt.round_idx == 7


# ---------------------------------------------------------------- service


def test_stale_coordinator_is_fenced_over_grpc(port_data):
    _, tcfg = configs(compression="topk")
    addr = f"localhost:{free_port()}"
    server, agent = tfederation.serve_client(
        addr, tcfg, seed=0, device="cpu", data=port_data[0], eval_data=port_data[1])
    try:
        for stub in (tservice.TrainerStub(tservice.create_channel(addr)),
                     jservice.TrainerStub(jservice.create_channel(addr))):
            assert stub.HeartBeat(tproto.Request(), timeout=30).status == 1
        stub = tservice.TrainerStub(tservice.create_channel(addr))
        g = jwire.encode(agent.trainer.host_model())
        reply = stub.SendModel(tproto.SendModelRequest(model=g, epoch=3, role=1), timeout=60)
        assert reply.reply == f"{agent.last_eval[1]:.4f}".encode()
        with pytest.raises(grpc.RpcError) as exc:
            stub.StartTrain(tproto.TrainRequest(rank=0, world=2, round=0, epoch=2), timeout=60)
        assert exc.value.code() == grpc.StatusCode.FAILED_PRECONDITION
        assert exc.value.details().startswith("STALE_COORDINATOR: epoch 2 < 3")
        assert tretry.is_stale_coordinator(exc.value)
        assert agent.stale_rejected == {"StartTrain": 1} and agent.trainer.round_idx == 0
        ok = stub.StartTrain(tproto.TrainRequest(rank=0, world=2, round=0, epoch=4), timeout=60)
        assert jsparse.is_sparse_payload(ok.message)  # synced: a top-k record
        ok = stub.StartTrain(tproto.TrainRequest(rank=0, world=2, round=1), timeout=60)  # no epoch
        assert agent.trainer.round_idx == 2
        with pytest.raises(grpc.RpcError) as exc:
            stub.SendModel(tproto.SendModelRequest(model=g, epoch=1), timeout=60)
        assert exc.value.code() == grpc.StatusCode.FAILED_PRECONDITION
        with pytest.raises(grpc.RpcError) as exc:
            stub.FetchModel(tproto.Request(), timeout=30)
        assert exc.value.code() == grpc.StatusCode.UNIMPLEMENTED
    finally:
        server.stop(0)


def test_options_the_edge_does_not_run_raise(port_data, tmp_path):
    _, tcfg = configs()
    kw = dict(device="cpu", data=port_data[0], eval_data=port_data[1])
    # state_dir runs since slice 8 part 1 (tests/test_torch_disaster.py):
    # an empty directory starts a fresh client.
    assert ttrainer.LocalTrainer(tcfg, state_dir=str(tmp_path / "state"), **kw).round_idx == 0
    trace = tcfg.__class__(**{**tcfg.__dict__, "fed": tcfg.fed.__class__(**{**tcfg.fed.__dict__, "telemetry": "trace"})})
    with pytest.raises(NotImplementedError, match="slice 8"):
        ttrainer.LocalTrainer(trace, **kw)
    with pytest.raises(NotImplementedError, match="slice 8"):
        tservice.create_channel("localhost:1", trace_source=lambda: None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ttrainer.LocalTrainer(tcfg, data=port_data[0], eval_data=port_data[1])


def test_edge_config_validators_match_fedtpu():
    for fed_kw in (dict(), dict(delta_layout="flat"), dict(aggregator="median"),
                   dict(server_pipeline="barrier", delta_layout="flat")):
        j, t = jconfig.FedConfig(**fed_kw), tconfig.FedConfig(**fed_kw)
        assert tconfig.resolve_server_pipeline(t) == jconfig.resolve_server_pipeline(j)
    for fed_kw in (dict(server_pipeline="stream", aggregator="krum"), dict(server_pipeline="nope"),
                   dict(tier_fanout=2), dict(tier_fanout=2, delta_layout="flat", dp_clip_norm=1.0)):
        with pytest.raises(ValueError) as want:
            jconfig.validate_tier_config(jconfig.FedConfig(**fed_kw), "root") if "tier_fanout" in fed_kw \
                else jconfig.resolve_server_pipeline(jconfig.FedConfig(**fed_kw))
        with pytest.raises(ValueError) as got:
            tconfig.validate_tier_config(tconfig.FedConfig(**fed_kw), "root") if "tier_fanout" in fed_kw \
                else tconfig.resolve_server_pipeline(tconfig.FedConfig(**fed_kw))
        assert str(got.value) == str(want.value)
    for rp in (dict(max_attempts=0), dict(backoff_multiplier=0.5), dict(jitter=2.0)):
        with pytest.raises(ValueError) as want:
            jconfig.validate_retry_policy(jconfig.RetryPolicy(**rp))
        with pytest.raises(ValueError) as got:
            tconfig.validate_retry_policy(tconfig.RetryPolicy(**rp))
        assert str(got.value) == str(want.value)
    assert tconfig.RetryPolicy() .__dict__ == jconfig.RetryPolicy().__dict__


# ------------------------------------------------------------ server math


def _synthetic_tree(rng, n=None):
    """A small ``{"params", "batch_stats"}`` flax tree (stacked ``[n, ...]``
    when ``n`` is given), values well inside f32."""
    lead = () if n is None else (n,)
    f = lambda *s: rng.normal(size=lead + s).astype(np.float32)
    return {
        "params": {"Conv_0": {"kernel": f(3, 3, 3, 8), "bias": f(8)}, "Dense_0": {"kernel": f(40, 10), "bias": f(10)}},
        "batch_stats": {"BatchNorm_0": {"mean": f(8), "var": np.abs(f(8))}},
    }


def _to_port(tree, device="cpu"):
    return {k: from_flax(v, device=torch.device(device)) for k, v in tree.items()}


def _to_flax(tree):
    return {k: to_flax(v) for k, v in tree.items()}


def _bits(tree):
    return [np.asarray(a, np.float32).view(np.int32) for a in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("case", [
    dict(aggregator="mean"),
    dict(aggregator="mean", weighted=False, server_optimizer="momentum"),
    dict(aggregator="median"),
    dict(aggregator="trimmed_mean", trim_fraction=0.2),
    dict(aggregator="krum", trim_fraction=0.2),
])
@pytest.mark.parametrize("n", [4, 5])
def test_aggregate_equals_fedtpu(case, n):
    rng = np.random.default_rng(n)
    jcfg, tcfg = configs(**case)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        primary = jfederation.PrimaryServer(jcfg, [])
    g = _synthetic_tree(rng)
    d = _synthetic_tree(rng, n)
    if case["aggregator"] == "krum":  # one outlier, far from the rest
        d["params"]["Dense_0"]["kernel"][1] += 50.0
    w = rng.integers(1, 60, size=n).astype(np.float32)
    opt_j = jserver_opt.init(jcfg.fed, g["params"])
    want, _ = primary._aggregate(g, d, jnp.asarray(w), opt_j, jnp.int32(3))
    tg = _to_port(g)
    server = tserver_opt.make_server_optimizer(tcfg.fed)
    got, _ = aggregation.aggregate(tcfg, tg, _to_port(d), torch.from_numpy(w), tserver_opt.init(server, tg["params"]), 3)
    got = _to_flax(got)
    for a, b in zip(_bits(got), _bits(jax.tree.map(np.asarray, want))):
        np.testing.assert_array_equal(a, b)


def test_aggregate_with_dp_matches_fedtpu_given_its_noise():
    """DP with fedtpu's noise draws injected, within 1e-6: the clip norms
    are sums of squares over each leaf's inner axes, whose order XLA picks
    (its vectorized reduce), so a norm can differ from the port's in its
    last bit."""
    rng = np.random.default_rng(9)
    jcfg, tcfg = configs(weighted=False, dp_clip_norm=1.5, dp_noise_multiplier=0.7)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        primary = jfederation.PrimaryServer(jcfg, [])
    g = _synthetic_tree(rng)
    g["batch_stats"] = {}
    d = _synthetic_tree(rng, 4)
    d["batch_stats"] = {}
    w = np.ones(4, np.float32)
    want, _ = primary._aggregate(g, d, jnp.asarray(w), (), jnp.int32(5))
    leaves, treedef = jax.tree_util.tree_flatten(g["params"])
    base = jax.random.fold_in(jax.random.PRNGKey(jcfg.data.seed ^ 0x5F5E5F), jnp.int32(5))
    keys = jax.random.split(base, len(leaves))
    normals = jax.tree_util.tree_unflatten(
        treedef, [np.asarray(jax.random.normal(k, x.shape, jnp.float32)) for k, x in zip(keys, leaves)])
    got, _ = aggregation.aggregate(tcfg, _to_port(g), _to_port(d), torch.from_numpy(w), (), 5,
                                   dp_normals=from_flax(normals))
    for a, b in zip(jax.tree_util.tree_leaves(_to_flax(got)), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-6)
    tg = _to_port(_synthetic_tree(rng))
    with pytest.raises(ValueError, match="BatchNorm"):
        aggregation.aggregate(tcfg, tg, _to_port(_synthetic_tree(rng, 4)), torch.ones(4), (), 0)


@pytest.fixture(scope="module")
def stream_setup():
    """fedtpu's streaming and tiered primaries over smallcnn, and the
    port's edge layout of the same tree."""
    jcfg, tcfg = configs(delta_layout="flat", compression="topk")
    jcfg_t, _ = configs(delta_layout="flat", compression="topk", tier_fanout=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        stream = jfederation.PrimaryServer(jcfg, [])
        tiered = jfederation.PrimaryServer(jcfg_t, [])
    g = {"params": jax.tree.map(np.asarray, stream.params), "batch_stats": {}}
    tg = _to_port(g)
    layout = tflat.make_tree_layout(tg)
    assert (layout.total, layout.padded) == (stream._flat_layout.total, stream._flat_layout.padded)
    return stream, tiered, g, tg, layout, tcfg


def test_finalize_stream_equals_fedtpu(stream_setup):
    stream, _, g, tg, layout, tcfg = stream_setup
    rng = np.random.default_rng(11)
    rows = np.zeros((5, layout.padded), np.float32)
    rows[:, : layout.total] = rng.normal(size=(5, layout.total)).astype(np.float32) * 1e-2
    w = rng.integers(1, 40, size=5).astype(np.float32)
    want, _ = stream._finalize_stream(g, jnp.asarray(rows), jnp.asarray(w), ())
    got, _ = aggregation.finalize_stream(tcfg, layout, tg, torch.from_numpy(rows), torch.from_numpy(w), ())
    for a, b in zip(_bits(_to_flax(got)), _bits(jax.tree.map(np.asarray, want))):
        np.testing.assert_array_equal(a, b)
    mean_j = np.asarray(jax.jit(jround.flat_weighted_mean)(jnp.asarray(rows), jnp.asarray(w)))
    mean_t = tround.flat_weighted_mean(torch.from_numpy(rows), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(mean_t.view(np.int32), mean_j.view(np.int32))


def test_finalize_partial_and_two_tier_mean_equal_fedtpu(stream_setup):
    stream, tiered, g, tg, layout, tcfg = stream_setup
    rng = np.random.default_rng(12)
    # Multiples of 2^-12 under 2^4 with weights under 16: every product and
    # partial sum of the mean is a multiple of 2^-12 under 2^11, exact in
    # f32, so the grouping cannot show.
    rows = np.zeros((6, layout.padded), np.float32)
    rows[:, : layout.total] = rng.integers(-2**16, 2**16, size=(6, layout.total)) / np.float32(2**12)
    w = rng.integers(1, 16, size=6).astype(np.float32)
    cohorts = [slice(0, 2), slice(2, 6)]
    parts_j = [jax.jit(jflat.partial_reduce_rows)(jnp.asarray(rows[c]), jnp.asarray(w[c])) for c in cohorts]
    parts_t = [tflat.partial_reduce_rows(torch.from_numpy(rows[c]), torch.from_numpy(w[c])) for c in cohorts]
    for (sj, wj), (st, wt) in zip(parts_j, parts_t):
        np.testing.assert_array_equal(st.numpy().view(np.int32), np.asarray(sj).view(np.int32))
        assert float(wt) == float(wj)
    sums = torch.stack([s for s, _ in parts_t])
    wsums = torch.stack([x for _, x in parts_t])
    got, _ = aggregation.finalize_partial(tcfg, layout, tg, sums, wsums, ())
    want, _ = tiered._finalize_partial(g, jnp.asarray(sums.numpy()), jnp.asarray(wsums.numpy()), ())
    flat, _ = aggregation.finalize_stream(tcfg, layout, tg, torch.from_numpy(rows), torch.from_numpy(w), ())
    for a, b, c in zip(_bits(_to_flax(got)), _bits(jax.tree.map(np.asarray, want)), _bits(_to_flax(flat))):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)  # 2-tier == flat, bit for bit
    combined_j = np.asarray(jax.jit(jflat.combine_partial_rows)(jnp.asarray(sums.numpy()), jnp.asarray(wsums.numpy())))
    combined_t = tflat.combine_partial_rows(sums, wsums).numpy()
    np.testing.assert_array_equal(combined_t.view(np.int32), combined_j.view(np.int32))


# -------------------------------------------------------------- federation


def _federation(jcfg, tcfg, port_data, port_client: bool, rounds=3):
    """fedtpu's primary over two clients on localhost (the second the
    port's when ``port_client``); the global tree after each round."""
    servers, addrs = [], []
    try:
        for i in range(2):
            addr = f"localhost:{free_port()}"
            if port_client and i == 1:
                server, _ = tfederation.serve_client(
                    addr, tcfg, seed=i, device="cpu", data=port_data[0], eval_data=port_data[1])
            else:
                server, _ = jfederation.serve_client(addr, jcfg, seed=i)
            servers.append(server)
            addrs.append(addr)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            primary = jfederation.PrimaryServer(jcfg, addrs)
        out = []
        for _ in range(rounds):
            rec = primary.round()
            assert rec["participants"] == 2 and rec["alive"] == [True, True], rec
            out.append(_model_like(primary))
        return out
    finally:
        for server in servers:
            server.stop(0)


@pytest.mark.parametrize("codec,layout", [
    ("none", "per_leaf"), ("topk", "per_leaf"), ("int8", "per_leaf"), ("rotq", "flat"),
])
def test_mixed_grpc_federation_tracks_all_fedtpu(port_data, codec, layout):
    """3 rounds of 2 participants each; the global model after rounds 0
    and 1 within the tolerance of the all-fedtpu federation's (on every
    coordinate for ``none``, all but 0.1% for the codecs)."""
    jcfg, tcfg = configs(compression=codec, delta_layout=layout)
    mixed = _federation(jcfg, tcfg, port_data, port_client=True)
    ref = _federation(jcfg, tcfg, port_data, port_client=False)
    for r in (0, 1):
        _hold(mixed[r], ref[r], codec != "none", f"{codec} round {r}")
    for tree in mixed:
        assert all(np.isfinite(a).all() for a in jax.tree_util.tree_leaves(tree))
