"""The port's checkpoint store (``fedtpu_torch.checkpoint``) against
fedtpu's, and the engine's resume, on the CPU.

For the same host tree (fedtpu's tiny ``FederatedState`` after a round)
the port writes a generation file and a manifest byte-equal to fedtpu's
``save(..., backend="wire")``, and each package restores the other's
file. Then the counterparts of ``tests/test_checkpoint.py``: the CRC and
the manifest, retention, fallback past rot and torn writes, the loud
failures, non-fatal saves under the disk chaos kinds, the legacy
suffix-drop ladder and the background writer. Last the engine: its
generation is fedtpu's ``FederatedState`` layout but for the ``client_rng``
leaf (the port's generator), a resume with the generator carried is
bit-equal to a run that never stopped, and a resume on injected batches
stays within the round tests' tolerance of fedtpu's resume.
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedtpu import models as jmodels
from fedtpu.checkpoint import checkpoint as jck
from fedtpu.config import DataConfig, FedConfig, OptimizerConfig, RoundConfig
from fedtpu.core import round as jround
from fedtpu.core.engine import Federation as JFederation
from fedtpu.transport import wire as jwire
from fedtpu_torch import config as tconfig
from fedtpu_torch.checkpoint import (
    BackgroundCheckpointer,
    Checkpointer,
    latest_round,
    restore,
    save,
    verify_generation,
)
from fedtpu_torch.checkpoint.checkpoint import _scan_rounds, _wire_path
from fedtpu_torch.convert import from_flax, to_flax
from fedtpu_torch.core import round as tround
from fedtpu_torch.core.engine import Federation as TFederation
from fedtpu_torch.ft import parse_chaos_spec
from fedtpu_torch.obs import FlightRecorder, MetricsRegistry, Telemetry
from fedtpu_torch.transport import wire as twire
from torch_parity import configs, round_inputs, seeded_data


def fedtpu_state(compression="none", server_optimizer="none", rounds=1):
    """fedtpu's tiny MLP state (3 clients) after ``rounds`` rounds, and its
    host copy."""
    cfg = RoundConfig(
        model="mlp", num_classes=10, opt=OptimizerConfig(),
        data=DataConfig(dataset="synthetic", batch_size=4),
        fed=FedConfig(num_clients=3, compression=compression, server_optimizer=server_optimizer),
        steps_per_round=2,
    )
    model = jmodels.create(cfg.model, num_classes=10)
    state = jround.init_state(model, cfg, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.float32))
    step = jax.jit(jround.make_round_step(model, cfg))
    rng = np.random.default_rng(0)
    for _ in range(rounds):
        batch = jround.RoundBatch(
            x=jnp.asarray(rng.normal(size=(3, 2, 4, 8)).astype(np.float32)),
            y=jnp.asarray(rng.integers(0, 10, size=(3, 2, 4)).astype(np.int32)),
            step_mask=jnp.ones((3, 2), bool), weights=jnp.ones((3,), jnp.float32),
            alive=jnp.ones((3,), bool),
        )
        state, _ = step(state, batch)
    return state, jax.tree.map(np.asarray, state)


@pytest.fixture(scope="module")
def host_state():
    return fedtpu_state()[1]


def _assert_tree_equal(a, b):
    la, lb = twire.tree_leaves(a), twire.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _corrupt_file(path, offset_from_end=3):
    data = bytearray(open(path, "rb").read())
    data[-offset_from_end] ^= 0x55
    open(path, "wb").write(bytes(data))


# ------------------------------------------------------------ fedtpu's bytes
@pytest.mark.parametrize("compression,server_optimizer", [
    ("none", "none"), ("topk", "adam"), ("int8", "momentum"),
])
def test_generation_bytes_equal_fedtpus_and_each_restores_the_other(tmp_path, compression, server_optimizer):
    state, host = fedtpu_state(compression, server_optimizer)
    jck.save(str(tmp_path / "j"), 3, state, backend="wire")
    assert save(str(tmp_path / "t"), 3, host).endswith("round_3.fckpt")
    for name in ("round_3.fckpt", "round_3.fckpt.manifest.json"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name
    _assert_tree_equal(restore(str(tmp_path / "j"), 3, host), host)
    _assert_tree_equal(jck.restore(str(tmp_path / "t"), 3, state, backend="wire"), host)
    # A tensor leaf is copied to the host once and writes the same bytes.
    as_torch = host._replace(params=jax.tree.map(torch.tensor, host.params))
    save(str(tmp_path / "u"), 3, as_torch)
    assert (tmp_path / "u" / "round_3.fckpt").read_bytes() == (tmp_path / "j" / "round_3.fckpt").read_bytes()


def test_roundtrip_and_latest_round(tmp_path, host_state):
    d = str(tmp_path / "ckpt")
    save(d, 7, host_state)
    _assert_tree_equal(restore(d, 7, like=host_state), host_state)
    assert latest_round(d) == 7 and verify_generation(d, 7)


def test_orbax_and_the_missing_hooks_raise(tmp_path, host_state):
    with pytest.raises(ValueError, match="orbax"):
        save(str(tmp_path), 0, host_state, backend="orbax")
    with pytest.raises(ValueError, match="orbax"):
        Checkpointer(str(tmp_path), backend="orbax")
    # metrics= and flight= run since slice 8 part 5a: a save is counted, a
    # fallback past a corrupt generation counted and recorded.
    reg, flight = MetricsRegistry(), FlightRecorder(role="ckpt")
    ck = Checkpointer(str(tmp_path / "obs"), metrics=reg, flight=flight)
    ck.save(0, host_state)
    ck.save(1, host_state)
    with open(tmp_path / "obs" / "round_1.fckpt", "r+b") as fh:
        fh.truncate(8)
    assert ck.restore_latest(like=host_state)[0] == 0
    snap = reg.snapshot()
    assert snap["fedtpu_checkpoint_saves_total"][0]["value"] == 2
    assert snap["fedtpu_checkpoint_fallback_total"][0]["value"] == 1
    assert snap["fedtpu_checkpoint_write_seconds"][0]["count"] == 2
    assert snap["fedtpu_checkpoint_bytes"][0]["value"] == ck.last_save["bytes"] > 0
    assert [(e["kind"], e["event"], e["round"]) for e in flight.snapshot()] == [("checkpoint", "fallback", 1)]
    # telemetry= runs since slice 8 part 5b: each background write is a
    # checkpoint span (tests/test_torch_trace_engines.py holds it against
    # fedtpu's).
    tel = Telemetry("trace")
    bg = BackgroundCheckpointer(Checkpointer(str(tmp_path / "bg")), telemetry=tel)
    bg.save(3, host_state)
    bg.close()
    assert [(e["name"], e["args"]["round"]) for e in tel.trace_events()] == [("checkpoint", 3)]


def test_generation_is_crc_and_manifest_protected(tmp_path, host_state):
    d = str(tmp_path / "ckpt")
    path = save(d, 0, host_state)
    _corrupt_file(path)
    assert not verify_generation(d, 0)
    with pytest.raises(twire.WireError, match="manifest digest"):
        restore(d, 0, like=host_state)
    # Without its manifest (a generation written before manifests), the
    # frame's CRC still catches it, as fedtpu's.
    os.remove(path + ".manifest.json")
    with pytest.raises(twire.WireError, match="CRC"):
        restore(d, 0, like=host_state)
    with pytest.raises(jwire.WireError, match="CRC"):
        jck.restore(d, 0, like=host_state, backend="wire")


def test_retention_keeps_newest(tmp_path, host_state):
    ckpt = Checkpointer(str(tmp_path), keep=2)
    for r in range(5):
        ckpt.save(r, host_state)
    files = os.listdir(tmp_path)
    assert sorted(f for f in files if f.endswith(".fckpt")) == ["round_3.fckpt", "round_4.fckpt"]
    assert sorted(f for f in files if f.endswith(".manifest.json")) == [
        "round_3.fckpt.manifest.json", "round_4.fckpt.manifest.json"]
    assert latest_round(str(tmp_path)) == 4
    assert ckpt.last_save["round"] == 4 and ckpt.last_save["bytes"] == os.path.getsize(tmp_path / "round_4.fckpt")


def test_restore_latest_empty_dir(tmp_path):
    assert Checkpointer(str(tmp_path / "nope")).restore_latest(like={}) is None


@pytest.mark.parametrize("fault", ["flip", "torn"])
def test_restore_latest_falls_back_past_a_corrupt_newest(tmp_path, host_state, fault):
    ckpt = Checkpointer(str(tmp_path), keep=3)
    for r in range(3):
        ckpt.save(r, host_state)
    path = str(tmp_path / "round_2.fckpt")
    if fault == "flip":
        _corrupt_file(path)
    else:
        with open(path, "r+b") as fh:
            fh.truncate(os.path.getsize(path) // 2)
    r, restored = ckpt.restore_latest(like=host_state)
    assert r == 1
    _assert_tree_equal(restored, host_state)
    # fedtpu's store falls back the same way over the port's directory.
    assert jck.Checkpointer(str(tmp_path), backend="wire").restore_latest(like=host_state)[0] == 1


def test_restore_latest_all_corrupt_raises_loudly(tmp_path, host_state):
    ckpt = Checkpointer(str(tmp_path), keep=3)
    ckpt.save(0, host_state)
    ckpt.save(1, host_state)
    for r in range(2):
        _corrupt_file(str(tmp_path / f"round_{r}.fckpt"))
    with pytest.raises(twire.WireError, match="all 2 checkpoint generations"):
        ckpt.restore_latest(like=host_state)


def test_resume_requires_two_generations_retained(tmp_path, host_state):
    ckpt = Checkpointer(str(tmp_path), keep=1)
    ckpt.save(0, host_state)
    with pytest.raises(ValueError, match="keep >= 2"):
        ckpt.restore_latest(like=host_state)
    assert Checkpointer(str(tmp_path), keep=0).restore_latest(like=host_state)[0] == 0


def test_template_mismatch_raises_rather_than_falling_back(tmp_path, host_state):
    ckpt = Checkpointer(str(tmp_path), keep=3)
    ckpt.save(0, host_state)
    ckpt.save(1, host_state)
    with pytest.raises(ValueError) as err:
        ckpt.restore_latest(like={"different": np.zeros((3,), np.float32)})
    assert not isinstance(err.value, twire.WireError)


def test_ckpt_fail_is_nonfatal_and_keeps_the_old_generations(tmp_path, host_state):
    chaos = parse_chaos_spec("ckpt_fail:p=1.0,rounds=1,max=1")
    ckpt = Checkpointer(str(tmp_path), keep=2, chaos=chaos)
    chaos.set_round(0)
    assert ckpt.save(0, host_state) is not None
    chaos.set_round(1)
    assert ckpt.save(1, host_state) is None  # the injected ENOSPC
    assert latest_round(str(tmp_path)) == 0
    chaos.set_round(2)
    assert ckpt.save(2, host_state) is not None
    assert ckpt.restore_latest(like=host_state)[0] == 2
    strict = Checkpointer(str(tmp_path), keep=2, strict=True, chaos=parse_chaos_spec("ckpt_fail:p=1.0,max=1"))
    with pytest.raises(OSError):
        strict.save(3, host_state)


@pytest.mark.parametrize("kind", ["ckpt_rot", "ckpt_torn"])
def test_disk_chaos_is_silent_until_restore(tmp_path, host_state, kind):
    chaos = parse_chaos_spec(f"{kind}:p=1.0,rounds=1,max=1")
    ckpt = Checkpointer(str(tmp_path), keep=3, chaos=chaos)
    chaos.set_round(0)
    ckpt.save(0, host_state)
    chaos.set_round(1)
    assert ckpt.save(1, host_state) is not None  # acknowledged, then lost
    assert not verify_generation(str(tmp_path), 1)
    assert ckpt.restore_latest(like=host_state)[0] == 0


def test_legacy_decode_suffix_drop_ladder(tmp_path, host_state):
    """A generation written before ``last_client_loss`` (and before
    ``server_opt_state``) restores with those fields taken from ``like``,
    as fedtpu's does; the blobs are fedtpu's own encoder's."""
    saved = host_state._replace(
        params=jax.tree.map(lambda l: l + 1.0, host_state.params),
        round_idx=host_state.round_idx + 7,
    )
    full = dict(saved._asdict())

    def write_blob(r, drop):
        d = {k: v for k, v in full.items() if k not in drop}
        with open(_wire_path(str(tmp_path), r), "wb") as fh:
            fh.write(jwire.encode(d, compress=True))

    write_blob(0, drop=("last_client_loss",))
    write_blob(1, drop=("server_opt_state", "last_client_loss"))
    mid = restore(str(tmp_path), 0, like=host_state)
    _assert_tree_equal(mid.params, saved.params)
    assert int(mid.round_idx) == int(saved.round_idx)
    _assert_tree_equal(mid.last_client_loss, host_state.last_client_loss)
    oldest = restore(str(tmp_path), 1, like=host_state)
    _assert_tree_equal(oldest.params, saved.params)
    _assert_tree_equal(oldest.server_opt_state, host_state.server_opt_state)
    want = jck.restore(str(tmp_path), 1, like=host_state, backend="wire")
    _assert_tree_equal(oldest, want)


def test_background_writer_orders_flushes_and_survives_errors(tmp_path, host_state):
    chaos = parse_chaos_spec("ckpt_fail:p=1.0,max=1")
    inner = Checkpointer(str(tmp_path), keep=10, chaos=chaos)
    bg = BackgroundCheckpointer(inner, queue_depth=2)
    seen = []
    real_save = inner.save

    def spy(round_idx, tree):
        seen.append((round_idx, all(isinstance(l, np.ndarray) for l in twire.tree_leaves(tree))))
        return real_save(round_idx, tree)

    inner.save = spy
    dev_state = host_state._replace(params=jax.tree.map(torch.tensor, host_state.params))
    for r in range(4):
        bg.save(r, dev_state)
    assert bg.flush(timeout=30)
    assert [r for r, _ in seen] == [0, 1, 2, 3]
    assert all(hosted for _, hosted in seen)
    assert _scan_rounds(str(tmp_path)) == [1, 2, 3]  # save 0 failed, the writer lived
    r, restored = bg.restore_latest(like=host_state)
    assert r == 3
    _assert_tree_equal(restored, host_state)
    assert bg.status()["pending"] == 0
    bg.close()
    bg.close()


def test_background_snapshot_survives_an_in_place_update(tmp_path):
    """The writer's snapshot is a copy: a round that updates a state tensor
    in place right after ``save`` must not reach the written generation."""
    state = {"a": torch.arange(4096, dtype=torch.float32), "b": torch.ones(128)}
    expected = {k: v.numpy().copy() for k, v in state.items()}
    inner = Checkpointer(str(tmp_path), keep=3)
    gate = __import__("threading").Event()
    real_save = inner.save
    inner.save = lambda r, t: (gate.wait(), real_save(r, t))[1]
    bg = BackgroundCheckpointer(inner)
    bg.save(0, state)
    for v in state.values():
        v.add_(1.0)  # the next round's in-place update
    gate.set()
    assert bg.flush(timeout=30)
    _assert_tree_equal(bg.restore(0, like=expected), expected)
    bg.close()


# ------------------------------------------------------------ engine resume
def _engine_cfg():
    return tconfig.RoundConfig(
        model="smallcnn", steps_per_round=2,
        data=tconfig.DataConfig(batch_size=4, partition="iid", augment=True),
        fed=tconfig.FedConfig(num_clients=4, compression="topk", server_optimizer="adam"),
    )


def test_engine_resume_with_the_generator_is_bit_equal_to_a_run_that_never_stopped(tmp_path):
    cfg, data = _engine_cfg(), seeded_data(3)
    control = TFederation(cfg, data=data, device="cpu")
    for _ in range(4):
        control.step()
    first = TFederation(cfg, data=data, device="cpu")
    chaos = parse_chaos_spec("ckpt_rot:p=1.0,rounds=3,max=1")
    ckpt = BackgroundCheckpointer(Checkpointer(str(tmp_path), keep=3, chaos=chaos))
    for r in range(1, 4):
        first.step()
        # The writer consults the schedule when it takes a save up: drain
        # it before moving the round, so the rot lands on generation 3.
        ckpt.flush()
        chaos.set_round(r)
        ckpt.save(r, first.generation)
    del first  # the crash
    resumed = TFederation(cfg, data=data, device="cpu")
    r, tree = ckpt.restore_latest(resumed.generation)
    assert r == 2  # generation 3 rotted
    resumed.generation = tree
    assert resumed.state.round_idx == 2
    for _ in range(2):
        resumed.step()
    for field in ("params", "opt_state", "comp_state"):
        got, want = getattr(resumed.state, field), getattr(control.state, field)
        for k in want:
            assert torch.equal(got[k], want[k]), (field, k)
    for k in control.state.server_opt_state["mu"]:
        assert torch.equal(resumed.state.server_opt_state["mu"][k], control.state.server_opt_state["mu"][k])
    assert torch.equal(resumed.state.last_client_loss, control.state.last_client_loss)
    # Without the generator the augmentation draws, and the run, part.
    other = TFederation(cfg, data=data, device="cpu")
    other.generation = tree._replace(client_rng=other.generation.client_rng)
    for _ in range(2):
        other.step()
    assert not all(torch.equal(other.state.params[k], control.state.params[k]) for k in control.state.params)
    ckpt.close()


def test_engine_generation_is_fedtpus_layout_but_the_generator_leaf():
    jcfg, tcfg = configs(compression="topk", server_optimizer="adam")
    data = seeded_data(4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jfed = JFederation(jcfg, seed=0, data=data)
    tfed = TFederation(tcfg, seed=0, data=data, device="cpu")
    tfed.state = tfed.state._replace(params=from_flax(jax.tree.map(np.asarray, jfed.state.params)))
    jhost = jax.tree.map(np.asarray, jfed.state)
    gen = tfed.generation
    assert gen._fields == jhost._fields
    assert gen.client_rng.dtype == np.uint8 and jhost.client_rng.shape == (4, 2)
    same = gen._replace(client_rng=jhost.client_rng)
    assert twire.encode(same, compress=True) == jwire.encode(jhost, compress=True)


def test_engine_resume_matches_fedtpus_resume_on_injected_batches(tmp_path):
    jcfg, tcfg = configs(compression="topk", server_optimizer="momentum")
    data = seeded_data(5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jfed = JFederation(jcfg, seed=0, data=data)
        jfed2 = JFederation(jcfg, seed=0, data=data)
    tfed = TFederation(tcfg, seed=0, data=data, device="cpu")
    tfed.state = tfed.state._replace(params=from_flax(jax.tree.map(np.asarray, jfed.state.params)))
    rng = np.random.default_rng(5)
    w = np.asarray(jfed.weights)
    batches = [round_inputs(rng) for _ in range(3)]

    def jbatch(x, y, sm):
        return jround.RoundBatch(x=jnp.asarray(x), y=jnp.asarray(y), step_mask=jnp.asarray(sm),
                                 weights=jnp.asarray(w), alive=jnp.ones(4, bool))

    def tbatch(x, y, sm):
        return tround.RoundBatch(x=torch.from_numpy(x), y=torch.from_numpy(y), step_mask=torch.from_numpy(sm),
                                 weights=torch.from_numpy(w.copy()), alive=torch.ones(4, dtype=torch.bool))

    for b in batches[:2]:
        jfed.step(jbatch(*b))
        tfed.step(tbatch(*b))
    jck.save(str(tmp_path / "j"), 2, jfed.state, backend="wire")
    save(str(tmp_path / "t"), 2, tfed.generation)
    jfed2.state = jax.tree.map(jnp.asarray, jck.restore(str(tmp_path / "j"), 2, like=jfed2.state, backend="wire"))
    tfed2 = TFederation(tcfg, seed=0, data=data, device="cpu")
    tfed2.generation = restore(str(tmp_path / "t"), 2, like=tfed2.generation)
    jfed2.step(jbatch(*batches[2]))
    tfed2.step(tbatch(*batches[2]))
    got, want = to_flax(tfed2.state.params), jax.tree.map(np.asarray, jfed2.state.params)
    for mod in want:
        for leaf in want[mod]:
            np.testing.assert_allclose(got[mod][leaf], want[mod][leaf], atol=1e-5, rtol=1e-4,
                                       err_msg=f"{mod}/{leaf}")
    assert tfed2.state.round_idx == int(jfed2.state.round_idx) == 3


def test_bf16_momentum_generations_raise_naming_their_item(tmp_path):
    cfg = tconfig.RoundConfig(
        model="smallcnn", steps_per_round=1,
        opt=tconfig.OptimizerConfig(momentum_dtype="bfloat16"),
        data=tconfig.DataConfig(batch_size=4, partition="iid", augment=False),
        fed=tconfig.FedConfig(num_clients=2),
    )
    fed = TFederation(cfg, data=seeded_data(6, n=16), device="cpu")
    # Written since bf16 generations were ported (tests/test_torch_bf16_generation.py
    # holds them against fedtpu's bytes): a round of bf16 momentum, then a
    # generation that restores bit for bit.
    fed.step()
    assert all(t.dtype == torch.bfloat16 for t in fed.state.opt_state.values())
    save(str(tmp_path), 1, fed.generation)
    other = TFederation(cfg, data=seeded_data(6, n=16), device="cpu")
    other.generation = restore(str(tmp_path), 1, other.generation)
    assert twire.encode(other.generation) == twire.encode(fed.generation)
    assert all(torch.equal(other.state.opt_state[k], fed.state.opt_state[k]) for k in fed.state.opt_state)
