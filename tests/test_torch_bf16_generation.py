"""bf16 generations: the port writes and reads flax's ``"bfloat16"``
arrays (``fedtpu_torch.transport.msgpack.Bfloat16Array``) without
``ml_dtypes``, so a state of bf16 momentum (``momentum_dtype='bfloat16'``)
is a generation of fedtpu's bytes.

- the msgpack extension of a bf16 array is flax's, byte for byte, and
  flax's reads back into the same 16-bit words and bf16 tensors;
- ``Federation.generation``, a ``LocalTrainer``'s client state and an
  ``AsyncFederation`` generation under bf16 momentum are fedtpu's bytes but
  for the generator leaf, and each restores from the other package's.
"""

import warnings

import flax.serialization
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from fedtpu import config as jconfig
from fedtpu.checkpoint import checkpoint as jck
from fedtpu.core import async_engine as jasync
from fedtpu.core.engine import Federation as JFederation
from fedtpu.transport import federation as jfederation
from fedtpu.transport import wire as jwire
from fedtpu_torch import config as tconfig
from fedtpu_torch.checkpoint import restore, save
from fedtpu_torch.convert import from_flax, to_flax
from fedtpu_torch.core import async_engine as tasync
from fedtpu_torch.core.engine import Federation as TFederation
from fedtpu_torch.transport import msgpack, wire as twire
from fedtpu_torch.transport.trainer import LocalTrainer


def cfg(mod, model="smallcnn", **fed_kw):
    """A small config of bf16 momentum in either package."""
    return mod.RoundConfig(
        model=model,
        steps_per_round=1,
        opt=mod.OptimizerConfig(momentum_dtype="bfloat16"),
        data=mod.DataConfig(dataset="cifar10", batch_size=4, eval_batch_size=8, partition="iid",
                            augment=False, num_examples=32),
        fed=mod.FedConfig(**{"num_clients": 2, **fed_kw}),
    )


def data(n=32):
    rng = np.random.default_rng(6)
    return rng.normal(size=(n, 32, 32, 3)).astype(np.float32), rng.integers(0, 10, n).astype(np.int32)


def random_bf16(tree, seed):
    """Every leaf of ``tree`` replaced by bf16 noise of its shape."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape).astype(ml_dtypes.bfloat16)), tree)


def words(tree):
    return [np.asarray(x).view(np.uint16) if not isinstance(x, msgpack.Bfloat16Array) else x.words
            for x in jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(x, msgpack.Bfloat16Array))]


# ---------------------------------------------------------- the extension
@pytest.mark.parametrize("shape", [(4,), (3, 5), (2, 3, 3, 4), (0,), ()])
def test_the_extension_is_flaxs_and_reads_back(shape):
    rng = np.random.default_rng(len(shape))
    a = rng.normal(size=shape).astype(ml_dtypes.bfloat16) if shape != (4,) else np.arange(4).astype(
        ml_dtypes.bfloat16)
    want = flax.serialization.to_bytes({"m": a})
    holder = msgpack.Bfloat16Array(a.view(np.uint16))
    assert msgpack.to_bytes({"m": holder}) == want
    if shape == (4,):
        # 81 a1 6d: {"m": ...}; c7 16 01: ext 1 of 22 bytes; 93 91 04: [[4], ...
        assert want.startswith(bytes.fromhex("81a16dc716019391") + b"\x04\xa8bfloat16\xc4\x08")
    back = msgpack.from_bytes({"m": 0}, want)["m"]
    assert isinstance(back, msgpack.Bfloat16Array) and back.shape == shape
    np.testing.assert_array_equal(back.words, a.view(np.uint16))
    t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    assert torch.equal(from_flax({"x": {"bias": back}})["x.bias"], t)
    assert msgpack.to_bytes({"m": to_flax({"x.bias": t})["x"]["bias"]}) == want


def test_a_bf16_kernel_converts_in_both_directions():
    t = torch.randn(6, 2, 3, 3).to(torch.bfloat16)  # OIHW
    flax_tree = to_flax({"c.weight": t})
    assert flax_tree["c"]["kernel"].shape == (3, 3, 2, 6)  # HWIO
    assert torch.equal(from_flax(flax_tree)["c.weight"], t)
    np.testing.assert_array_equal(
        flax_tree["c"]["kernel"].words,
        t.float().numpy().transpose(2, 3, 1, 0).astype(ml_dtypes.bfloat16).view(np.uint16))


# -------------------------------------------------------------- the engine
def test_engine_generation_of_bf16_momentum_is_fedtpus_and_restores_both_ways(tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jfed = JFederation(cfg(jconfig), seed=0, data=data())
    jfed._state = jfed.state._replace(opt_state=jfed.state.opt_state._replace(
        momentum=random_bf16(jfed.state.opt_state.momentum, 1)))
    jhost = jax.tree.map(np.asarray, jfed.state)
    tfed = TFederation(cfg(tconfig), seed=0, data=data(), device="cpu")
    tfed.generation = jhost._replace(client_rng=tfed.generation.client_rng,
                                     opt_state={"momentum": jhost.opt_state.momentum})
    assert all(t.dtype == torch.bfloat16 for t in tfed.state.opt_state.values())
    gen = tfed.generation
    assert twire.encode(gen._replace(client_rng=jhost.client_rng)) == jwire.encode(jhost)
    # The port's generation restores in fedtpu, and fedtpu's in the port.
    save(str(tmp_path / "t"), 2, gen._replace(client_rng=jhost.client_rng))
    back = jck.restore(str(tmp_path / "t"), 2, jfed.state, backend="wire")
    for a, b in zip(words(back.opt_state.momentum), words(jhost.opt_state.momentum), strict=True):
        np.testing.assert_array_equal(a, b)
    jck.save(str(tmp_path / "j"), 2, jfed.state, backend="wire")
    tree = restore(str(tmp_path / "j"), 2, gen._replace(client_rng=jhost.client_rng))
    other = TFederation(cfg(tconfig), seed=0, data=data(), device="cpu")
    other.generation = tree._replace(client_rng=gen.client_rng)
    assert twire.encode(other.generation) == twire.encode(gen)
    # A bf16-momentum round still runs after the restore.
    assert np.isfinite(float(other.step().loss))


def test_client_state_of_bf16_momentum_is_fedtpus_and_restores(tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = jfederation.LocalTrainer(cfg(jconfig), seed=0)
    j.opt_state = j.opt_state._replace(momentum=random_bf16(j.opt_state.momentum, 2))
    j.round_idx = 5
    t = LocalTrainer(cfg(tconfig), seed=0, device="cpu", data=data(), eval_data=data(8))
    jstate = j._client_state()
    data_bytes = jwire.encode(jstate, compress=True)
    tree = twire.decode(data_bytes, t._client_state())
    t._install_client_state({**tree, "rng": t._client_state()["rng"]})
    assert t.round_idx == 5 and all(v.dtype == torch.bfloat16 for v in t.opt_state.values())
    got = t._client_state()
    assert twire.encode({**got, "rng": jstate["rng"]}, compress=True) == data_bytes
    # The port's own store: a state_dir round trip.
    t._state_ckpt = None
    t2 = LocalTrainer(cfg(tconfig), seed=0, device="cpu", data=data(), eval_data=data(8),
                      state_dir=str(tmp_path / "s"))
    t2.opt_state, t2.round_idx = t.opt_state, 5
    t2._persist_client_state()
    t3 = LocalTrainer(cfg(tconfig), seed=0, device="cpu", data=data(), eval_data=data(8),
                      state_dir=str(tmp_path / "s"))
    assert t3.round_idx == 5
    assert all(torch.equal(t3.opt_state[k], t.opt_state[k]) for k in t.opt_state)


def test_async_generation_of_bf16_momentum_is_fedtpus():
    acfg = lambda mod: cfg(mod, model="mlp", num_clients=3)  # noqa: E731
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = jasync.AsyncFederation(acfg(jconfig), seed=0, buffer_k=1, data=data())
    jstate = j.state._replace(opt_state=j.state.opt_state._replace(
        momentum=random_bf16(j.state.opt_state.momentum, 3)))
    jhost = jax.tree.map(np.asarray, jstate)
    t = tasync.AsyncFederation(acfg(tconfig), seed=0, buffer_k=1, data=data(), device="cpu")
    assert all(v.dtype == torch.bfloat16 for v in t.state.opt_state.values())
    t.load_state(jhost._replace(client_rng=t.generation.client_rng))
    gen = t.generation
    assert twire.encode(gen._replace(client_rng=jhost.client_rng)) == jwire.encode(jhost)
    m = t.tick()
    assert np.isfinite(float(m.loss))
    assert all(v.dtype == torch.bfloat16 for v in t.state.opt_state.values())
