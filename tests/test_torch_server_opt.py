"""The port's server optimizers against ``fedtpu.core.server_opt``.

Each optimizer is written with optax's formulas in optax's order of
operations. Over three rounds of the same deltas from numpy:

- ``momentum`` is bit-equal to fedtpu's (params and trace);
- ``adam`` and ``yogi`` keep bit-equal moments and counts. Their params
  are bit-equal when the port takes XLA's square root; with torch's own,
  each param is within 3 ulp of its update plus 1 ulp of itself: XLA's
  f32 ``sqrt`` on the CPU is within 1 ulp, torch's is correctly rounded,
  and the quotient and the learning rate carry that 1 ulp to at most 3.

Whole rounds with a server optimizer go through ``Federation.step`` beside
fedtpu's, at the smallcnn round tolerance of ``test_torch_round.py``;
``adam`` and ``yogi`` with its 0.1% allowance: they divide by
``sqrt(nu)``, so where a coordinate's mean delta is within f32 noise of
zero, the size of its update is not fixed at that tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedtpu import config as jconfig
from fedtpu.core import server_opt as jserver_opt
from fedtpu_torch import config as tconfig
from fedtpu_torch.core import server_opt as tserver_opt
from fedtpu_torch.convert import to_flax
from test_torch_round import _beyond_tolerance, _track_fedtpu

SHAPES = {"Conv_0.weight": (8, 3, 3, 3), "Conv_0.bias": (8,), "Dense_0.weight": (10, 40)}
OPTIMIZERS = ["momentum", "adam", "yogi"]


def _xla_sqrt(t: torch.Tensor) -> torch.Tensor:
    return torch.tensor(np.asarray(jnp.sqrt(jnp.asarray(t.numpy()))))


def _three_rounds(name, monkeypatch=None):
    """(fedtpu's states, the port's) after each of three rounds."""
    if monkeypatch is not None:
        monkeypatch.setattr(tserver_opt, "_sqrt", _xla_sqrt)
    rng = np.random.default_rng(0)
    kw = dict(server_optimizer=name, server_lr=0.3)
    jfed, tfed = jconfig.FedConfig(**kw), tconfig.FedConfig(**kw)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    jopt = jserver_opt.make_server_optimizer(jfed)
    topt = tserver_opt.make_server_optimizer(tfed)
    jp = jax.tree.map(jnp.asarray, params)
    js = jserver_opt.init(jfed, jp)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    ts = tserver_opt.init(topt, tp)
    out = []
    for _ in range(3):
        delta = {k: (0.01 * rng.normal(size=s)).astype(np.float32) for k, s in SHAPES.items()}
        delta["Conv_0.bias"][0] = 0.0  # a zero pseudo-gradient
        old = jax.tree.map(np.asarray, jp)
        jp, js = jserver_opt.apply(jopt, jp, jax.tree.map(jnp.asarray, delta), js)
        tp, ts = tserver_opt.apply(topt, tp, {k: torch.from_numpy(v) for k, v in delta.items()}, ts)
        out.append((old, jax.tree.map(np.asarray, (jp, js)), (tp, ts)))
    return out


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32)


def _moments(js):
    """fedtpu's optax state as the port's dict of trees."""
    inner = js[0]
    if hasattr(inner, "trace"):
        return {"trace": inner.trace}
    return {"count": inner.count, "mu": inner.mu, "nu": inner.nu}


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_server_optimizer_state_is_fedtpus_bit_for_bit(name):
    for _, (_, js), (_, ts) in _three_rounds(name):
        want = _moments(js)
        assert want.keys() == ts.keys()
        for part, tree in want.items():
            if part == "count":
                assert int(ts["count"]) == int(tree) and ts["count"].dtype == torch.int32
                continue
            for k in SHAPES:
                np.testing.assert_array_equal(_bits(ts[part][k]), _bits(tree[k]), err_msg=f"{part} {k}")


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_server_optimizer_params_bit_equal_with_xlas_sqrt(name, monkeypatch):
    for _, (jp, _), (tp, _) in _three_rounds(name, monkeypatch):
        for k in SHAPES:
            np.testing.assert_array_equal(_bits(tp[k]), _bits(jp[k]), err_msg=k)


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_server_optimizer_params_within_ulps_of_fedtpu(name):
    for old, (jp, _), (tp, _) in _three_rounds(name):
        for k in SHAPES:
            want, got = jp[k], tp[k].numpy()
            update = np.abs(want - old[k])
            bound = 3 * np.spacing(update) + np.spacing(np.abs(want))
            assert (np.abs(got - want) <= bound).all(), k
            if name == "momentum":
                np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=k)


def test_no_server_optimizer_is_fedavg():
    p = {"w": torch.randn(5)}
    d = {"w": torch.randn(5)}
    new, state = tserver_opt.apply(None, p, d, ())
    assert torch.equal(new["w"], p["w"] + d["w"]) and state == ()
    assert tserver_opt.make_server_optimizer(tconfig.FedConfig()) is None


def test_unknown_server_optimizer_raises():
    with pytest.raises(ValueError, match="server_optimizer"):
        tconfig.validate(tconfig.RoundConfig(fed=tconfig.FedConfig(server_optimizer="sgd")))


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_rounds_with_a_server_optimizer_track_fedtpu(name):
    """Two smallcnn rounds of both engines with the server optimizer, from
    the same init on the same batches; the server state too."""
    jfed, tfed, _, _ = _track_fedtpu(
        "none", fed_kw=dict(server_optimizer=name, server_lr=0.5), strict=name == "momentum"
    )
    want = _moments(jax.tree.map(np.asarray, jfed.state.server_opt_state))
    bad = total = 0
    for part, tree in want.items():
        if part == "count":
            assert int(tfed.state.server_opt_state["count"]) == int(tree) == 2
            continue
        got = to_flax(tfed.state.server_opt_state[part])
        for mod in tree:
            for leaf in tree[mod]:
                bad += int(_beyond_tolerance(got[mod][leaf], tree[mod][leaf]).sum())
                total += tree[mod][leaf].size
    assert bad <= (0 if name == "momentum" else 0.001) * total, f"{bad} of {total} differ"
