"""MobileNet rounds against fedtpu's (split from ``test_torch_mobilenet.py``
so that ``--dist loadfile`` runs the two halves on different workers).

Whole rounds (``Federation.step`` on explicit batches, each round from
fedtpu's state before it), the global model in f64 in both packages
(fedtpu under ``jax.enable_x64``): loss within ``rtol=1e-6``; params and
``batch_stats`` within ``atol=1e-5, rtol=1e-4``, with the codecs'
allowances of ``TOLERANCE``. Why f64 and a state per round: at init, 27
BatchNorms over 4-example batches make MobileNet's gradient so
ill-conditioned that fedtpu's own f32 gradient on the CPU is 1-2.5% from
its f64 gradient (torch's f32 is 1e-5 to 7e-3 from it), and in f64 the f32
roundings both packages keep (logits cast for the loss, momentum stored
f32) still grow past any tolerance within one more round. The same f64
rounds agree to 2e-10 in the gradients of one step
(``test_torch_mobilenet.py``).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedtpu.core import round as jround
from fedtpu.ops import compression as jcomp
from fedtpu_torch.convert import to_flax
from fedtpu_torch.core import round as tround
from fedtpu_torch.core.engine import Federation as TFederation
from fedtpu_torch.ops import compression as tcomp
from torch_mobilenet import (  # noqa: F401 (flax_mobilenet is a fixture)
    BATCH,
    CLIENTS,
    STEPS,
    _configs,
    _count_beyond,
    _f64,
    _port_state,
    flax_mobilenet,
)
from torch_zoo import one_torch_thread  # noqa: F401 (an autouse fixture)

# Per codec: (params atol, share of coordinates allowed beyond tolerance).
# A last-bit difference of an f64 delta can round to another f32 and so
# cross a top-k threshold or an int8 step. rotq's row is f64 in fedtpu's
# x64 round and f32 in the port's (fedtpu packs in the leaves' dtype, the
# port in f32, which is fedtpu's own dtype outside x64): the f32 rounding
# moves a few rotated coordinates across a stochastic-rounding step, and
# each such step moves every coordinate of that client's row by
# step / 2048; 2e-4 bounds that (7e-5 measured, against rounds that move
# params by up to 1.9).
TOLERANCE = {
    "none": (1e-5, 0.0), "topk": (1e-5, 0.001), "int8": (1e-5, 0.001),
    "rotq": (2e-4, 0.0),
}


def _round_inputs(rng, r):
    x = rng.normal(size=(CLIENTS, STEPS, BATCH, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=(CLIENTS, STEPS, BATCH)).astype(np.int32)
    step_mask = np.ones((CLIENTS, STEPS), bool)
    step_mask[1, 1] = False  # client 1's second step is padding
    weights = np.array([8.0, 4.0], np.float32)
    alive = np.array([True, r == 0])  # client 1 dies in round 2
    return x, y, step_mask, weights, alive


def _x64_rotq_draws(comp):
    """rotq fed the signs and uniforms fedtpu's round draws under
    ``jax.enable_x64`` (its Rademacher signs differ there from the default
    mode's), from the int32 round index its state carries."""

    def apply_flat(y, state, lay, round_idx=0):
        with jax.enable_x64(True):
            key = jax.random.fold_in(jax.random.PRNGKey(0x5EED0), jnp.int32(round_idx))
            k_sign, k_unif = jax.random.split(key)
            signs = np.asarray(jax.random.rademacher(k_sign, (lay.padded,), jnp.float32))
            unif = np.asarray(jax.random.uniform(k_unif, tuple(y.shape), jnp.float32))
        return comp.apply_flat(
            y, state, lay, round_idx=round_idx,
            signs=torch.tensor(signs), uniforms=torch.tensor(unif),
        )

    return comp._replace(apply_flat=apply_flat)


@pytest.mark.parametrize("compression,delta_layout,rounds", [
    ("none", "per_leaf", 2),
    ("topk", "per_leaf", 2),
    ("int8", "per_leaf", 2),
    ("rotq", "flat", 1),
])
def test_mobilenet_rounds_track_fedtpu(flax_mobilenet, compression, delta_layout, rounds):
    """MobileNet rounds of both packages on the same batches, each round
    from fedtpu's state before it, the global model in f64 (fedtpu under
    ``jax.enable_x64``): the local step, BatchNorm's statistics through it
    and through the combine, the momentum (stored f32 in both), the codecs
    and their residuals (f32 in both) and the mean. Round 2 has a dead
    client and carries round 1's momentum and residuals. rotq is held for
    one round, as on smallcnn."""
    jmodel, params, stats = flax_mobilenet
    jcfg, tcfg = _configs(compression, delta_layout)
    rng = np.random.default_rng(4)
    batches = [_round_inputs(rng, r) for r in range(rounds)]
    states, losses = [], []
    with jax.enable_x64(True):
        jcodec = jcomp.make_compressor(jcfg.fed)
        variables = {"params": _f64(params), "batch_stats": _f64(stats)}
        jstate = jround.init_state(
            SimpleNamespace(init=lambda *a, **k: variables), jcfg,
            jax.random.PRNGKey(0), None, jcodec,
        )
        jstep = jax.jit(jround.make_round_step(jmodel, jcfg, jcodec))
        states.append(jax.tree.map(np.asarray, jstate))
        for x, y, sm, w, alive in batches:
            jstate, jm = jstep(jstate, jround.RoundBatch(
                x=jnp.asarray(x), y=jnp.asarray(y), step_mask=jnp.asarray(sm),
                weights=jnp.asarray(w), alive=jnp.asarray(alive),
            ))
            states.append(jax.tree.map(np.asarray, jstate))
            losses.append(float(jm.loss))
    tcodec = tcomp.make_compressor(tcfg.fed)
    if compression == "rotq":
        tcodec = _x64_rotq_draws(tcodec)
    data = (rng.normal(size=(16, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, size=16).astype(np.int32))
    tfed = TFederation(tcfg, seed=0, data=data, device="cpu", compressor=tcodec)
    for r, (x, y, sm, w, alive) in enumerate(batches):
        tfed.state = _port_state(states[r], r)
        tm = tfed.step(tround.RoundBatch(
            x=torch.from_numpy(x), y=torch.from_numpy(y), step_mask=torch.from_numpy(sm),
            weights=torch.from_numpy(w), alive=torch.from_numpy(alive),
        ))
        np.testing.assert_allclose(float(tm.loss), losses[r], rtol=1e-6)
        atol, allowance = TOLERANCE[compression]
        for name in ("params", "batch_stats"):
            bad, total = _count_beyond(
                to_flax(getattr(tfed.state, name)), getattr(states[r + 1], name),
                atol if name == "params" else 1e-5,
            )
            assert bad <= allowance * total, f"round {r} {name}: {bad} of {total} differ"
        assert tfed.state.params["Conv_0.weight"].dtype == torch.float64
