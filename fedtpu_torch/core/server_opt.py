"""Server-side optimization of the aggregated update (the FedOpt family).

The port of ``fedtpu.core.server_opt``. The mean client delta is a
pseudo-gradient ``g = -mean_delta`` fed to a server optimizer over the
global model; ``server_optimizer='none'`` is FedAvg (``params +
mean_delta``). fedtpu builds its optimizers from optax; here each one is
written out with optax's formulas, in optax's order of operations:

- ``momentum`` (``optax.sgd(lr, momentum)``): ``m = g + b1 * m``, update
  ``-lr * m``;
- ``adam`` (``optax.adam``): ``mu = (1 - b1) * g + b1 * mu``, ``nu = (1 -
  b2) * g^2 + b2 * nu``, both bias-corrected by ``1 - b^t`` with ``t``
  counted from 1, update ``-lr * mu_hat / (sqrt(nu_hat) + eps)``;
- ``yogi`` (``optax.yogi``): ``mu`` and ``nu`` start at 1e-6, not 0, and
  ``nu = nu - (1 - b2) * sign(nu - g^2) * g^2``; bias-corrected and
  applied as Adam.

The state is a dict of tensors on the params' device: ``{"trace": {...}}``
for momentum, ``{"count", "mu", "nu"}`` (``count`` an int32 scalar) for
adam and yogi, ``()`` for FedAvg.

:func:`apply` computes optax's eager arithmetic, one rounding per
operation. ``apply(..., compiled=True)`` computes the form XLA compiles on
the CPU when the step runs inside one jitted program, as fedtpu's
coordinator runs it (``PrimaryServer._aggregate`` and
``_finalize_stream``): LLVM contracts a product that feeds an add into a
fused multiply-add (``m = b1 * m + g``, ``mu = b1 * mu + (1 - b1) * g``,
``nu = (1 - b2) * g^2 + b2 * nu``, yogi's ``nu - (1 - b2) * sign * g^2``
and the last ``params + (-lr) * update``), and XLA's simplifier turns
``(mu / c1) / d`` into ``mu / (c1 * d)``. A fused multiply-add is taken
through f64 (:func:`fma`), where the product of two f32 values is exact.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fedtpu_torch.config import FedConfig, RoundConfig, validate
from fedtpu_torch.convert import from_flax, to_flax

Tree = Dict[str, torch.Tensor]

_YOGI_INITIAL = 1e-6  # optax's initial_accumulator_value
_sqrt = torch.sqrt  # a name of its own, so that a check can swap in another rounding


class ServerOptimizer(NamedTuple):
    name: str  # momentum | adam | yogi
    lr: float
    b1: float
    b2: float
    eps: float


def make_server_optimizer(fed: FedConfig) -> Optional[ServerOptimizer]:
    """The optimizer ``fed.server_optimizer`` names; None for FedAvg."""
    validate(RoundConfig(fed=fed))
    if fed.server_optimizer == "none":
        return None
    return ServerOptimizer(
        fed.server_optimizer, fed.server_lr, fed.server_momentum,
        fed.server_beta2, fed.server_eps,
    )


def init(opt: Optional[ServerOptimizer], params: Tree):
    """Initial server state over the global ``params``."""
    if opt is None:
        return ()
    if opt.name == "momentum":
        return {"trace": {k: torch.zeros_like(p) for k, p in params.items()}}
    fill = _YOGI_INITIAL if opt.name == "yogi" else 0.0
    device = next(iter(params.values())).device
    return {
        "count": torch.zeros((), dtype=torch.int32, device=device),
        "mu": {k: torch.full_like(p, fill) for k, p in params.items()},
        "nu": {k: torch.full_like(p, fill) for k, p in params.items()},
    }


def to_flax_state(opt: Optional[ServerOptimizer], state):
    """The server state as flax's state dict of fedtpu's optax state, on the
    host: ``{"0": {"trace": tree}, "1": {}}`` for momentum, ``{"0":
    {"count", "mu", "nu"}, "1": {}}`` for adam and yogi (the chain's
    second element, the learning-rate scale, holds nothing); ``()`` for
    FedAvg."""
    if opt is None:
        return ()
    if opt.name == "momentum":
        inner = {"trace": to_flax(state["trace"])}
    else:
        inner = {
            "count": np.asarray(int(state["count"]), np.int32),
            "mu": to_flax(state["mu"]),
            "nu": to_flax(state["nu"]),
        }
    return {"0": inner, "1": {}}


def from_flax_state(opt: Optional[ServerOptimizer], tree, device):
    """Inverse of :func:`to_flax_state`, on ``device``."""
    if opt is None:
        return ()
    inner = tree["0"]
    if opt.name == "momentum":
        return {"trace": from_flax(inner["trace"], device=device)}
    return {
        "count": torch.tensor(int(np.asarray(inner["count"])), dtype=torch.int32, device=device),
        "mu": from_flax(inner["mu"], device=device),
        "nu": from_flax(inner["nu"], device=device),
    }


def fma(a, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` in f32 with one rounding (a fused multiply-add),
    through f64; ``a`` a tensor or a Python number, rounded to f32 first as
    a weakly typed constant is. The f64 sum and the f32 rounding agree with
    a true fused multiply-add but for a tie, about once in 2^29."""
    if not isinstance(a, torch.Tensor):
        a = float(torch.tensor(a, dtype=torch.float32))
    else:
        a = a.to(torch.float64)
    return (a * b.to(torch.float64) + c.to(torch.float64)).to(torch.float32)


def _bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    """``1 - decay**count`` in f32, as optax computes it."""
    return 1 - torch.tensor(decay, dtype=torch.float32, device=count.device) ** count


def apply(
    opt: Optional[ServerOptimizer], params: Tree, mean_delta: Tree, state, compiled: bool = False
) -> Tuple[Tree, object]:
    """``(new params, new state)`` from the round's mean delta; ``compiled``
    for XLA's compiled CPU arithmetic (see the module docstring)."""
    if opt is None:
        return {k: params[k] + mean_delta[k] for k in params}, state
    g = {k: -d for k, d in mean_delta.items()}
    if opt.name == "momentum":
        if compiled:
            trace = {k: fma(opt.b1, state["trace"][k], g[k]) for k in g}
            return {k: fma(-opt.lr, trace[k], params[k]) for k in params}, {"trace": trace}
        trace = {k: g[k] + opt.b1 * state["trace"][k] for k in g}
        return (
            {k: params[k] + (-opt.lr) * trace[k] for k in params},
            {"trace": trace},
        )
    if compiled:
        mu = {k: fma(opt.b1, state["mu"][k], (1 - opt.b1) * g[k]) for k in g}
    else:
        mu = {k: (1 - opt.b1) * g[k] + opt.b1 * state["mu"][k] for k in g}
    nu = {}
    for k in g:
        g2 = g[k] * g[k]
        v = state["nu"][k]
        if opt.name == "adam":
            nu[k] = fma(1 - opt.b2, g2, opt.b2 * v) if compiled else (1 - opt.b2) * g2 + opt.b2 * v
        elif compiled:
            nu[k] = fma(-((1 - opt.b2) * torch.sign(v - g2)), g2, v)
        else:
            nu[k] = v - (1 - opt.b2) * torch.sign(v - g2) * g2
    count = state["count"] + 1
    c1, c2 = _bias_correction(opt.b1, count), _bias_correction(opt.b2, count)
    new_params = {}
    for k in params:
        if compiled:
            update = mu[k] / (c1 * (_sqrt(nu[k] / c2) + opt.eps))
            new_params[k] = fma(-opt.lr, update, params[k])
        else:
            update = (mu[k] / c1) / (_sqrt(nu[k] / c2) + opt.eps)
            new_params[k] = params[k] + (-opt.lr) * update
    return new_params, {"count": count, "mu": mu, "nu": nu}
