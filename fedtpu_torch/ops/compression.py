"""Update compression of client deltas, per leaf: the port of the per-leaf
codecs of ``fedtpu.ops.compression``.

Deltas are dicts of ``[clients, ...]`` tensors. Each leaf is flattened to
``[clients, size]`` f32, the client's residual is added (error feedback),
and the codec maps it to what the wire would carry plus the new residual:

- ``topk``: keep each row's ``ceil(fraction * size)`` largest magnitudes
  (ties at the threshold kept) through :func:`kernels.threshold_feedback`;
- ``int8``: symmetric per-row int8 through :func:`kernels.quantdequant_int8`.

The codec functions are parameters of :func:`make_topk` / :func:`make_int8`
so a check can run the same codec on the kernels' plain versions.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from fedtpu_torch.config import FedConfig, RoundConfig, validate
from fedtpu_torch.ops import kernels

Tree = Dict[str, torch.Tensor]


class Compressor(NamedTuple):
    """A stateful delta codec. ``init(params, num_clients)`` builds the
    per-client residuals (``()`` without error feedback);
    ``apply(deltas, state)`` returns ``(compressed deltas, new state)``."""

    init: Callable[[Tree, int], object]
    apply: Callable[[Tree, object], Tuple[Tree, object]]


def _flatten_leaf(d: torch.Tensor) -> torch.Tensor:
    """[clients, ...] -> [clients, size] float32."""
    return d.reshape(d.shape[0], -1).float()


def _make_init(error_feedback: bool) -> Callable[[Tree, int], object]:
    def init(params: Tree, num_clients: int):
        if not error_feedback:
            return ()
        return {
            k: torch.zeros((num_clients,) + tuple(p.shape), dtype=torch.float32, device=p.device)
            for k, p in params.items()
        }

    return init


def _make_apply(
    leaf: Callable[[torch.Tensor, Optional[torch.Tensor]], Tuple[torch.Tensor, Optional[torch.Tensor]]],
    error_feedback: bool,
) -> Callable[[Tree, object], Tuple[Tree, object]]:
    """Lift a per-leaf ``(delta, residual) -> (compressed, new_residual)``
    codec to a dict of leaves."""

    def apply(deltas: Tree, state):
        out, new_state = {}, {}
        for k, d in deltas.items():
            out[k], new_state[k] = leaf(d, state[k] if error_feedback else None)
        return out, (new_state if error_feedback else state)

    return apply


def make_topk(
    fraction: float,
    error_feedback: bool = True,
    threshold: Callable = kernels.threshold_feedback,
) -> Compressor:
    """Magnitude top-k per leaf per client, with optional error feedback."""

    def leaf(d: torch.Tensor, e: Optional[torch.Tensor]):
        shape = d.shape
        y = _flatten_leaf(d)
        if e is not None:
            y = y + e.reshape(y.shape)
        size = y.shape[1]
        k = max(1, int(math.ceil(fraction * size)))
        if k >= size:
            return y.reshape(shape).to(d.dtype), torch.zeros(shape, dtype=torch.float32, device=d.device)
        # The k-th largest magnitude of each row is its keep threshold: a
        # library top-k, as fedtpu's lax.top_k sits outside its kernel.
        kth = torch.topk(y.abs(), k, dim=1).values[:, -1].contiguous()
        if e is None:
            # No residual wanted: a plain masked select, as in fedtpu (the
            # kernel would write a dead full-size residual).
            out = torch.where(y.abs() >= kth[:, None], y, torch.zeros_like(y))
            return out.reshape(shape).to(d.dtype), None
        out, new_e = threshold(y.contiguous(), kth)
        return out.reshape(shape).to(d.dtype), new_e.reshape(shape)

    return Compressor(init=_make_init(error_feedback), apply=_make_apply(leaf, error_feedback))


def make_int8(
    error_feedback: bool = True,
    quantdequant: Callable = kernels.quantdequant_int8,
) -> Compressor:
    """Symmetric per-leaf int8, scale ``max|y| / 127`` per client."""

    def leaf(d: torch.Tensor, e: Optional[torch.Tensor]):
        shape = d.shape
        y = _flatten_leaf(d)
        if e is not None:
            y = y + e.reshape(y.shape)
        scale = y.abs().amax(dim=1) / 127.0
        out = quantdequant(y.contiguous(), scale)
        new_e = None if e is None else (y - out).reshape(shape)
        return out.reshape(shape).to(d.dtype), new_e

    return Compressor(init=_make_init(error_feedback), apply=_make_apply(leaf, error_feedback))


def make_compressor(fed: FedConfig) -> Optional[Compressor]:
    """Compressor from ``FedConfig.compression`` on the per-leaf layout;
    None for 'none'. Raises on what the port does not run (the flat layout,
    ``rotq``, ``randk``)."""
    validate(RoundConfig(fed=fed))
    if fed.compression == "topk":
        return make_topk(fed.topk_fraction, fed.error_feedback)
    if fed.compression == "int8":
        return make_int8(fed.error_feedback)
    return None
