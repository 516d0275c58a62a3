"""Update compression of client deltas: the port of ``fedtpu.ops.compression``.

Two layouts, as in fedtpu. Per leaf, deltas are dicts of ``[clients, ...]``
tensors; each leaf is flattened to ``[clients, size]`` f32, the client's
residual is added (error feedback), and the codec maps it to what the wire
would carry plus the new residual:

- ``topk``: keep each row's ``ceil(fraction * size)`` largest magnitudes
  (ties at the threshold kept) through
  :func:`kernels.threshold_feedback_grouped`, every leaf in one call;
- ``int8``: symmetric per-row int8 through
  :func:`kernels.quantdequant_int8_grouped`, every leaf in one call.

On the flat layout (:mod:`fedtpu_torch.ops.flat`) the codec sees one
``[clients, P]`` buffer and its residual is one buffer too:

- ``topk``: one threshold per row over the whole model, one
  :func:`kernels.threshold_feedback_grouped` launch;
- ``int8``: per-leaf scales, the quantize-dequantize inline (fedtpu calls
  no kernel here); bit-equal to the per-leaf codec;
- ``rotq``: rotate the power-of-two row through
  :func:`kernels.hadamard_rotate`, quantize to ``bits`` bits per coordinate
  with stochastic rounding over the row's range, dequantize, rotate back;
- ``randk``: keep one shared random set of ``ceil(fraction * total)``
  coordinates.

``rotq`` and ``randk`` draw their signs, uniforms and coordinates from a
``torch.Generator`` on the row's device seeded from ``(base seed,
round_idx)``, so a round replays bit for bit; fedtpu's threefry draws
cannot be reproduced in torch, so ``apply_flat`` also takes them injected
(``signs=``, ``uniforms=``, ``indices=``). The kernel functions are
parameters of the ``make_*`` functions, so a check can run the same codec
on the kernels' plain versions.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fedtpu_torch.config import ROTQ_BIT_WIDTHS, FedConfig, RoundConfig, validate
from fedtpu_torch.ops import flat as flat_ops
from fedtpu_torch.ops import kernels

Tree = Dict[str, torch.Tensor]


class Compressor(NamedTuple):
    """A stateful delta codec. ``init(params, num_clients)`` builds the
    per-client residuals (``()`` without error feedback);
    ``apply(deltas, state)`` returns ``(compressed deltas, new state)``.

    A flat codec (``layout="flat"``) also has ``apply_flat(y, state, lay,
    round_idx=0)`` on the packed ``[clients, P]`` buffer, which the round
    calls with its round index (the seed of ``rotq``'s and ``randk``'s
    draws; the other codecs ignore it); its residual is one ``[clients, P]``
    buffer. ``pad_pow2`` marks a
    codec whose row is padded to a power of two (``rotq``)."""

    init: Callable[[Tree, int], object]
    apply: Callable[[Tree, object], Tuple[Tree, object]]
    layout: str = "per_leaf"
    apply_flat: Optional[Callable[..., Tuple[torch.Tensor, object]]] = None
    pad_pow2: bool = False


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


def _check_layout(layout: str) -> None:
    if layout not in ("per_leaf", "flat"):
        raise ValueError(f"unknown delta layout {layout!r}; have per_leaf | flat")


# ------------------------------------------------------------ flat codecs


def _make_flat_init(error_feedback: bool, pow2: bool = False) -> Callable[[Tree, int], object]:
    """One ``[clients, P]`` residual buffer (``()`` without error feedback),
    laid out from the torch-named params dict."""

    def init(params: Tree, num_clients: int):
        if not error_feedback:
            return ()
        lay = flat_ops.make_layout(params, pow2=pow2)
        device = next(iter(params.values())).device
        return torch.zeros((num_clients, lay.padded), dtype=torch.float32, device=device)

    return init


def _flat_codec(apply_flat, error_feedback: bool, pow2: bool = False) -> Compressor:
    """A flat codec, with a dict-level ``apply`` for standalone callers
    (pack, codec, unpack); the round packs its own buffer."""

    def apply(deltas: Tree, state):
        lay = flat_ops.make_layout({k: v[0] for k, v in deltas.items()}, pow2=pow2)
        out, new_state = apply_flat(flat_ops.pack_stacked(lay, deltas), state, lay)
        return flat_ops.unpack_stacked(lay, out), new_state

    return Compressor(
        init=_make_flat_init(error_feedback, pow2),
        apply=apply,
        layout="flat",
        apply_flat=apply_flat,
        pad_pow2=pow2,
    )


def _make_topk_flat(fraction: float, error_feedback: bool, threshold: Callable) -> Compressor:
    """One threshold per row over the whole model (``k`` counted against
    the real coordinates), then one ``threshold`` call over the buffer."""

    def apply_flat(y, state, lay, round_idx=0):
        if error_feedback:
            y = y + state
        kth = flat_ops.topk_threshold(y, fraction, lay.total)
        if kth is None:  # keep-all budget: nothing dropped
            return y, (torch.zeros_like(y) if error_feedback else state)
        if not error_feedback:
            return torch.where(y.abs() >= kth[:, None], y, torch.zeros_like(y)), state
        (out,), (new_e,) = threshold([y.contiguous()], [kth])
        return out, new_e

    return _flat_codec(apply_flat, error_feedback)


def _make_int8_flat(error_feedback: bool) -> Compressor:
    """Per-leaf scales by one segment-max, then the quantize-dequantize
    inline over the whole buffer, as fedtpu computes it: bit-equal to the
    per-leaf codec."""

    def apply_flat(y, state, lay, round_idx=0):
        if error_feedback:
            y = y + state
        scale = flat_ops.int8_scales(y, lay)
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        out = torch.clamp(torch.round(y / safe), -127.0, 127.0) * safe
        if not error_feedback:
            return out, state
        return out, y - out

    return _flat_codec(apply_flat, error_feedback)


# Base seeds of the per-round streams of the seeded codecs, fedtpu's.
_ROTQ_SEED = 0x5EED0
_RANDK_SEED = 0x5EED1


def round_generator(base: int, round_idx: int, device) -> torch.Generator:
    """The generator of one round's draws of a seeded codec, on ``device``."""
    return torch.Generator(device=device).manual_seed((base << 32) | (round_idx & 0xFFFFFFFF))


def _rotq_draws(rows: int, h: int, round_idx: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rotq``'s draws for a round: Rademacher ``signs [h]`` and
    ``uniforms [rows, h]`` in [0, 1), f32."""
    g = round_generator(_ROTQ_SEED, round_idx, device)
    signs = torch.randint(0, 2, (h,), generator=g, device=device).float() * 2.0 - 1.0
    uniforms = torch.rand((rows, h), generator=g, device=device)
    return signs, uniforms


def _randk_indices(total: int, k: int, round_idx: int, device) -> torch.Tensor:
    """``randk``'s coordinate set for a round: ``k`` distinct coordinates
    of ``[0, total)``."""
    g = round_generator(_RANDK_SEED, round_idx, device)
    return torch.randperm(total, generator=g, device=device)[:k]


def _make_rotq_flat(bits: int, error_feedback: bool, rotate: Callable) -> Compressor:
    """Rotate, quantize each coordinate to ``bits`` bits with stochastic
    rounding over the row's [min, max], dequantize, rotate back, then zero
    the pad again (the rotation mixes real coordinates into it; in exact
    math they cancel, so only quantization noise is dropped)."""
    if bits not in ROTQ_BIT_WIDTHS:
        raise ValueError(f"rotq bits must be one of {ROTQ_BIT_WIDTHS}, got {bits}")
    levels = float(2**bits - 1)

    def apply_flat(y, state, lay, round_idx=0, signs=None, uniforms=None):
        if error_feedback:
            y = y + state
        h = lay.padded
        if h & (h - 1):
            raise ValueError(
                f"rotq needs a power-of-two row (got padded={h}); build the "
                "layout with make_layout(..., pow2=True)"
            )
        if signs is None or uniforms is None:
            drawn = _rotq_draws(y.shape[0], h, round_idx, y.device)
            signs = drawn[0] if signs is None else signs
            uniforms = drawn[1] if uniforms is None else uniforms
        z = rotate(y.contiguous(), signs)
        lo = z.amin(dim=1, keepdim=True)
        scale = (z.amax(dim=1, keepdim=True) - lo) / levels
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        q = torch.clamp(torch.floor((z - lo) / safe + uniforms), 0.0, levels)
        out = rotate(lo + q * safe, signs, inverse=True)
        out[:, lay.total :] = 0.0
        if not error_feedback:
            return out, state
        return out, y - out

    return _flat_codec(apply_flat, error_feedback, pow2=True)


def _make_randk_flat(fraction: float, error_feedback: bool) -> Compressor:
    """Keep one shared set of ``k = ceil(fraction * total)`` real
    coordinates. With error feedback the kept values ship as they are (the
    residual carries the rest); without it they are scaled by ``total / k``
    so the estimate is unbiased."""

    def apply_flat(y, state, lay, round_idx=0, indices=None):
        if error_feedback:
            y = y + state
        k = max(1, int(math.ceil(fraction * lay.total)))
        if k >= lay.total:  # keep-all budget
            return y, (torch.zeros_like(y) if error_feedback else state)
        if indices is None:
            indices = _randk_indices(lay.total, k, round_idx, y.device)
        mask = torch.zeros((lay.padded,), dtype=torch.float32, device=y.device)
        mask[indices] = 1.0
        kept = y * mask[None, :]
        if error_feedback:
            return kept, y - kept
        return kept * float(np.float32(lay.total / k)), state

    return _flat_codec(apply_flat, error_feedback)


# ---------------------------------------------------------------- makers


def make_topk(
    fraction: float,
    error_feedback: bool = True,
    layout: str = "per_leaf",
    threshold: Callable = kernels.threshold_feedback_grouped,
) -> Compressor:
    """Magnitude top-k per client, per leaf or over the flat row, with
    optional error feedback. ``threshold`` (``(ys, threshs) -> (outs,
    new_es)``) splits the rows by their keep thresholds: per leaf, every
    leaf's ``y`` and threshold are formed first and one call takes the
    leaves that need it (the values of fedtpu's one-leaf-at-a-time codec,
    one kernel launch a round); on the flat layout one call takes the row."""
    _check_layout(layout)
    if layout == "flat":
        return _make_topk_flat(fraction, error_feedback, threshold)

    def apply(deltas: Tree, state):
        out, new_state, split = {}, {}, []
        for name, d in deltas.items():
            y = _flatten_leaf(d)
            if error_feedback:
                y = y + state[name].reshape(y.shape)
            size = y.shape[1]
            k = max(1, int(math.ceil(fraction * size)))
            if k >= size:  # keep-all budget: nothing dropped
                out[name] = y.reshape(d.shape).to(d.dtype)
                new_state[name] = torch.zeros(d.shape, dtype=torch.float32, device=d.device)
                continue
            # The k-th largest magnitude of each row is its keep threshold: a
            # library top-k, as fedtpu's lax.top_k sits outside its kernel.
            kth = torch.topk(y.abs(), k, dim=1).values[:, -1].contiguous()
            if error_feedback:
                split.append((name, y.contiguous(), kth))
                continue
            # No residual wanted: a plain masked select, as in fedtpu (the
            # kernel would write a dead full-size residual).
            kept = torch.where(y.abs() >= kth[:, None], y, torch.zeros_like(y))
            out[name] = kept.reshape(d.shape).to(d.dtype)
        if split:
            names = [name for name, _, _ in split]
            outs, new_es = threshold([y for _, y, _ in split], [kth for _, _, kth in split])
            del split  # the inputs' memory is free once the call is queued
            for name, o, e in zip(names, outs, new_es):
                d = deltas[name]
                out[name] = o.reshape(d.shape).to(d.dtype)
                new_state[name] = e.reshape(d.shape)
        out = {name: out[name] for name in deltas}
        return out, ({name: new_state[name] for name in deltas} if error_feedback else state)

    return Compressor(init=_make_init(error_feedback), apply=apply)


def make_int8(
    error_feedback: bool = True,
    layout: str = "per_leaf",
    quantdequant: Callable = kernels.quantdequant_int8_grouped,
) -> Compressor:
    """Symmetric int8, scale ``max|y| / 127`` per client per leaf. Per leaf,
    every leaf's ``y`` and scales are formed first and ``quantdequant``
    (``(ys, scales) -> outs``) takes them all in one call: the values of
    fedtpu's one-leaf-at-a-time codec, one kernel launch a round."""
    _check_layout(layout)
    if layout == "flat":
        return _make_int8_flat(error_feedback)

    def apply(deltas: Tree, state):
        ys = []
        for k, d in deltas.items():
            y = _flatten_leaf(d)
            if error_feedback:
                y = y + state[k].reshape(y.shape)
            ys.append(y.contiguous())
        outs = quantdequant(ys, [y.abs().amax(dim=1) / 127.0 for y in ys])
        out, new_state = {}, {}
        for (k, d), y, q in zip(deltas.items(), ys, outs):
            out[k] = q.reshape(d.shape).to(d.dtype)
            if error_feedback:
                new_state[k] = (y - q).reshape(d.shape)
        return out, (new_state if error_feedback else state)

    return Compressor(init=_make_init(error_feedback), apply=apply)


def make_rotq(
    bits: int = 4,
    error_feedback: bool = True,
    layout: str = "flat",
    rotate: Callable = kernels.hadamard_rotate,
) -> Compressor:
    """Rotated-sketch quantizer; flat layout only (the rotation is over the
    whole row)."""
    if layout != "flat":
        raise ValueError("rotq is a flat-layout codec; set delta_layout='flat'")
    return _make_rotq_flat(bits, error_feedback, rotate)


def make_randk(
    fraction: float, error_feedback: bool = True, layout: str = "flat"
) -> Compressor:
    """Random-k coordinate subsampling; flat layout only (the draw is over
    the whole row)."""
    if layout != "flat":
        raise ValueError("randk is a flat-layout codec; set delta_layout='flat'")
    return _make_randk_flat(fraction, error_feedback)


def make_compressor(fed: FedConfig) -> Optional[Compressor]:
    """Compressor from ``FedConfig.compression`` and ``delta_layout``; None
    for 'none'. Raises on what the port does not run."""
    validate(RoundConfig(fed=fed))
    if fed.compression == "topk":
        return make_topk(fed.topk_fraction, fed.error_feedback, layout=fed.delta_layout)
    if fed.compression == "int8":
        return make_int8(fed.error_feedback, layout=fed.delta_layout)
    if fed.compression == "rotq":
        return make_rotq(fed.rotq_bits, fed.error_feedback, layout=fed.delta_layout)
    if fed.compression == "randk":
        # randk shares the top-k keep fraction, as in fedtpu.
        return make_randk(fed.topk_fraction, fed.error_feedback, layout=fed.delta_layout)
    return None
