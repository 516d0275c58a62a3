"""Shared building blocks of the port's model zoo.

The port of ``fedtpu.models.common``: fedtpu's ``BatchNorm``, its
bias-free ``conv3x3``/``conv1x1`` and a depthwise ``depthwise3x3``,
``max_pool``, ``avg_pool`` (VALID or padded, as flax pads: max with -inf,
the average counting the padding), ``global_avg_pool``, ``spatial_mean``
(a squeeze-and-excitation gate's input), and ShuffleNet's
``channel_shuffle``. Models take NHWC inputs at their public boundary and
run NCHW inside, torch's default layout for convolutions. fedtpu's
``FEDTPU_TILED_POOL`` opt-in changes only its own max-pool's backward
formulation, not the function, and the port does not read it.

A model with batch statistics follows one calling convention, the torch
form of flax's ``apply(..., train=True, mutable=["batch_stats"])``:

- ``model(x)`` is eval mode: every ``BatchNorm`` normalizes with the
  running statistics it holds as buffers (``mean``, ``var``), which a
  ``functional_call`` replaces with the global ones;
- ``model(x, train=True)`` returns ``(logits, new_stats)``: every
  ``BatchNorm`` normalizes with its batch's statistics and *returns* its
  new running statistics in ``new_stats`` (``{"<path>.mean": ...,
  "<path>.var": ...}``, the names of its buffers). No buffer is written:
  an in-place write inside ``torch.func.vmap(grad(...))`` would raise or
  be lost, so the round carries the statistics as values.

A model whose train mode draws random numbers (EfficientNet-B0's
drop-connect and dropout; fedtpu's ``make_rng("dropout")``) takes its
draws as keep masks, ``model(x, train=True, masks=...)``: a dict by
module path of bool tensors, one per example, shaped as
``model.mask_specs()`` says (:func:`mask_specs`, :func:`draw_masks`). The
caller draws them, outside any ``vmap``: a draw inside
``torch.func.vmap`` would follow no seed that a caller can set. Eval mode
takes none.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F

Stats = Dict[str, torch.Tensor]

BN_MOMENTUM = 0.9  # flax's: new running = 0.9 * old + 0.1 * batch (torch's 0.1)
BN_EPSILON = 1e-5


class BatchNorm(nn.Module):
    """fedtpu's BatchNorm over the channels of an NCHW tensor.

    It differs from ``nn.BatchNorm2d`` in four ways, all of them fedtpu's:

    - the batch variance is ``E[x^2] - E[x]^2`` over (N, H, W), in f32,
      clamped at 0 (flax's fast variance), not a two-pass variance;
    - the running variance takes that *biased* variance;
    - the running update is ``0.9 * old + 0.1 * new``;
    - the normalize runs in the compute dtype: ``mean`` and
      ``rsqrt(var + 1e-5) * scale`` are cast to ``x.dtype`` before the
      activation-sized math, so a bf16 activation stays bf16.

    The leaves carry flax's names: parameters ``scale`` and ``bias``,
    buffers (the ``batch_stats`` collection) ``mean`` and ``var``.
    """

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.path = ""  # its dotted name in the model; see name_batch_norms

    def forward(self, x: torch.Tensor, stats: Optional[Stats] = None) -> torch.Tensor:
        """Eval mode with ``stats=None``; train mode otherwise, which puts
        this layer's new running statistics into ``stats``."""
        if stats is None:
            return _normalize(x, self.mean, self.var, self.scale, self.bias)
        y, mean, var, _ = _TrainNorm.apply(x, self.scale, self.bias)
        stats[self.path + "mean"] = BN_MOMENTUM * self.mean + (1 - BN_MOMENTUM) * mean
        stats[self.path + "var"] = BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * var
        return y


_SHAPE = (1, -1, 1, 1)  # a per-channel vector against NCHW
_DIMS = (0, 2, 3)


def _normalize(x, mean, var, scale, bias):
    """``(x - mean) * rsqrt(var + eps) * scale + bias`` with the
    channel-sized factors cast to ``x.dtype`` first, in fedtpu's order."""
    y = x - mean.to(x.dtype).view(_SHAPE)
    mul = torch.rsqrt(var + BN_EPSILON) * scale
    y = y * mul.to(x.dtype).view(_SHAPE)
    return y + bias.to(x.dtype).view(_SHAPE)


class _TrainNorm(torch.autograd.Function):
    """Train-mode BatchNorm: ``(y, mean, var, raw_var)`` from ``x``, the
    batch statistics in ``promote(x.dtype, f32)``, ``var = max(raw_var,
    0)``.

    The same function as the plain ops (``_normalize`` after fedtpu's
    statistics), with a hand-written backward so that autograd keeps only
    ``x`` (in its own dtype) and the channel-sized statistics: the plain
    ops would keep the f32 upcast of ``x`` (for the square) and the centred
    value besides, 3x the bytes a bf16 activation element. The backward
    recomputes the centred value, in the statistics' dtype."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, scale, bias):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(_DIMS)
        raw = torch.square(xf).mean(_DIMS) - torch.square(mean)
        var = torch.maximum(raw, torch.zeros_like(raw))
        return _normalize(x, mean, var, scale, bias), mean, var, raw

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, scale, bias = inputs
        _, mean, var, raw = output
        ctx.save_for_backward(x, scale, mean, var, raw)
        ctx.bias_dtype = bias.dtype
        ctx.mark_non_differentiable(mean, var, raw)

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar, _graw):
        # Activation-sized terms stay in x's dtype (the channel sums run in
        # the statistics' dtype), so a bf16 layer's backward makes no f32
        # copy of itself; for f32 and f64 this is the plain ops' math.
        x, scale, mean, var, raw = ctx.saved_tensors
        ct = mean.dtype
        count = x.numel() // x.shape[1]
        rstd = torch.rsqrt(var + BN_EPSILON)
        mul = rstd * scale
        centred = x - mean.to(x.dtype).view(_SHAPE)
        g_mul = (gy * centred).sum(_DIMS, dtype=ct)
        g_centred = gy * mul.to(x.dtype).view(_SHAPE)
        # rsqrt, then the clamp at 0 (a tie splits the gradient, as
        # maximum's does), then var = E[x^2] - E[x]^2.
        g_var = g_mul * scale * (-0.5) * rstd ** 3
        g_raw = torch.where(raw > 0, g_var, torch.where(raw == 0, 0.5 * g_var, 0.0 * g_var))
        g_mean = -g_centred.sum(_DIMS, dtype=ct) - 2 * mean * g_raw
        g_x = torch.addcmul(
            g_centred + (g_mean / count).to(x.dtype).view(_SHAPE),
            x, (2 * g_raw / count).to(x.dtype).view(_SHAPE),
        )
        return g_x, (g_mul * rstd).to(scale.dtype), gy.sum(_DIMS, dtype=ct).to(ctx.bias_dtype)


class _Recompute(torch.autograd.Function):
    """A block's train-mode forward that keeps only its inputs for the
    backward, which runs the forward again under ``torch.func.vjp``: fedtpu's
    per-block rematerialisation (``nn.remat``), the activations inside the
    block traded for a second forward. ``torch.utils.checkpoint`` does not
    compose with ``torch.func`` transforms (saved-tensor hooks); this
    Function does, its vmap rule generated. ``run(x, *tensors) -> (y,
    *stats)``: the block as a pure function of its input and its params
    and buffers; the statistics are not differentiable. The backward
    recomputes the same ops on the same inputs, so its gradients are the
    plain block's, bit for bit."""

    generate_vmap_rule = True

    @staticmethod
    def forward(run, x, *tensors):
        return run(x, *tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        run, x, *tensors = inputs
        ctx.run = run
        ctx.save_for_backward(x, *tensors)
        ctx.mark_non_differentiable(*output[1:])

    @staticmethod
    def backward(ctx, gy, *_gstats):
        x, *tensors = ctx.saved_tensors
        run = ctx.run
        _, vjp = torch.func.vjp(lambda *a: run(*a)[0], x, *tensors)
        return (None,) + tuple(vjp(gy))


def recompute_block(block: nn.Module, x: torch.Tensor, stats: Stats) -> torch.Tensor:
    """``block(x, stats)`` in train mode through :class:`_Recompute`: the
    block's params and buffers (whatever ``functional_call`` has put in
    them) go in as inputs, its new statistics come out into ``stats``."""
    names = [n for n, _ in block.named_parameters()] + [n for n, _ in block.named_buffers()]
    tensors = [t for _, t in block.named_parameters()] + [t for _, t in block.named_buffers()]
    keys = []

    def run(x, *tensors):
        inner: Stats = {}
        y = torch.func.functional_call(block, dict(zip(names, tensors)), (x, inner), strict=True)
        keys[:] = list(inner)
        return (y, *inner.values())

    y, *new = _Recompute.apply(run, x, *tensors)
    stats.update(zip(keys, new))
    return y


def run_block(block: nn.Module, x: torch.Tensor, stats: Optional[Stats], remat: bool) -> torch.Tensor:
    """``block(x, stats)``, through :func:`recompute_block` when ``remat``
    is asked for and a train-mode backward will follow."""
    if remat and stats is not None and torch.is_grad_enabled():
        return recompute_block(block, x, stats)
    return block(x, stats)


def name_batch_norms(model: nn.Module) -> nn.Module:
    """Give every ``BatchNorm`` of ``model`` its dotted path, so that the
    statistics it returns in train mode carry its buffers' names."""
    for name, mod in model.named_modules():
        if isinstance(mod, BatchNorm):
            mod.path = f"{name}." if name else ""
    return model


def conv3x3(in_ch: int, out_ch: int, stride: int = 1) -> nn.Conv2d:
    """fedtpu's ``conv3x3``: 3x3, padding 1 on each side, no bias."""
    return nn.Conv2d(in_ch, out_ch, 3, stride=stride, padding=1, bias=False)


def conv1x1(in_ch: int, out_ch: int, stride: int = 1) -> nn.Conv2d:
    """fedtpu's ``conv1x1``: 1x1, no padding, no bias."""
    return nn.Conv2d(in_ch, out_ch, 1, stride=stride, bias=False)


def depthwise3x3(ch: int, stride: int = 1) -> nn.Conv2d:
    """A 3x3 depthwise conv (one channel a group), padding 1, no bias:
    flax's ``[3, 3, 1, C]`` kernel is torch's ``[C, 1, 3, 3]``."""
    return nn.Conv2d(ch, ch, 3, stride=stride, padding=1, groups=ch, bias=False)


def max_pool(x: torch.Tensor, window: int, stride: Optional[int] = None, padding: int = 0) -> torch.Tensor:
    """fedtpu's ``max_pool`` on an NCHW tensor: the stride equal to the
    window unless given; ``padding`` values on each side of both spatial
    dims, padded with -inf as flax's ``nn.max_pool`` pads (VALID at 0)."""
    return F.max_pool2d(x, window, stride or window, padding)


def avg_pool(x: torch.Tensor, window: int, stride: Optional[int] = None, padding: int = 0) -> torch.Tensor:
    """fedtpu's ``avg_pool`` on an NCHW tensor: the stride equal to the
    window unless given; ``padding`` zeros on each side of both spatial
    dims, counted in the average (flax's ``count_include_pad=True``, which
    is torch's default too)."""
    return F.avg_pool2d(x, window, stride or window, padding)


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """fedtpu's ``channel_shuffle`` on an NCHW tensor: channels viewed as
    ``[groups, c / groups]`` and read out transposed, so that output
    channel ``j * groups + i`` is input channel ``i * (c / groups) + j``
    (fedtpu's ``[..., g, C/g] -> [..., C/g, g]`` in NHWC)."""
    n, c, h, w = x.shape
    return x.reshape(n, groups, c // groups, h, w).transpose(1, 2).reshape(n, c, h, w)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over the spatial dims of an NCHW tensor -> ``[n, c]``."""
    return x.mean(dim=(2, 3))


def spatial_mean(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean(x, axis=(1, 2), keepdims=True)`` of fedtpu's NHWC tensor
    on an NCHW one, -> ``[n, c, 1, 1]``: summed in ``promote(x.dtype,
    f32)``, divided and cast back to ``x.dtype`` (``jnp.mean``'s rule for a
    bf16 input)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    return (x.sum(dim=(2, 3), keepdim=True, dtype=acc) / (x.shape[2] * x.shape[3])).to(x.dtype)


class MaskSpec(NamedTuple):
    """The keep mask of one random module: its shape for one example
    (broadcast against the module's output), and the probability of a
    True."""

    shape: Sequence[int]
    keep: float


Masks = Dict[str, torch.Tensor]


def mask_specs(model: nn.Module) -> Dict[str, MaskSpec]:
    """``{module path: MaskSpec}`` of every random module ``model`` runs in
    train mode, in the order it runs them; ``{}`` for a model without
    any."""
    specs = getattr(model, "mask_specs", None)
    return specs() if specs is not None else {}


def draw_masks(
    specs: Dict[str, MaskSpec],
    lead: Sequence[int],
    generator: Optional[torch.Generator] = None,
    device=None,
) -> Masks:
    """Keep masks ``lead + spec.shape`` for every module of ``specs``,
    Bernoulli(``keep``) as ``uniform < keep`` (jax's ``bernoulli``), one
    draw a module from ``generator`` in the order of ``specs``."""
    return {
        name: torch.rand(tuple(lead) + tuple(spec.shape), generator=generator, device=device) < spec.keep
        for name, spec in specs.items()
    }


def drop(y: torch.Tensor, mask: torch.Tensor, keep: float) -> torch.Tensor:
    """fedtpu's drop-connect and flax's ``Dropout`` under a drawn mask:
    ``where(mask, y / keep, 0)``, ``keep`` in ``y``'s dtype as jax casts a
    Python float, so that a kept entry is ``y / keep`` rounded once and a
    dropped one exactly 0. ``keep`` is a tensor on ``y``'s device: CUDA
    turns a division by a CPU scalar into a product with its reciprocal,
    which rounds differently."""
    keep_t = torch.full((), keep, dtype=y.dtype, device=y.device)
    return torch.where(mask, y / keep_t, 0.0)
