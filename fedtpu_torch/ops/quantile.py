"""NaN-skipping quantiles over one axis, as ``jnp.nanquantile`` computes
them, from a sort.

``torch.nanmedian`` returns the lower of the two middle values where
``jnp.nanmedian`` averages them, and ``torch.quantile`` refuses inputs of
more than 2^24 elements (MobileNet's largest leaf at 64 clients has 67 M),
so the robust aggregators and the screening statistics take their
quantiles from here. :func:`sort_rows` sorts once (the axis moved last, so
a card sorts many short segments, NaNs last), and :func:`quantile` reads
any number of quantiles off that sort: with ``n`` the values that are not
NaN, the position is ``q * (n - 1)`` in f32, its floor and ceiling clamped
to ``[0, n - 1]``, as jax computes them.
"""

from __future__ import annotations

from typing import Tuple

import torch

METHODS = ("lower", "higher", "midpoint")


def sort_rows(x: torch.Tensor, dim: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values sorted along dim, moved last; the count of non-NaN values
    per row, f32 [..., 1])``."""
    s = torch.sort(x.movedim(dim, -1).contiguous(), dim=-1).values
    return s, (~torch.isnan(s)).sum(-1, keepdim=True).to(torch.float32)


def quantile(sorted_rows: Tuple[torch.Tensor, torch.Tensor], q: float, method: str) -> torch.Tensor:
    """The ``q`` quantile of each row of :func:`sort_rows`' result (NaN
    where a row is all NaN): ``lower`` and ``higher`` snap to a data value,
    ``midpoint`` averages the two (``jnp.nanmedian`` is ``q=0.5`` with
    ``midpoint``)."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; have {' | '.join(METHODS)}")
    s, counts = sorted_rows
    pos = torch.tensor(q, dtype=torch.float32, device=s.device) * (counts - 1.0)
    top = counts - 1.0

    def at(p: torch.Tensor) -> torch.Tensor:
        p = torch.maximum(torch.minimum(p, top), torch.zeros_like(p))
        return torch.gather(s, -1, p.long())

    if method == "lower":
        out = at(torch.floor(pos))
    elif method == "higher":
        out = at(torch.ceil(pos))
    else:
        out = (at(torch.floor(pos)) + at(torch.ceil(pos))) * 0.5
    return out.squeeze(-1)


def nanquantile(x: torch.Tensor, q: float, method: str, dim: int = 0) -> torch.Tensor:
    """``jnp.nanquantile(x, q, axis=dim, method=method)`` for one quantile."""
    return quantile(sort_rows(x, dim), q, method)
