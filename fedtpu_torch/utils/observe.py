"""The coordinator round record's straggler summary: the port's own copy of
``latency_summary`` (``fedtpu/obs/profile.py``), which stays here until
ROADMAP.md item 5c ports the rest of that module. The registry, the
thread-safe ``Counter`` and ``process_rss_bytes`` live in
:mod:`fedtpu_torch.obs`."""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence, Tuple


def latency_summary(pairs: Sequence[Tuple[str, float]], top_k: int = 3) -> Dict[str, Any]:
    """p50/p95/p99, the maximum and the ``top_k`` slowest over ``(client,
    seconds)`` pairs, the straggler block of a round record; ``{}`` for no
    pairs. Nearest-rank percentiles, rounded to the microsecond."""
    if not pairs:
        return {}
    lats = sorted(v for _, v in pairs)

    def pct(p: float) -> float:
        i = min(len(lats) - 1, max(0, math.ceil(p / 100.0 * len(lats)) - 1))
        return round(lats[i], 6)

    slowest = sorted(pairs, key=lambda cv: cv[1], reverse=True)[:top_k]
    return {
        "n": len(pairs),
        "p50_s": pct(50),
        "p95_s": pct(95),
        "p99_s": pct(99),
        "max_s": round(lats[-1], 6),
        "slowest": [[c, round(v, 6)] for c, v in slowest],
    }
