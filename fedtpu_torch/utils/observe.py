"""What the coordinator's round record needs of fedtpu's observability
package: the port's own copies of ``latency_summary``
(``fedtpu/obs/profile.py``), ``process_rss_bytes`` (``fedtpu/obs/proc.py``)
and the thread-safe ``Counter`` (``fedtpu/obs/registry.py``), and
:class:`CounterTable`, the named counters of fedtpu's registry that the
retry helper counts into."""

from __future__ import annotations

import math
import resource
import sys
import threading
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


def process_rss_bytes() -> int:
    """The process's current resident set in bytes: ``VmRSS`` of
    ``/proc/self/status`` on Linux, else the high-water mark; 0 when
    neither is readable."""
    try:
        with open("/proc/self/status", encoding="ascii", errors="replace") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    try:
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return peak if sys.platform == "darwin" else peak * 1024
    except Exception:
        return 0


class Counter:
    """A thread-safe float counter: collect workers ``inc()`` it without
    locking of their own, and the round reads ``value`` after the join."""

    def __init__(self) -> None:
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increment must be >= 0, got {amount}")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class CounterTable:
    """Named, labelled counters: the ``counter(name, help, labels)`` face
    of fedtpu's metrics registry, enough for
    :func:`fedtpu_torch.transport.retry.call_with_retry` to count
    ``fedtpu_rpc_retries_total{rpc}``. No export."""

    def __init__(self) -> None:
        self._counters: Dict[Tuple[str, Tuple], Counter] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help: str = "", labels: Dict[str, str] = None) -> Counter:
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            return self._counters.setdefault(key, Counter())

    def histogram(self, name: str, help: str = "", buckets=(), labels: Dict[str, str] = None):
        """fedtpu's registry histograms (``run_async``'s
        ``fedtpu_async_staleness`` among them) are not kept here."""
        from fedtpu_torch.config import not_ported

        raise not_ported(f"the metrics registry's histogram {name!r}", "slice 8, part 5")

    def value(self, name: str, **labels: str) -> float:
        """The counter's value, 0 when it never counted."""
        with self._lock:
            c = self._counters.get((name, tuple(sorted(labels.items()))))
        return 0.0 if c is None else c.value
