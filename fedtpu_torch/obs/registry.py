"""Thread-safe metrics registry: counters, gauges, histograms.

The port's own copy of ``fedtpu/obs/registry.py``. The data model is
Prometheus's (counter, gauge, histogram, optional labels), which
:func:`~fedtpu_torch.obs.exporters.prometheus_text` renders; the code needs
nothing beyond the standard library: one ``threading.Lock`` per metric, no
background thread, no torch import (the ft classes stay importable without
a backend). One ``inc`` or ``observe`` is a lock and a float add.

The bucket search, the kind collision and the sorted order of
:meth:`MetricsRegistry.snapshot` are fedtpu's, so a port registry renders
the same Prometheus text as fedtpu's for the same events.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Tuple

# Default histogram buckets, in seconds: spans phase timings from sub-ms
# decode work to multi-minute straggler waits. Cumulative ("le") rendering
# happens at export time; observation stores per-bucket counts.
DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


class Counter:
    """Monotonically increasing, thread-safe float counter.

    Also used standalone, outside any registry: the coordinator's collect
    workers ``inc()`` it without locking of their own, and the round reads
    ``value`` after the join.
    """

    kind = "counter"

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


class Gauge:
    """Thread-safe settable value (last-write-wins)."""

    kind = "gauge"

    def __init__(self) -> None:
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram: per-bucket counts + sum + count + min/max."""

    kind = "histogram"

    def __init__(self, buckets: Iterable[float] = DEFAULT_BUCKETS) -> None:
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets: Tuple[float, ...] = tuple(bs)
        self._counts = [0] * (len(bs) + 1)  # last slot = +Inf overflow
        self._sum = 0.0
        self._count = 0
        self._min = float("inf")
        self._max = float("-inf")
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            i = 0
            for i, b in enumerate(self.buckets):  # noqa: B007
                if value <= b:
                    break
            else:
                i = len(self.buckets)
            self._counts[i] += 1
            self._sum += value
            self._count += 1
            self._min = min(self._min, value)
            self._max = max(self._max, value)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def snapshot(self) -> dict:
        """{"count", "sum", "min", "max", "buckets": {le: cumulative}}."""
        with self._lock:
            cum, out = 0, {}
            for b, c in zip(self.buckets, self._counts):
                cum += c
                out[b] = cum
            return {
                "count": self._count,
                "sum": self._sum,
                "min": self._min if self._count else None,
                "max": self._max if self._count else None,
                "buckets": out,
            }


def _label_key(labels: Optional[Dict[str, str]]) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Get-or-create metric store keyed by ``(name, labels)``.

    Creation is locked; the returned metric objects carry their own locks,
    so hot-path ``inc``/``observe`` calls never contend on the registry.
    A name is bound to ONE kind — asking for ``counter("x")`` after
    ``gauge("x")`` raises instead of silently aliasing.
    """

    def __init__(self) -> None:
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], object] = {}
        self._help: Dict[str, str] = {}
        self._kinds: Dict[str, str] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help: str, labels, **kwargs):
        key = (name, _label_key(labels))
        with self._lock:
            existing_kind = self._kinds.get(name)
            if existing_kind is not None and existing_kind != cls.kind:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{existing_kind}, cannot re-register as {cls.kind}"
                )
            metric = self._metrics.get(key)
            if metric is None:
                metric = cls(**kwargs)
                self._metrics[key] = metric
                self._kinds[name] = cls.kind
                if help:
                    self._help[name] = help
            return metric

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Dict[str, str]] = None,
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def snapshot(self) -> dict:
        """Plain-dict dump: {name: [{"labels": {...}, ...metric fields}]}."""
        with self._lock:
            items = list(self._metrics.items())
        out: Dict[str, List[dict]] = {}
        for (name, lkey), metric in sorted(items, key=lambda kv: kv[0]):
            entry: dict = {"labels": dict(lkey), "kind": metric.kind}
            if isinstance(metric, Histogram):
                entry.update(metric.snapshot())
            else:
                entry["value"] = metric.value
            out.setdefault(name, []).append(entry)
        return out

    def help_text(self, name: str) -> str:
        with self._lock:
            return self._help.get(name, "")


_GLOBAL = MetricsRegistry()


def get_global_registry() -> MetricsRegistry:
    """Process-wide default registry, for modules with no owner to hand
    them one (standalone ft machinery, tools). Components with a config
    (engines, servers) use their own
    :class:`~fedtpu_torch.obs.telemetry.Telemetry` registry instead."""
    return _GLOBAL
