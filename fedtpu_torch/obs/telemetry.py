"""The Telemetry facade: one object gating the tracer and the metrics
registry on a mode, the port's own copy of ``fedtpu/obs/telemetry.py``.

``FedConfig.telemetry`` selects how much the framework measures itself:

- ``"off"``: nothing. ``span()`` returns a shared no-op and the metric
  getters return shared no-op instruments. A registry still exists, so
  handing ``telemetry.registry`` to the ft classes is unconditional, and
  the round record's own wire and phase accounting stays.
- ``"basic"`` (the default): the registry is live (counters, gauges,
  histograms, exportable as Prometheus text); no spans.
- ``"trace"``: basic plus the span tracer (Chrome-trace export, and the
  ``torch.profiler.record_function`` bridge in place of fedtpu's jax
  ``TraceAnnotation``). Spans cost about a microsecond each: a diagnosis
  mode, off the default path.

Each engine or server owns one Telemetry; its registry is that component's
metric namespace, and the ft helpers it builds count into the same one.
"""

from __future__ import annotations

from typing import Optional

from fedtpu_torch.obs.registry import (
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from fedtpu_torch.obs.trace import NULL_SPAN, SpanTracer

TELEMETRY_MODES = ("off", "basic", "trace")


class _NullCounter:
    __slots__ = ()
    kind = "counter"
    value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        return None


class _NullGauge:
    __slots__ = ()
    kind = "gauge"
    value = 0.0

    def set(self, value: float) -> None:
        return None

    def inc(self, amount: float = 1.0) -> None:
        return None


class _NullHistogram:
    __slots__ = ()
    kind = "histogram"
    count = 0
    sum = 0.0

    def observe(self, value: float) -> None:
        return None


_NULL_COUNTER = _NullCounter()
_NULL_GAUGE = _NullGauge()
_NULL_HISTOGRAM = _NullHistogram()


def validate_telemetry_mode(mode: str) -> str:
    if mode not in TELEMETRY_MODES:
        raise ValueError(
            f"unknown telemetry mode {mode!r}; have off | basic | trace"
        )
    return mode


class Telemetry:
    """Mode-gated bundle of one :class:`MetricsRegistry` and (in ``trace``
    mode) one :class:`SpanTracer`. ``bridge_profiler`` is fedtpu's
    ``bridge_jax``; it defaults to on whenever the mode traces."""

    def __init__(self, mode: str = "basic",
                 registry: Optional[MetricsRegistry] = None,
                 bridge_profiler: Optional[bool] = None,
                 role: Optional[str] = None):
        self.mode = validate_telemetry_mode(mode)
        # Component identity for multi-process trace stitching and the
        # flight recorder's dump names: "primary", "backup",
        # "client:<addr>", "engine", ...; the owner stamps it.
        self.role = role
        self.enabled = mode != "off"
        self.tracing = mode == "trace"
        # A registry exists even when off; the gate is in the getters.
        self.registry = registry if registry is not None else MetricsRegistry()
        if bridge_profiler is None:
            bridge_profiler = self.tracing
        self.tracer = SpanTracer(bridge_profiler=bridge_profiler) if self.tracing else None

    # ------------------------------------------------------------- spans
    def span(self, name: str, parent=None, **args):
        if self.tracer is None:
            return NULL_SPAN
        return self.tracer.span(name, parent=parent, **args)

    def trace_events(self):
        return self.tracer.events() if self.tracer is not None else []

    def export_trace(self, path: str) -> None:
        """Write the collected spans as a Perfetto-loadable Chrome trace; a
        no-op below ``trace``. The ``metadata`` block (trace id, role, pid,
        wall_start) is what ``tools/trace_merge.py`` keys on when it
        stitches per-process files into one federation timeline."""
        if self.tracer is None:
            return
        import os

        from fedtpu_torch.obs.trace import write_chrome_trace

        write_chrome_trace(
            self.tracer.events(), path,
            metadata={
                "trace_id": self.tracer.trace_id,
                "role": self.role or f"pid{os.getpid()}",
                "pid": os.getpid(),
                "wall_start": self.tracer.wall_start,
            },
        )

    # ----------------------------------------------------------- metrics
    def counter(self, name: str, help: str = "", labels=None) -> Counter:
        if not self.enabled:
            return _NULL_COUNTER  # type: ignore[return-value]
        return self.registry.counter(name, help, labels)

    def gauge(self, name: str, help: str = "", labels=None) -> Gauge:
        if not self.enabled:
            return _NULL_GAUGE  # type: ignore[return-value]
        return self.registry.gauge(name, help, labels)

    def histogram(self, name: str, help: str = "", labels=None,
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        if not self.enabled:
            return _NULL_HISTOGRAM  # type: ignore[return-value]
        return self.registry.histogram(name, help, labels, buckets=buckets)

    def export_prometheus(self, path: str) -> None:
        from fedtpu_torch.obs.exporters import write_prometheus

        write_prometheus(self.registry, path)


# Shared disabled instance for components with no telemetry of their own.
NULL_TELEMETRY = Telemetry("off")
