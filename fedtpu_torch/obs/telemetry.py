"""The Telemetry facade: one object gating the metrics registry on a mode,
the port's own copy of ``fedtpu/obs/telemetry.py``'s ``off`` and ``basic``.

``FedConfig.telemetry`` selects how much the framework measures itself:

- ``"off"``: nothing. ``span()`` returns a shared no-op and the metric
  getters return shared no-op instruments. A registry still exists, so
  handing ``telemetry.registry`` to the ft classes is unconditional, and
  the round record's own wire and phase accounting stays.
- ``"basic"`` (the default): the registry is live (counters, gauges,
  histograms, exportable as Prometheus text); no spans.
- ``"trace"``: basic plus the span tracer. Not ported yet (ROADMAP.md
  Queue 1, item 5b).

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

TELEMETRY_MODES = ("off", "basic", "trace")


class _NullSpan:
    """The shared no-op span ``span()`` returns below ``trace``; ``id`` is
    None so ``parent=span.id`` chains stay valid."""

    __slots__ = ()
    id = None

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


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


NULL_SPAN = _NullSpan()
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
    """Mode-gated owner of one :class:`MetricsRegistry`."""

    def __init__(self, mode: str = "basic",
                 registry: Optional[MetricsRegistry] = None,
                 role: Optional[str] = None):
        self.mode = validate_telemetry_mode(mode)
        if mode == "trace":
            from fedtpu_torch.config import not_ported

            raise not_ported("telemetry='trace' (spans and trace propagation)", "slice 8, part 5b")
        # Component identity for the flight recorder's dump names: "primary",
        # "backup", "client:<addr>", "engine", ...; the owner stamps it.
        self.role = role
        self.enabled = mode != "off"
        # A registry exists even when off; the gate is in the getters.
        self.registry = registry if registry is not None else MetricsRegistry()

    # ------------------------------------------------------------- spans
    def span(self, name: str, parent=None, **args):
        return NULL_SPAN

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
