"""fedtpu_torch.obs: the span tracer, trace propagation, the metrics
registry, its exporters, the flight recorder and the status plane, the port
of fedtpu's ``fedtpu/obs`` (all but the performance observatory,
``fedtpu/obs/profile.py``).

- :mod:`~fedtpu_torch.obs.registry`: thread-safe counters, gauges and
  histograms;
- :mod:`~fedtpu_torch.obs.trace`: nested spans, Chrome-trace (Perfetto)
  export, the ``torch.profiler.record_function`` bridge;
- :mod:`~fedtpu_torch.obs.propagate`: trace-context propagation over gRPC
  (``fedtpu-trace-bin`` metadata; merge with ``tools/trace_merge.py``);
- :mod:`~fedtpu_torch.obs.exporters`: schema-versioned JSONL round records
  and Prometheus text;
- :mod:`~fedtpu_torch.obs.telemetry`: :class:`Telemetry`, the tracer and
  the registry gated on ``FedConfig.telemetry`` (``off | basic | trace``);
- :mod:`~fedtpu_torch.obs.flight`: the crash flight recorder;
- :mod:`~fedtpu_torch.obs.http`: ``/metrics`` ``/healthz`` ``/statusz``
  ``/flightz`` and the :class:`StatusBoard` behind ``/statusz``;
- :mod:`~fedtpu_torch.obs.proc`: the process's resident set and open
  descriptors.

The span names, metric names, help strings, labels and buckets are
fedtpu's (``docs/OBSERVABILITY.md`` lists them). Nothing here imports torch
or grpc when it loads, so config-only and ft users pay for no backend.
"""

from fedtpu_torch.obs.exporters import (
    SCHEMA_VERSION,
    RoundRecordWriter,
    parse_prometheus_text,
    prometheus_text,
    read_round_records,
    write_prometheus,
)
from fedtpu_torch.obs.flight import FlightRecorder
from fedtpu_torch.obs.http import ObsServer, StatusBoard
from fedtpu_torch.obs.proc import process_fd_count, process_rss_bytes
from fedtpu_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_global_registry,
)
from fedtpu_torch.obs.telemetry import (
    NULL_TELEMETRY,
    TELEMETRY_MODES,
    Telemetry,
    validate_telemetry_mode,
)
from fedtpu_torch.obs.trace import SpanTracer, load_chrome_trace, write_chrome_trace

__all__ = [
    "FlightRecorder",
    "ObsServer",
    "StatusBoard",
    "process_fd_count",
    "process_rss_bytes",
    "SCHEMA_VERSION",
    "RoundRecordWriter",
    "parse_prometheus_text",
    "prometheus_text",
    "read_round_records",
    "write_prometheus",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_global_registry",
    "NULL_TELEMETRY",
    "TELEMETRY_MODES",
    "Telemetry",
    "validate_telemetry_mode",
    "SpanTracer",
    "load_chrome_trace",
    "write_chrome_trace",
]
