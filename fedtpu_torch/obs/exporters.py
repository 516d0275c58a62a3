"""Exporters: versioned JSONL round records and Prometheus text: the port's
own copy of ``fedtpu/obs/exporters.py``.

:class:`RoundRecordWriter` has :class:`fedtpu_torch.utils.metrics.
MetricsLogger`'s surface (``log(step, **fields)``, the same field
coercion, append and flush) plus a pinned ``schema_version`` on every
record, so readers can detect a renamed field. ``MetricsLogger`` stays the
unversioned ("v0") writer.

Schema history:
  - (unversioned, "v0"): no ``schema_version`` key; readers treat such
    records as version 0.
  - 1: adds ``schema_version``; the payload keys are whatever the producer
    logs. Bump it only when an existing key changes meaning or goes.

:func:`prometheus_text` renders a registry byte for byte as fedtpu's does:
integers below 1e15 print without a decimal point, every other value and
every bucket bound through ``repr`` of a float.
"""

from __future__ import annotations

import json
import os
import re
import sys
import time
from typing import Any, Dict, List, Optional

from fedtpu_torch.obs.registry import MetricsRegistry

SCHEMA_VERSION = 1


class RoundRecordWriter:
    """JSONL round-record sink with a pinned schema version; takes a
    ``MetricsLogger``'s place (same ``log``/``close``/context-manager
    surface) wherever a ``logger=`` is taken."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self._path = path
        self._echo = echo
        self._fh = open(path, "a") if path else None
        self._t0 = time.time()

    def log(self, step: int, **fields: Any) -> None:
        rec: Dict[str, Any] = {
            "schema_version": SCHEMA_VERSION,
            "step": int(step),
            "t": round(time.time() - self._t0, 4),
        }
        for k, v in fields.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        line = json.dumps(rec)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self._echo:
            print(line, file=sys.stderr)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "RoundRecordWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_round_records(path: str) -> List[dict]:
    """Parse a round-record JSONL file. Unparseable lines are skipped (a
    crashed writer can truncate the tail); records without a
    ``schema_version`` are legacy v0 and get ``schema_version: 0`` stamped
    so consumers can branch on one key."""
    records = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if not isinstance(rec, dict):
                continue
            rec.setdefault("schema_version", 0)
            records.append(rec)
    return records


# ------------------------------------------------------------- prometheus
def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{str(v).replace(chr(92), chr(92) * 2).replace(chr(34), chr(92) + chr(34))}"'
        for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    """Full-precision sample rendering: ``%g``-style formatting silently
    rounds to 6 significant digits, which corrupts large byte counters."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def prometheus_text(registry: MetricsRegistry) -> str:
    """Render the registry in the Prometheus text exposition format
    (``# HELP`` / ``# TYPE`` + samples; histograms as cumulative
    ``_bucket{le=...}`` series plus ``_sum`` / ``_count``)."""
    lines: List[str] = []
    snap = registry.snapshot()
    for name, entries in snap.items():
        help_line = registry.help_text(name)
        if help_line:
            lines.append(f"# HELP {name} {help_line}")
        lines.append(f"# TYPE {name} {entries[0]['kind']}")
        for entry in entries:
            labels = entry["labels"]
            if entry["kind"] == "histogram":
                for le, cum in entry["buckets"].items():
                    lines.append(
                        f"{name}_bucket"
                        f"{_fmt_labels(dict(labels, le=repr(float(le))))} {cum}"
                    )
                lines.append(
                    f"{name}_bucket{_fmt_labels(dict(labels, le='+Inf'))} "
                    f"{entry['count']}"
                )
                lines.append(
                    f"{name}_sum{_fmt_labels(labels)} "
                    f"{_fmt_value(entry['sum'])}"
                )
                lines.append(
                    f"{name}_count{_fmt_labels(labels)} {entry['count']}"
                )
            else:
                lines.append(
                    f"{name}{_fmt_labels(labels)} "
                    f"{_fmt_value(entry['value'])}"
                )
    return "\n".join(lines) + "\n"


def write_prometheus(registry: MetricsRegistry, path: str) -> None:
    """Atomic file dump of :func:`prometheus_text`, the pull-less stand-in
    for a ``/metrics`` endpoint (node_exporter's textfile collector reads
    it)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        fh.write(prometheus_text(registry))
    os.replace(tmp, path)


_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$"
)
_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def parse_prometheus_text(text: str) -> Dict[str, Dict[str, float]]:
    """Parse the exposition format back into
    ``{metric_name: {label_string: value}}`` (label_string is the sorted
    ``k=v,...`` form, ``""`` for no labels); raises ValueError on a
    malformed sample line so a broken dump fails loudly."""
    out: Dict[str, Dict[str, float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"malformed prometheus sample line: {line!r}")
        labels = {}
        if m.group("labels"):
            labels = {k: v for k, v in _LABEL_RE.findall(m.group("labels"))}
        lkey = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
        out.setdefault(m.group("name"), {})[lkey] = float(m.group("value"))
    return out
