"""Span tracer: the port's own copy of ``fedtpu/obs/trace.py``.

Spans are recorded as Chrome trace-event "complete" events (``ph: "X"``),
so a dump loads directly in Perfetto or ``chrome://tracing``. Two nesting
signals are emitted:

- **time containment** per thread track (``tid``): what the viewers draw;
- explicit ``args.span_id`` / ``args.parent_id`` links: what the tests and
  ``tools/trace_merge.py`` read, and the only signal that holds across
  threads (a ``decode`` span in a collect worker is parented to the main
  thread's ``round`` span by id, not by track).

Parentage defaults to the innermost open span **on the same thread** (a
thread-local stack); a child on another thread passes ``parent=``
explicitly (:meth:`SpanTracer.span`, :meth:`SpanTracer.current_id`).

The profiler bridge: with ``bridge_profiler=True`` every span also enters a
``torch.profiler.record_function`` range of the same name, so under an
active ``torch.profiler.profile`` the kernels a span launches nest under it
in the profiler's timeline. fedtpu's keyword is ``bridge_jax`` and its
range a ``jax.profiler.TraceAnnotation``; the port's is
``bridge_profiler`` and torch's range. Outside an active profiler the
range costs little; torch is imported when the first span opens and a
failure to enter the range is tolerated, so building a tracer never loads
a backend.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional


class _NullSpan:
    """Shared no-op span: what ``Telemetry.span`` returns below ``trace``
    mode. ``id`` is None so ``parent=span.id`` chains stay valid."""

    __slots__ = ()
    id = None

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


NULL_SPAN = _NullSpan()


def _record_function(name: str):
    """A ``torch.profiler.record_function`` range of ``name``; torch is
    imported when the first bridged span opens, not when the tracer is
    built, and a span whose range fails to open runs without one."""
    from torch.profiler import record_function

    return record_function(name)


class _Span:
    __slots__ = ("_tracer", "name", "args", "id", "parent", "_t0", "_range")

    def __init__(self, tracer: "SpanTracer", name: str,
                 parent: Optional[int], args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.args = args
        self.parent = parent
        self.id = None
        self._t0 = 0.0
        self._range = None

    def __enter__(self) -> "_Span":
        tr = self._tracer
        self.id = next(tr._ids)
        if self.parent is None:
            self.parent = tr.current_id()
        tr._stack().append(self.id)
        if tr._annotation is not None:
            try:
                self._range = tr._annotation(self.name)
                self._range.__enter__()
            except Exception:
                self._range = None
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.monotonic()
        if self._range is not None:
            try:
                self._range.__exit__(*exc)
            except Exception:
                pass
        tr = self._tracer
        stack = tr._stack()
        if stack and stack[-1] == self.id:
            stack.pop()
        args = {"span_id": self.id}
        if self.parent is not None:
            args["parent_id"] = self.parent
        args.update(self.args)
        tr._record({
            "name": self.name,
            "ph": "X",
            "ts": round((self._t0 - tr._t0) * 1e6, 3),
            "dur": round((t1 - self._t0) * 1e6, 3),
            "pid": tr._pid,
            "tid": threading.get_ident() & 0x7FFFFFFF,
            "args": args,
        })


class SpanTracer:
    """Collects spans; thread-safe; export with :func:`write_chrome_trace`."""

    def __init__(self, bridge_profiler: bool = False):
        self._events: List[dict] = []
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self.wall_start = time.time()
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._pid = os.getpid()
        # The federation-wide trace identity: random per tracer, and
        # overwritten on a remote client when a propagated context arrives
        # (fedtpu_torch.obs.propagate.adopt), so every process of one run
        # shares the coordinator's id. Span ids stay process-local;
        # tools/trace_merge.py qualifies them by role.
        self.trace_id: str = os.urandom(8).hex()
        # Optional per-event hook (the flight recorder's record_span),
        # called with the finished event outside the lock; it never raises
        # into the traced code.
        self.sink = None
        self._annotation = _record_function if bridge_profiler else None

    def _stack(self) -> List[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, event: dict) -> None:
        with self._lock:
            self._events.append(event)
        sink = self.sink
        if sink is not None:
            try:
                sink(event)
            except Exception:
                pass

    # ------------------------------------------------------------------ api
    def span(self, name: str, parent: Optional[int] = None,
             **args: Any) -> _Span:
        """Context manager for one timed span. ``parent`` overrides the
        thread-local nesting (needed when the span runs on another thread
        than its logical parent)."""
        return _Span(self, name, parent, args)

    def current_id(self) -> Optional[int]:
        """The innermost open span id on this thread (None outside any
        span): capture it before handing work to another thread, then pass
        it as that thread's ``parent=``."""
        stack = getattr(self._local, "stack", None)
        return stack[-1] if stack else None

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()


def write_chrome_trace(events: List[dict], path: str,
                       metadata: Optional[Dict[str, Any]] = None) -> None:
    """Write events as a Perfetto-loadable JSON object (atomic rename).

    ``metadata`` (ignored by viewers, read by ``tools/trace_merge.py``)
    carries what a multi-process merge needs: the federation ``trace_id``,
    this process's ``role`` and ``pid``, and ``wall_start``, the wall-clock
    time of the tracer's monotonic zero, which aligns each process's
    relative timestamps on one timeline.
    """
    doc = {
        "traceEvents": list(events),
        "displayTimeUnit": "ms",
    }
    if metadata:
        doc["metadata"] = dict(metadata)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(doc, fh)
    os.replace(tmp, path)


def load_chrome_trace(path: str) -> List[dict]:
    """Read back a :func:`write_chrome_trace` dump (the bare-array form too:
    both are valid Chrome trace JSON)."""
    with open(path) as fh:
        doc = json.load(fh)
    if isinstance(doc, list):
        return doc
    return doc["traceEvents"]
