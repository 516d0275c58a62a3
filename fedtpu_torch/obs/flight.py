"""Crash flight recorder: the port's own copy of ``fedtpu/obs/flight.py``.

A :class:`FlightRecorder` keeps the last ``capacity`` structured events in
a ring (round completions, fences, membership changes, ft transitions,
chaos injections, warning+ log lines) and dumps the whole ring as JSON when
something goes wrong:

- an **unhandled exception** (``sys.excepthook`` and
  ``threading.excepthook``, chained to the previous hooks);
- **SIGUSR1**, an operator's snapshot of a live process;
- **every failover promote or demote**
  (:class:`fedtpu_torch.ft.FailoverStateMachine`).

Dumps land at ``artifacts/flightrecorder-<role>-<pid>.json`` (atomic
rename; each dump overwrites the process's previous one). Recording is a
deque append under a lock. A signal that arrives while the lock is held
must not deadlock the handler, so ``dump`` takes the lock with a timeout
and falls back to a lock-free copy; it never raises.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import sys
import threading
import time
import traceback
from collections import deque
from typing import List, Optional


def _sanitize(role: str) -> str:
    return "".join(c if c.isalnum() or c in "-_." else "-" for c in role)


class _FlightLogHandler(logging.Handler):
    """Feeds warning+ log records (ft transitions, straggler warnings,
    RpcError marks) into the ring."""

    def __init__(self, recorder: "FlightRecorder"):
        super().__init__(level=logging.WARNING)
        self._recorder = recorder

    def emit(self, record: logging.LogRecord) -> None:
        try:
            self._recorder.record(
                "log",
                logger=record.name,
                level=record.levelname,
                message=record.getMessage(),
            )
        except Exception:
            pass


class FlightRecorder:
    def __init__(
        self,
        capacity: int = 512,
        role: str = "",
        artifacts_dir: str = "artifacts",
    ):
        self.role = role or f"pid{os.getpid()}"
        self.artifacts_dir = artifacts_dir
        self._events: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._created = time.time()
        self._dump_count = 0
        self._installed = False
        self._log_handler: Optional[_FlightLogHandler] = None
        self._prev_excepthook = None
        self._prev_threading_excepthook = None
        self._prev_signal = None

    # ------------------------------------------------------------ recording
    def record(self, kind: str, **fields) -> None:
        event = {"t": round(time.time(), 6), "kind": kind}
        event.update(fields)
        with self._lock:
            self._events.append(event)

    def record_span(self, chrome_event: dict) -> None:
        """A span tracer's sink: keep a completed Chrome-trace span's
        name, duration and args, drop the viewer fields."""
        self.record(
            "span",
            name=chrome_event.get("name"),
            dur_us=chrome_event.get("dur"),
            args=chrome_event.get("args", {}),
        )

    def snapshot(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    # ------------------------------------------------------------- dumping
    def dump_path(self) -> str:
        return os.path.join(
            self.artifacts_dir,
            f"flightrecorder-{_sanitize(self.role)}-{os.getpid()}.json",
        )

    def dump(self, reason: str, path: Optional[str] = None,
             extra: Optional[dict] = None) -> Optional[str]:
        """Write the ring + context to ``path`` (default
        :meth:`dump_path`); returns the path, or None if even the
        best-effort write failed (a dump must never raise into a crashing
        process)."""
        got_lock = self._lock.acquire(timeout=0.5)
        try:
            try:
                events = list(self._events)
            except RuntimeError:  # mutated during lock-free iteration
                events = []
        finally:
            if got_lock:
                self._lock.release()
        doc = {
            "reason": reason,
            "role": self.role,
            "pid": os.getpid(),
            "dumped_at": time.time(),
            "recorder_started_at": self._created,
            "dump_count": self._dump_count + 1,
            "num_events": len(events),
            "events": events,
        }
        if extra:
            doc.update(extra)
        path = path or self.dump_path()
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            tmp = f"{path}.tmp{os.getpid()}"
            with open(tmp, "w") as fh:
                json.dump(doc, fh, default=str)
            os.replace(tmp, path)
        except OSError:
            return None
        self._dump_count += 1
        return path

    # ------------------------------------------------------ process hooks
    def install(
        self,
        signum: Optional[int] = signal.SIGUSR1,
        logger_names=("fedtpu_torch", "fedtpu_torch.ft", "fedtpu_torch.federation"),
    ) -> "FlightRecorder":
        """Arm the process-wide dump triggers (library users usually wire
        components directly instead):

        - chain ``sys.excepthook`` / ``threading.excepthook`` to dump with
          the traceback before the previous hook runs;
        - ``signum`` (default SIGUSR1, None to skip; silently skipped off
          the main thread where Python forbids signal registration) dumps
          without exiting;
        - attach a warning+ capture handler to ``logger_names``.
        """
        if self._installed:
            return self
        self._installed = True

        self._prev_excepthook = sys.excepthook

        def _excepthook(exc_type, exc, tb):
            self.record(
                "exception",
                type=exc_type.__name__,
                message=str(exc),
                traceback="".join(
                    traceback.format_exception(exc_type, exc, tb)
                )[-4000:],
            )
            self.dump(reason=f"unhandled:{exc_type.__name__}")
            if self._prev_excepthook is not None:
                self._prev_excepthook(exc_type, exc, tb)

        sys.excepthook = _excepthook

        self._prev_threading_excepthook = threading.excepthook

        def _thread_hook(hook_args):
            if hook_args.exc_type is not SystemExit:
                self.record(
                    "exception",
                    type=hook_args.exc_type.__name__,
                    message=str(hook_args.exc_value),
                    thread=getattr(hook_args.thread, "name", "?"),
                )
                self.dump(
                    reason=f"thread-unhandled:{hook_args.exc_type.__name__}"
                )
            if self._prev_threading_excepthook is not None:
                self._prev_threading_excepthook(hook_args)

        threading.excepthook = _thread_hook

        if signum is not None:
            try:
                self._prev_signal = (
                    signum, signal.signal(signum, self._on_signal)
                )
            except ValueError:  # not the main thread
                self._prev_signal = None

        for name in logger_names:
            if self._log_handler is None:
                self._log_handler = _FlightLogHandler(self)
            logging.getLogger(name).addHandler(self._log_handler)
        self._log_loggers = list(logger_names)
        return self

    def _on_signal(self, signum, frame) -> None:
        self.dump(reason=f"signal:{signal.Signals(signum).name}")

    def uninstall(self) -> None:
        """Tests only: restore the hooks this instance installed."""
        if not self._installed:
            return
        self._installed = False
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
        if self._prev_threading_excepthook is not None:
            threading.excepthook = self._prev_threading_excepthook
        if self._prev_signal is not None:
            signum, prev = self._prev_signal
            try:
                signal.signal(signum, prev)
            except ValueError:
                pass
        if self._log_handler is not None:
            for name in getattr(self, "_log_loggers", ()):
                logging.getLogger(name).removeHandler(self._log_handler)
