"""Primary/backup failover: the port's own copy of
``fedtpu/ft/failover.py``.

The primary pings the backup each period with ``CheckIfPrimaryUp(req=
recovering)``; the backup's watchdog promotes it to acting primary when no
ping has landed within the timeout, and a returning primary's first ping
(``recovering``) demotes it back. :class:`FailoverStateMachine` is that
protocol as a pure, event-driven machine: ``on_ping`` and
``check_watchdog`` transitions over an injected clock, promotion and
demotion as callbacks, so it runs under a fake clock in tests.
:class:`PrimaryPinger` and :class:`WatchdogRunner` are its two threads.
Transitions are logged; fedtpu also counts them into a metrics registry and
a flight recorder, which the port does not have yet (``metrics=None`` and
``flight=None`` only).
"""

from __future__ import annotations

import enum
import logging
import threading
import time
from typing import Callable, Optional

from fedtpu_torch.ft.membership import refuse_metrics

log = logging.getLogger("fedtpu_torch.ft")


class Role(enum.Enum):
    PRIMARY = "primary"
    BACKUP = "backup"
    ACTING_PRIMARY = "acting_primary"


class FailoverStateMachine:
    """The backup's side of the protocol.

    - BACKUP --[watchdog expiry]--> ACTING_PRIMARY (``on_promote``);
    - ACTING_PRIMARY --[ping with recovering]--> BACKUP (``on_demote``).

    The watchdog arms only once a primary has been heard (a backup with no
    replicated model would otherwise serve a random init);
    ``arm_without_ping=True`` arms it at construction."""

    def __init__(
        self,
        timeout: float = 10.0,
        on_promote: Optional[Callable[[], None]] = None,
        on_demote: Optional[Callable[[], None]] = None,
        clock: Callable[[], float] = time.monotonic,
        arm_without_ping: bool = False,
        metrics: Optional[object] = None,
        flight: Optional[object] = None,
    ):
        refuse_metrics(metrics)
        if flight is not None:
            from fedtpu_torch.config import not_ported

            raise not_ported("a flight recorder (flight=)", "slice 8")
        self.timeout = timeout
        self.on_promote = on_promote
        self.on_demote = on_demote
        self.clock = clock
        self.role = Role.BACKUP
        self._last_ping: Optional[float] = clock() if arm_without_ping else None
        self._lock = threading.Lock()

    def _transition_event(self, src: Role, dst: Role, why: str) -> None:
        log.warning("failover: %s -> %s (%s)", src.value, dst.value, why)

    def on_ping(self, recovering: bool) -> int:
        """One CheckIfPrimaryUp; returns the PingResponse value (1: "I was
        acting primary and now demote")."""
        demote = False
        with self._lock:
            self._last_ping = self.clock()
            if recovering and self.role is Role.ACTING_PRIMARY:
                self.role = Role.BACKUP
                demote = True
        if demote:
            self._transition_event(Role.ACTING_PRIMARY, Role.BACKUP, "primary recovered")
            if self.on_demote is not None:
                self.on_demote()
            return 1
        return 0

    def check_watchdog(self) -> bool:
        """Promote if the primary has been silent past the timeout; True
        when this call promoted."""
        promote = False
        with self._lock:
            if (
                self.role is Role.BACKUP
                and self._last_ping is not None
                and self.clock() - self._last_ping > self.timeout
            ):
                self.role = Role.ACTING_PRIMARY
                promote = True
        if promote:
            self._transition_event(
                Role.BACKUP, Role.ACTING_PRIMARY, f"no primary ping for > {self.timeout:.1f}s"
            )
            if self.on_promote is not None:
                self.on_promote()
        return promote

    def seconds_since_ping(self) -> float:
        """Seconds since the last ping; +inf if never pinged."""
        with self._lock:
            if self._last_ping is None:
                return float("inf")
            return self.clock() - self._last_ping


class _Periodic:
    """A daemon thread calling ``self._step()`` every ``period`` seconds."""

    period: float

    def _init_thread(self) -> None:
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.period):
            self._step()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


class PrimaryPinger(_Periodic):
    """The primary's pinger: ``recovering`` on the first ping after a
    (re)start, cleared once one is delivered. ``send(recovering) ->
    Optional[int]`` is injected (None: the backup is unreachable)."""

    def __init__(
        self,
        send: Callable[[bool], Optional[int]],
        period: float = 1.0,
        recovering: bool = True,
        metrics: Optional[object] = None,
    ):
        refuse_metrics(metrics)
        self.send = send
        self.period = period
        self.recovering = recovering
        self._init_thread()

    def tick(self) -> Optional[int]:
        result = self.send(self.recovering)
        if result is not None:
            self.recovering = False
        return result

    def _step(self) -> None:
        self.tick()


class WatchdogRunner(_Periodic):
    """Drives :meth:`FailoverStateMachine.check_watchdog` every
    ``period`` seconds."""

    def __init__(self, machine: FailoverStateMachine, period: float = 1.0):
        self.machine = machine
        self.period = period
        self._init_thread()

    def _step(self) -> None:
        self.machine.check_watchdog()
