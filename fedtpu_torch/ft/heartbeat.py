"""Client failure detection and recovery: the port's own copy of
``fedtpu/ft/heartbeat.py``.

Any RpcError of StartTrain or SendModel marks a client dead; a
:class:`HeartbeatMonitor` re-probes the dead each period and, when a probe
answers, pushes the current global model to the client before marking it
alive, so a revived client never gets a StartTrain ahead of the model.
The probe and the resync are injected, and :meth:`HeartbeatMonitor.tick`
runs one pass by hand, so the loop is testable without sleeps. With
``metrics=`` it counts misses and failed resyncs and times each probe under
fedtpu's names. :class:`ClientRegistry` is fedtpu's fixed-roster name for
:class:`~fedtpu_torch.ft.membership.MembershipTable`.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, List, Optional

from fedtpu_torch.ft.membership import MembershipTable

log = logging.getLogger("fedtpu_torch.ft")


class ClientRegistry(MembershipTable):
    """The alive/dead registry keyed by client id: a
    :class:`MembershipTable` under fedtpu's older name."""


class HeartbeatMonitor:
    """Re-probe dead clients; resync and revive on an answer.

    ``probe(client) -> bool`` and ``resync(client) -> None`` are injected.
    The probes of several dead clients run concurrently, each on its own
    daemon thread, and a pass waits at most ``probe_deadline_s`` for them
    (a probe past it still revives its client when it completes); a single
    dead client is probed inline."""

    def __init__(
        self,
        registry: MembershipTable,
        probe: Callable[[str], bool],
        resync: Callable[[str], None],
        period: float = 1.0,
        metrics: Optional[object] = None,
        probe_deadline_s: Optional[float] = None,
    ):
        self.registry = registry
        self.probe = probe
        self.resync = resync
        self.period = period
        self.probe_deadline_s = probe_deadline_s
        self._metrics = metrics
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _count(self, name: str, help: str) -> None:
        if self._metrics is not None:
            self._metrics.counter(name, help).inc()

    def _probe_one(self, client: str, recovered: List[str], lock: threading.Lock) -> None:
        """One timed probe, and on an answer the resync, then the revive."""
        t0 = time.perf_counter()
        up = self.probe(client)
        if self._metrics is not None:
            self._metrics.histogram(
                "fedtpu_ft_rpc_seconds",
                "FT control-plane RPC round-trip seconds by rpc",
                labels={"rpc": "HeartBeat"},
            ).observe(time.perf_counter() - t0)
        if not up:
            self._count(
                "fedtpu_ft_heartbeat_misses_total",
                "heartbeat probes of dead clients that stayed dead",
            )
            return
        try:
            self.resync(client)
        except Exception:
            # Still unreachable (or a stale send in flight): next pass.
            self._count(
                "fedtpu_ft_resync_failures_total",
                "heartbeat succeeded but the resync push failed",
            )
            return
        self.registry.mark_alive(client)
        with lock:
            recovered.append(client)

    def tick(self) -> List[str]:
        """One probe pass; returns the clients recovered in it, in seat
        order."""
        dead = self.registry.dead_clients()
        recovered: List[str] = []
        lock = threading.Lock()
        if not dead:
            return recovered
        if len(dead) == 1:
            self._probe_one(dead[0], recovered, lock)
            return recovered
        threads = [
            threading.Thread(target=self._probe_one, args=(c, recovered, lock), daemon=True)
            for c in dead
        ]
        for t in threads:
            t.start()
        deadline = None if self.probe_deadline_s is None else time.monotonic() + self.probe_deadline_s
        for t in threads:
            t.join(None if deadline is None else max(0.0, deadline - time.monotonic()))
        with lock:
            done = list(recovered)
        seat = {c: i for i, c in enumerate(self.registry.clients)}
        return sorted(done, key=lambda c: seat.get(c, len(seat)))

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.period):
            self.tick()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
