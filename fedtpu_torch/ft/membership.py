"""Dynamic, versioned federation membership: the port's own copy of
``fedtpu/ft/membership.py``'s :class:`MembershipTable`.

- **Seats.** Every member holds a stable integer seat: its rank (the data
  shard it trains) and its row in alive masks and round records. Seats of
  evicted members are freed and handed to later joiners (lowest first), so
  :meth:`MembershipTable.capacity`, the ``world`` every client partitions
  against, holds steady under churn.
- **Versions.** Every admit and evict bumps :attr:`MembershipTable.
  version`. The roster rides the replica payload to the backup
  (:meth:`snapshot` / :meth:`restore`), so a promoted backup inherits the
  current roster, not the startup list.
- **Reputation.** A suspicion EWMA of screening verdicts per member, and
  quarantine (served, its updates ignored) with a round count.
- **Tolerance.** ``mark_failed`` / ``mark_alive`` / ``is_alive`` on an id
  that is not (or no longer) a member log and ignore: a late RPC from an
  evicted client is ordinary.

:meth:`snapshot` is fedtpu's to the key order and the float: its
``json.dumps`` is the ``membership`` leaf of the replica, byte for byte.
Transitions are logged and, with ``metrics=`` (a
:class:`~fedtpu_torch.obs.MetricsRegistry` or a ``Telemetry``), counted
under fedtpu's names: ``fedtpu_membership_joins_total``,
``fedtpu_membership_evictions_total{reason}``, the death and recovery
counters and the size, version and quarantine gauges.
"""

from __future__ import annotations

import heapq
import logging
import threading
from typing import Dict, Iterable, List, Optional

import numpy as np

log = logging.getLogger("fedtpu_torch.ft")


class MembershipTable:
    """Thread-safe, versioned, seat-stable membership roster.

    ``clients`` seeds the initial members (all alive, seats in list order)
    without logging: construction is not churn. Later :meth:`admit` calls
    add members *dead*: a joiner is resynced with the current global model
    before it may receive a StartTrain."""

    def __init__(self, clients: Iterable[str] = (), metrics: Optional[object] = None):
        self._seat: Dict[str, int] = {}
        self._alive: Dict[str, bool] = {}
        self._free: List[int] = []  # freed seats, a min-heap
        self._capacity = 0
        self._version = 0
        self._lock = threading.Lock()
        self._metrics = metrics
        # Suspicion EWMA per member, and the quarantined members' counts of
        # consecutive quarantined rounds (absent: not quarantined).
        self._suspicion: Dict[str, float] = {}
        self._quarantined: Dict[str, int] = {}
        for c in clients:
            if c in self._seat:
                raise ValueError(f"duplicate client id {c!r}")
            self._seat[c] = self._capacity
            self._alive[c] = True
            self._capacity += 1

    # ------------------------------------------------------------ metrics
    def _count(self, name: str, help: str, labels=None) -> None:
        if self._metrics is not None:
            self._metrics.counter(name, help, labels=labels).inc()

    def _gauges(self) -> None:
        """Refresh the size, version and quarantine gauges (outside the
        lock)."""
        if self._metrics is None:
            return
        self._metrics.gauge(
            "fedtpu_membership_size",
            "current federation members (alive + dead, evicted excluded)",
        ).set(self.size)
        self._metrics.gauge(
            "fedtpu_membership_version",
            "membership epoch: bumped by every admit/evict transition",
        ).set(self.version)
        with self._lock:
            n_quarantined = len(self._quarantined)
        self._metrics.gauge(
            "fedtpu_membership_quarantined",
            "members currently quarantined (served but updates ignored)",
        ).set(n_quarantined)

    def _unknown(self, op: str, client: str) -> None:
        log.info("membership: %s for non-member %s ignored", op, client)
        self._count(
            "fedtpu_membership_unknown_total",
            "registry operations for non-members, ignored (late RPCs from "
            "evicted clients)",
            labels={"op": op},
        )

    # ------------------------------------------------------ introspection
    @property
    def clients(self) -> List[str]:
        """Current members in seat order (the rank and mask order)."""
        with self._lock:
            return sorted(self._seat, key=self._seat.__getitem__)

    @property
    def size(self) -> int:
        with self._lock:
            return len(self._seat)

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def capacity(self) -> int:
        """The ``world`` clients partition against: seats ever allocated,
        free seats included."""
        with self._lock:
            return self._capacity

    def is_member(self, client: str) -> bool:
        with self._lock:
            return client in self._seat

    def seat_of(self, client: str) -> Optional[int]:
        with self._lock:
            return self._seat.get(client)

    def seat_map(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._seat)

    def active_clients(self) -> List[str]:
        """Live members in seat order; a client's rank is its seat, never
        its position among the live."""
        with self._lock:
            return sorted((c for c, a in self._alive.items() if a), key=self._seat.__getitem__)

    def dead_clients(self) -> List[str]:
        with self._lock:
            return sorted((c for c, a in self._alive.items() if not a), key=self._seat.__getitem__)

    def alive_mask(self) -> np.ndarray:
        """Alive flags over the current members in seat order."""
        with self._lock:
            order = sorted(self._seat, key=self._seat.__getitem__)
            return np.array([self._alive[c] for c in order], bool)

    # -------------------------------------------------------- transitions
    def admit(self, client: str) -> int:
        """Admit ``client`` (an existing member keeps its seat), dead, at
        the lowest free seat, growing capacity only when none is free.
        Returns the member's seat."""
        with self._lock:
            seat = self._seat.get(client)
            if seat is not None:
                return seat
            if self._free:
                seat = heapq.heappop(self._free)
            else:
                seat = self._capacity
                self._capacity += 1
            self._seat[client] = seat
            self._alive[client] = False
            self._version += 1
            version = self._version
        log.info("membership v%d: admitted %s at seat %d (unsynced)", version, client, seat)
        self._count(
            "fedtpu_membership_joins_total",
            "members admitted into the federation (join RPCs + rejoins "
            "after eviction; the startup roster is not counted)",
        )
        self._gauges()
        return seat

    def evict(self, client: str, reason: str = "leave") -> bool:
        """Remove ``client``, freeing its seat; False for a non-member."""
        with self._lock:
            seat = self._seat.pop(client, None)
            if seat is not None:
                del self._alive[client]
                self._suspicion.pop(client, None)
                self._quarantined.pop(client, None)
                heapq.heappush(self._free, seat)
                self._version += 1
                version = self._version
        if seat is None:
            self._unknown("evict", client)
            return False
        log.info("membership v%d: evicted %s from seat %d (%s)", version, client, seat, reason)
        self._count(
            "fedtpu_membership_evictions_total",
            "members removed from the federation, by reason",
            labels={"reason": reason},
        )
        self._gauges()
        return True

    def mark_failed(self, client: str) -> None:
        with self._lock:
            was_alive = self._alive.get(client)
            if was_alive is not None:
                self._alive[client] = False
        if was_alive is None:
            self._unknown("mark_failed", client)
        elif was_alive:
            log.warning("client %s marked dead", client)
            self._count("fedtpu_ft_client_deaths_total", "alive -> dead client transitions")

    def mark_alive(self, client: str) -> None:
        with self._lock:
            was_alive = self._alive.get(client)
            if was_alive is not None:
                self._alive[client] = True
        if was_alive is None:
            self._unknown("mark_alive", client)
        elif not was_alive:
            log.info("client %s recovered", client)
            self._count("fedtpu_ft_client_recoveries_total", "dead -> alive client transitions")

    def is_alive(self, client: str) -> bool:
        """False for non-members."""
        with self._lock:
            return self._alive.get(client, False)

    # --------------------------------------------------------- reputation
    def observe_screening(self, client: str, flagged: bool, ewma: float = 0.5) -> float:
        """Fold one screening verdict into the member's suspicion EWMA
        (``s' = (1 - ewma) * s + ewma * flagged``) and return it; 0 for a
        non-member."""
        with self._lock:
            member = client in self._seat
            if member:
                s = self._suspicion.get(client, 0.0)
                s = (1.0 - ewma) * s + ewma * (1.0 if flagged else 0.0)
                self._suspicion[client] = s
        if not member:
            self._unknown("observe_screening", client)
            return 0.0
        return s

    def suspicion(self, client: str) -> float:
        with self._lock:
            return self._suspicion.get(client, 0.0)

    def suspicion_map(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._suspicion)

    def quarantine(self, client: str) -> bool:
        """Quarantine a member (still served and screened, its updates
        ignored). False for a non-member or one already quarantined."""
        with self._lock:
            fresh = client in self._seat and client not in self._quarantined
            if fresh:
                self._quarantined[client] = 0
        if not fresh:
            if not self.is_member(client):
                self._unknown("quarantine", client)
            return False
        log.warning(
            "membership: client %s QUARANTINED (suspicion %.3f)", client, self.suspicion(client)
        )
        self._count(
            "fedtpu_membership_quarantine_total",
            "members placed in quarantine by the screening reputation "
            "escalation (dedicated counter — not a transient failure)",
        )
        self._gauges()
        return True

    def release(self, client: str) -> bool:
        """Release a quarantined member; False if it was not."""
        with self._lock:
            present = self._quarantined.pop(client, None) is not None
        if present:
            log.info(
                "membership: client %s released from quarantine (suspicion %.3f)",
                client, self.suspicion(client),
            )
            self._gauges()
        return present

    def is_quarantined(self, client: str) -> bool:
        with self._lock:
            return client in self._quarantined

    def quarantined_clients(self) -> List[str]:
        with self._lock:
            return sorted(self._quarantined, key=self._seat.__getitem__)

    def tick_quarantine(self, client: str) -> int:
        """Advance a quarantined member's round count and return it (0 if
        not quarantined)."""
        with self._lock:
            if client not in self._quarantined:
                return 0
            self._quarantined[client] += 1
            return self._quarantined[client]

    # -------------------------------------------------------- replication
    def snapshot(self) -> dict:
        """The roster as JSON-able state for the replica payload: version,
        capacity, and per member ``[id, seat, alive, suspicion rounded to
        6 places, quarantined rounds or -1]`` in seat order."""
        with self._lock:
            return {
                "version": self._version,
                "capacity": self._capacity,
                "members": [
                    [
                        c, self._seat[c], bool(self._alive[c]),
                        round(self._suspicion.get(c, 0.0), 6),
                        self._quarantined.get(c, -1),
                    ]
                    for c in sorted(self._seat, key=self._seat.__getitem__)
                ],
            }

    def restore(self, snap: dict) -> None:
        """Adopt a replicated :meth:`snapshot` wholesale (alive flags and
        reputation included; 3-element rows restore with a clean slate).
        The local version never goes backwards."""
        members = snap["members"]
        seats = [int(row[1]) for row in members]
        if len(set(seats)) != len(seats):
            raise ValueError("membership snapshot has duplicate seats")
        capacity = max([int(snap["capacity"])] + [s + 1 for s in seats])
        with self._lock:
            self._seat = {str(row[0]): int(row[1]) for row in members}
            self._alive = {str(row[0]): bool(row[2]) for row in members}
            self._suspicion = {
                str(row[0]): float(row[3])
                for row in members if len(row) >= 5 and float(row[3]) > 0
            }
            self._quarantined = {
                str(row[0]): int(row[4])
                for row in members if len(row) >= 5 and int(row[4]) >= 0
            }
            self._capacity = capacity
            taken = set(self._seat.values())
            self._free = [s for s in range(capacity) if s not in taken]
            heapq.heapify(self._free)
            self._version = max(self._version, int(snap["version"]))
            version = self._version
        log.info(
            "membership v%d: restored roster (%d members, capacity %d)",
            version, len(members), capacity,
        )
        self._gauges()

    def status(self) -> dict:
        """The roster as a status block: version, size, capacity, who is
        alive, dead and quarantined, and every nonzero suspicion."""
        with self._lock:
            order = sorted(self._seat, key=self._seat.__getitem__)
            return {
                "version": self._version,
                "size": len(self._seat),
                "capacity": self._capacity,
                "alive": [c for c in order if self._alive[c]],
                "dead": [c for c in order if not self._alive[c]],
                "quarantined": [c for c in order if c in self._quarantined],
                "suspicion": {
                    c: round(s, 4) for c, s in sorted(self._suspicion.items()) if s > 0
                },
            }
