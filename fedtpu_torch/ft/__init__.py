"""Fault tolerance of the coordinator: the port's own copy of
``fedtpu/ft/``.

- :mod:`~fedtpu_torch.ft.membership` (``fedtpu/ft/membership.py``): the
  versioned, seat-stable roster with suspicion and quarantine;
- :mod:`~fedtpu_torch.ft.heartbeat` (``fedtpu/ft/heartbeat.py``): re-probe
  dead clients, resync and revive them;
- :mod:`~fedtpu_torch.ft.failover` (``fedtpu/ft/failover.py``): the
  backup's promote/demote state machine with an injectable clock, the
  primary's pinger and the watchdog thread;
- :mod:`~fedtpu_torch.ft.chaos` (``fedtpu/ft/chaos.py``): seeded fault
  injection, its schedule parsed from fedtpu's spec strings
  (:func:`parse_chaos_spec`), its wire faults fired by gRPC interceptors
  and its attacks by the client's trainer.

Each takes ``metrics=`` (a :class:`fedtpu_torch.obs.MetricsRegistry`) and
counts its transitions under fedtpu's names; the failover machine and the
chaos schedule also take a flight recorder. Importing this package imports
no grpc.
"""

from fedtpu_torch.ft.chaos import FaultRule, FaultSchedule
from fedtpu_torch.ft.chaos import parse_spec as parse_chaos_spec
from fedtpu_torch.ft.failover import FailoverStateMachine, PrimaryPinger, Role, WatchdogRunner
from fedtpu_torch.ft.heartbeat import ClientRegistry, HeartbeatMonitor
from fedtpu_torch.ft.membership import MembershipTable

__all__ = [
    "ClientRegistry",
    "FailoverStateMachine",
    "FaultRule",
    "FaultSchedule",
    "HeartbeatMonitor",
    "MembershipTable",
    "PrimaryPinger",
    "Role",
    "WatchdogRunner",
    "parse_chaos_spec",
]
