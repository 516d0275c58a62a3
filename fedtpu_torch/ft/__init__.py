"""Fault tolerance of the coordinator: the port's own copy of
``fedtpu/ft/`` without fault injection.

- :mod:`~fedtpu_torch.ft.membership` (``fedtpu/ft/membership.py``): the
  versioned, seat-stable roster with suspicion and quarantine;
- :mod:`~fedtpu_torch.ft.heartbeat` (``fedtpu/ft/heartbeat.py``): re-probe
  dead clients, resync and revive them;
- :mod:`~fedtpu_torch.ft.failover` (``fedtpu/ft/failover.py``): the
  backup's promote/demote state machine with an injectable clock, the
  primary's pinger and the watchdog thread.

fedtpu's ``chaos`` (seeded fault injection) is not ported yet, and the
metrics registry these classes could count into is not either: each takes
``metrics=None`` only. Nothing here imports grpc.
"""

from fedtpu_torch.ft.failover import FailoverStateMachine, PrimaryPinger, Role, WatchdogRunner
from fedtpu_torch.ft.heartbeat import ClientRegistry, HeartbeatMonitor
from fedtpu_torch.ft.membership import MembershipTable

__all__ = [
    "ClientRegistry",
    "FailoverStateMachine",
    "HeartbeatMonitor",
    "MembershipTable",
    "PrimaryPinger",
    "Role",
    "WatchdogRunner",
]
