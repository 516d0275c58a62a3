"""Checkpoints and resume: the port's own copy of ``fedtpu.checkpoint``.

Round-granularity generations of a whole state (an engine's global model,
per-client momentum, generator and codec residuals; a coordinator's model,
lineage counter, roster and server-optimizer moments; a client's local
state), so a resume continues the same trajectory. A generation is the
FTP1 frame of :mod:`fedtpu_torch.transport.wire` behind a digest manifest,
fedtpu's bytes for the same tree.
"""

from fedtpu_torch.checkpoint.checkpoint import (
    Checkpointer,
    atomic_write_bytes,
    latest_round,
    restore,
    save,
    verify_generation,
)
from fedtpu_torch.checkpoint.writer import BackgroundCheckpointer

__all__ = [
    "BackgroundCheckpointer",
    "Checkpointer",
    "atomic_write_bytes",
    "latest_round",
    "restore",
    "save",
    "verify_generation",
]
