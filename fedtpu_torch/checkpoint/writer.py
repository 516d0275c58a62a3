"""The background checkpoint writer: saves off the round loop.

The port's own copy of ``fedtpu.checkpoint.writer``. A synchronous
:meth:`Checkpointer.save` holds the round loop for the encode, the fsync'd
write and the verify. :class:`BackgroundCheckpointer` keeps on the loop
only what must happen there, the copy of the state to the host, which pins
the values the generation claims to hold, and hands the rest to one writer
thread:

- saves are written strictly in the order they were submitted (one thread,
  a FIFO queue), so generation N never predates generation N-1 on disk;
- the inner :class:`~fedtpu_torch.checkpoint.checkpoint.Checkpointer`
  prunes only after a generation verifies and never raises on a failed
  save, so a full disk costs durability, never the writer thread;
- the queue is bounded (``queue_depth``): a writer that falls behind makes
  the next ``save`` wait instead of piling up host copies.

``flush()`` waits for every pending save; ``close()`` drains and stops the
thread. With ``telemetry=`` (a :class:`fedtpu_torch.obs.Telemetry`) each
write runs in a ``checkpoint`` span carrying its ``round``.
"""

from __future__ import annotations

import logging
import queue
import threading
from contextlib import nullcontext
from typing import Any, Optional

import numpy as np
import torch

from fedtpu_torch.checkpoint.checkpoint import Checkpointer
from fedtpu_torch.transport import wire

Tree = Any

log = logging.getLogger("fedtpu_torch.checkpoint")

_STOP = object()


def host_copy(tree: Tree) -> Tree:
    """A host copy of every leaf that shares no memory with its source: a
    tensor copied to the CPU (a new buffer even for a CPU tensor), a numpy
    array copied. The engine's round step may update a state tensor in
    place, so a view would capture the next round's bytes."""
    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", copy=True).numpy()
        return np.array(x, copy=True)

    return wire.tree_map(leaf, tree) if wire.tree_leaves(tree) else tree


class BackgroundCheckpointer:
    """The :class:`Checkpointer` surface (``save(round_idx, state)``,
    ``restore``, ``restore_latest``) with the write on a background thread,
    in a ``checkpoint`` span of ``telemetry`` when one is given."""

    def __init__(self, inner: Checkpointer, telemetry=None, queue_depth: int = 2):
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        self.inner = inner
        self._telemetry = telemetry
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        # Pending saves, the one being written included (it has left the
        # queue but is not durable yet).
        self._lock = threading.Lock()
        self._pending = 0
        self._drained = threading.Condition(self._lock)
        self._thread = threading.Thread(target=self._run, name="fedtpu-torch-ckpt-writer", daemon=True)
        self._thread.start()

    @property
    def directory(self) -> str:
        return self.inner.directory

    @property
    def last_save(self) -> Optional[dict]:
        return self.inner.last_save

    def save(self, round_idx: int, state: Tree) -> None:
        """Copy the state to the host now (:func:`host_copy`), then hand it
        to the writer; waits only while ``queue_depth`` saves are pending."""
        host = host_copy(state)
        with self._lock:
            self._pending += 1
        self._q.put((int(round_idx), host))

    def restore(self, round_idx: int, like: Tree) -> Tree:
        self.flush()
        return self.inner.restore(round_idx, like)

    def restore_latest(self, like: Tree):
        self.flush()
        return self.inner.restore_latest(like)

    def status(self) -> dict:
        s = self.inner.status()
        s["async"] = True
        with self._lock:
            s["pending"] = self._pending
        return s

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Wait until every submitted save is written (or failed without
        raising). True when drained, False on a timeout."""
        with self._drained:
            return self._drained.wait_for(lambda: self._pending == 0, timeout)

    def close(self, timeout: Optional[float] = 60.0) -> None:
        """Drain and stop the writer. Idempotent."""
        if not self._thread.is_alive():
            return
        self._q.put(_STOP)
        self._thread.join(timeout)
        if self._thread.is_alive():
            log.warning("checkpoint writer did not drain within %ss", timeout)

    def _span(self, round_idx: int):
        if self._telemetry is not None:
            return self._telemetry.span("checkpoint", round=round_idx)
        return nullcontext()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is _STOP:
                return
            round_idx, host = item
            try:
                with self._span(round_idx):
                    # The inner save raises on nothing but a fault of its
                    # own; that must not end the writer either.
                    self.inner.save(round_idx, host)
            except Exception:
                log.exception("background checkpoint save of round %d raised", round_idx)
            finally:
                with self._drained:
                    self._pending -= 1
                    if self._pending == 0:
                        self._drained.notify_all()
