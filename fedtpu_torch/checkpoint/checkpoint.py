"""The checkpoint store: one framed, CRC-checked file per round.

The port's own copy of ``fedtpu.checkpoint.checkpoint``, on the wire
backend. A generation is ``<dir>/round_<N>.fckpt``, the FTP1 frame of the
state (:mod:`fedtpu_torch.transport.wire`, zlib-compressed), beside a
manifest ``round_<N>.fckpt.manifest.json`` that records the byte count and
crc32 the write claimed to make durable. For the same host tree both files
are fedtpu's bytes, and each package restores the other's. fedtpu's
``orbax`` backend is JAX's own format: the port refuses it, and
``backend="auto"`` means ``"wire"``.

The durability rules are fedtpu's:

- a write goes to a temp file, is fsync'd, renamed into place, and the
  directory fsync'd; the manifest follows the same protocol, written only
  after its data file is durable;
- a restore checks the manifest digest before the decode (and the frame's
  CRC during it); :meth:`Checkpointer.restore_latest` falls back past a
  corrupt generation (bit rot, a torn write, truncation) to the previous
  one, and raises only when generations exist and none verifies. A
  template mismatch (intact bytes of another structure) raises: it is a
  configuration fault, which an older generation would hide;
- :meth:`Checkpointer.save` treats an ``OSError`` (ENOSPC, EIO, a vanished
  mount) or a failed verify-after-write as a logged warning and returns
  ``None``; training goes on on the surviving generations;
- old generations are pruned only after the new one has been read back and
  verified.

The seeded disk faults of :mod:`fedtpu_torch.ft.chaos` (``ckpt_fail``,
``ckpt_torn``, ``ckpt_rot`` on the pseudo-RPC ``Disk``) are consulted by
:meth:`Checkpointer.save` when a schedule is armed. fedtpu also counts
saves, failures and fallbacks into its metrics registry and flight
recorder, which the port has not yet (``metrics=`` and ``flight=`` raise).
"""

from __future__ import annotations

import json
import logging
import os
import re
import time
import zlib
from typing import Any, List, Optional

from fedtpu_torch.config import not_ported
from fedtpu_torch.transport import msgpack, wire

Tree = Any

log = logging.getLogger("fedtpu_torch.checkpoint")

_WIRE_RE = re.compile(r"^round_(\d+)\.fckpt$")
_MANIFEST_SUFFIX = ".manifest.json"
_MANIFEST_FORMAT = "fckpt-manifest/1"


def _wire_path(directory: str, round_idx: int) -> str:
    return os.path.join(directory, f"round_{round_idx}.fckpt")


def _manifest_path(directory: str, round_idx: int) -> str:
    return _wire_path(directory, round_idx) + _MANIFEST_SUFFIX


def _fsync_dir(directory: str) -> None:
    """Make a rename in ``directory`` durable (the rename changes the
    directory's inode, which has dirty state of its own)."""
    try:
        fd = os.open(directory or ".", os.O_RDONLY)
    except OSError:
        return  # platforms that refuse O_RDONLY on directories: best effort
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Replace ``path`` atomically and durably: temp write, flush, fsync of
    the file, rename, fsync of the directory. A crash at any point leaves
    the old file or the new one, never a mix."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))


def _write_manifest(directory: str, round_idx: int, payload: bytes) -> None:
    manifest = {
        "format": _MANIFEST_FORMAT,
        "round": int(round_idx),
        "bytes": len(payload),
        "crc32": zlib.crc32(payload) & 0xFFFFFFFF,
    }
    atomic_write_bytes(_manifest_path(directory, round_idx), json.dumps(manifest).encode())


def verify_generation(directory: str, round_idx: int) -> bool:
    """True when the generation's bytes match its manifest's digest, or
    when it has no manifest (a generation written before manifests, which
    only the frame's CRC vouches for, at decode). Raises nothing: a read
    error reads as unverified."""
    path = _wire_path(directory, round_idx)
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except OSError:
        return False
    mpath = _manifest_path(directory, round_idx)
    if not os.path.exists(mpath):
        return True
    try:
        with open(mpath) as fh:
            manifest = json.load(fh)
        return (
            int(manifest["bytes"]) == len(data)
            and int(manifest["crc32"]) == (zlib.crc32(data) & 0xFFFFFFFF)
        )
    except (OSError, ValueError, KeyError):
        return False


def _backend(backend: str) -> str:
    if backend in ("auto", "wire"):
        return "wire"
    if backend == "orbax":
        raise ValueError(
            "the orbax backend is JAX's own checkpoint format; fedtpu_torch "
            "writes and reads the wire backend (backend='wire' or 'auto')"
        )
    raise ValueError(f"unknown checkpoint backend '{backend}'")


def save(directory: str, round_idx: int, state: Tree, backend: str = "auto") -> str:
    """Write one generation and return its path. The state goes to the host
    here, one copy of each leaf (a tensor's ``.cpu()``; a numpy array as it
    is), so no caller downstream holds device memory."""
    _backend(backend)
    os.makedirs(directory, exist_ok=True)
    host = wire.host_tree(state)
    path = _wire_path(directory, round_idx)
    payload = wire.encode(host, compress=True)
    atomic_write_bytes(path, payload)
    # The manifest last: it must never vouch for bytes not yet durable. A
    # crash between the two writes leaves a generation the CRC alone checks.
    _write_manifest(directory, round_idx, payload)
    return path


def _decode(data: bytes, like: Tree) -> Tree:
    """The frame's tree restored into ``like``: :class:`wire.WireError` for
    bytes that are not a whole frame or document, a plain ``ValueError``
    (:class:`msgpack.MsgpackError`) for a document of another structure,
    as flax raises it."""
    try:
        raw = wire.decode_raw(data)
    except (msgpack.MsgpackError, zlib.error) as exc:
        raise wire.WireError(f"checkpoint payload is not a whole document ({exc})") from exc
    return msgpack.restore_into(like, raw)


def restore(directory: str, round_idx: int, like: Tree, backend: str = "auto") -> Tree:
    """The generation of ``round_idx`` restored into the structure of
    ``like``. Its bytes are checked against the manifest's digest before
    the decode, so rot and torn writes fail here as :class:`wire.WireError`."""
    _backend(backend)
    path = _wire_path(directory, round_idx)
    if not verify_generation(directory, round_idx):
        raise wire.WireError(
            f"checkpoint generation {round_idx} in {directory} fails its "
            "manifest digest (torn write or bit rot)"
        )
    with open(path, "rb") as fh:
        data = fh.read()
    try:
        return _decode(data, like)
    except wire.WireError:
        raise
    except ValueError:
        legacy = _legacy_decode(data, like)
        if legacy is not None:
            return legacy
        raise


# State fields added after the first release of the format, oldest first.
# A generation written before a field existed lacks its key, and a named
# tuple restores only with all of its fields, so a failed decode retries
# with more and more of these (newest first) dropped from the template and
# taken from ``like`` (their fresh values: a state the old run never had).
_NEW_STATE_FIELDS = ("server_opt_state", "last_client_loss")


def _legacy_decode(data: bytes, like: Tree) -> Optional[Tree]:
    if not hasattr(like, "_asdict"):
        return None
    full = dict(like._asdict())
    present = [k for k in _NEW_STATE_FIELDS if k in full]
    for n_drop in range(1, len(present) + 1):
        d = dict(full)
        dropped = {k: d.pop(k) for k in present[-n_drop:]}
        try:
            tree = _decode(data, d)
        except ValueError:
            continue
        return type(like)(**tree, **dropped)
    return None


def _scan_rounds(directory: str) -> List[int]:
    """Round indices of the generations in ``directory``, and of fedtpu's
    orbax directories (``<dir>/<N>/``), which the port lists but cannot
    read (their restore falls back past them)."""
    if not os.path.isdir(directory):
        return []
    rounds: List[int] = []
    for name in os.listdir(directory):
        m = _WIRE_RE.match(name)
        if m:
            rounds.append(int(m.group(1)))
        elif name.isdigit() and os.path.isdir(os.path.join(directory, name)):
            rounds.append(int(name))
    return sorted(set(rounds))


def latest_round(directory: str) -> Optional[int]:
    """The highest round index in ``directory``, or None."""
    rounds = _scan_rounds(directory)
    return rounds[-1] if rounds else None


class Checkpointer:
    """Round-granularity checkpoints with retention and fallback.

    >>> ckpt = Checkpointer("ckpt/", keep=3)
    >>> ckpt.save(round_idx, state)
    >>> round_idx, state = ckpt.restore_latest(like=state)

    ``chaos`` (a :class:`fedtpu_torch.ft.chaos.FaultSchedule`) arms the
    seeded disk faults; ``strict=True`` makes a failed save raise.
    ``metrics=`` and ``flight=`` raise until the port has a metrics
    registry and a flight recorder."""

    def __init__(self, directory: str, keep: int = 3, backend: str = "auto",
                 metrics=None, flight=None, chaos=None, strict: bool = False):
        if metrics is not None or flight is not None:
            raise not_ported(
                "Checkpointer(metrics=, flight=), the checkpoint counters and "
                "flight-recorder events", "slice 8, part 5",
            )
        self.directory = directory
        self.keep = keep
        self.backend = _backend(backend)
        self.strict = strict
        self._chaos = chaos
        # The last successful save: {round, bytes, wall_s}.
        self.last_save: Optional[dict] = None

    def save(self, round_idx: int, state: Tree) -> Optional[str]:
        """Write and verify one generation, then prune. An ``OSError`` or a
        failed verify-after-write is logged and ``None`` returned (raised
        with ``strict=True``); old generations are pruned only after the
        new one verifies."""
        rule = self._chaos.decide("Disk") if self._chaos is not None else None
        t0 = time.monotonic()
        try:
            if rule is not None and rule.kind == "ckpt_fail":
                raise OSError(28, "chaos: injected ENOSPC")  # errno.ENOSPC
            path = save(self.directory, round_idx, state, backend=self.backend)
            if not verify_generation(self.directory, round_idx):
                raise OSError(f"checkpoint generation {round_idx} failed verify-after-write")
        except OSError as exc:
            log.warning(
                "checkpoint save of round %d failed (%s); training continues "
                "on the surviving generations", round_idx, exc,
            )
            if self.strict:
                raise
            return None
        wall = time.monotonic() - t0
        try:
            nbytes = os.path.getsize(path)
        except OSError:
            nbytes = 0
        self._prune()
        self.last_save = {"round": int(round_idx), "bytes": int(nbytes), "wall_s": round(wall, 6)}
        # Silent corruption after the write was acknowledged (a disk that
        # lost its tail or flipped bits): only a restore can notice.
        if rule is not None and rule.kind in ("ckpt_torn", "ckpt_rot"):
            _corrupt_generation(self.directory, round_idx, rule.kind)
        return path

    def restore(self, round_idx: int, like: Tree) -> Tree:
        return restore(self.directory, round_idx, like, backend=self.backend)

    def restore_latest(self, like: Tree) -> Optional[tuple]:
        """``(round_idx, state)`` of the newest generation that verifies, or
        None for an empty directory. A corrupt generation (digest or CRC
        mismatch, truncation, an unreadable file) is logged and the previous
        one tried; a template mismatch raises. Raises :class:`wire.
        WireError` when generations exist and none verifies, so a resume
        never restarts from scratch unnoticed. Needs ``keep >= 2`` (or
        ``keep <= 0``, unbounded): a fallback needs a previous generation."""
        if 0 < self.keep < 2:
            raise ValueError(
                f"resuming requires keep >= 2 (got keep={self.keep}): "
                "generation fallback needs a previous snapshot to fall back to"
            )
        rounds = _scan_rounds(self.directory)
        if not rounds:
            return None
        for r in reversed(rounds):
            try:
                return r, self.restore(r, like)
            except (wire.WireError, OSError) as exc:
                log.error(
                    "checkpoint generation %d is corrupt (%s); falling back "
                    "to the previous generation", r, exc,
                )
        raise wire.WireError(
            f"all {len(rounds)} checkpoint generations in {self.directory} "
            "failed verification"
        )

    def _prune(self) -> None:
        rounds = _scan_rounds(self.directory)
        for r in rounds[: -self.keep] if self.keep > 0 else []:
            for path in (_wire_path(self.directory, r), _manifest_path(self.directory, r)):
                if os.path.exists(path):
                    os.remove(path)

    def status(self) -> dict:
        """The directory, the retention and the last save."""
        return {"directory": self.directory, "keep": self.keep, "last_save": self.last_save}

    # One surface whether saves are synchronous or go through the
    # BackgroundCheckpointer.
    def flush(self, timeout: Optional[float] = None) -> bool:
        return True

    def close(self, timeout: Optional[float] = None) -> None:
        return None


def _corrupt_generation(directory: str, round_idx: int, kind: str) -> None:
    """A seeded silent disk fault on a written generation, its manifest
    still claiming the intended bytes: ``ckpt_torn`` truncates the file to
    half, ``ckpt_rot`` flips the middle byte."""
    path = _wire_path(directory, round_idx)
    try:
        size = os.path.getsize(path)
        if size < 2:
            return
        with open(path, "r+b") as fh:
            if kind == "ckpt_torn":
                fh.truncate(size // 2)
            else:
                fh.seek(size // 2)
                byte = fh.read(1)
                fh.seek(size // 2)
                fh.write(bytes((byte[0] ^ 0xFF,)))
    except OSError:
        pass
