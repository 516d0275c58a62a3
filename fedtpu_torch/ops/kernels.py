"""The compressed round's hand-written CUDA kernels, their plain versions
and their build.

The port of ``fedtpu.ops.pallas_kernels``. Each kernel is one CUDA C++
source under ``fedtpu_torch/csrc/`` with a plain C entry point, compiled by
``nvcc`` for ``sm_90a`` into a shared library under ``fedtpu_torch/_build/``
at its first use (or by :func:`build`) and called through ``ctypes``:

- :func:`threshold_feedback_grouped` (``csrc/threshold_feedback.cu``)
  replaces ``threshold_with_feedback``: top-k masking with error feedback,
  every leaf of a round in one launch (:func:`threshold_feedback` is its
  one-leaf case).
- :func:`quantdequant_int8_grouped` (``csrc/quantdequant_int8.cu``)
  replaces ``quantdequant_int8``: the simulated int8 codec, every leaf of
  a round in one launch (:func:`quantdequant_int8` is its one-leaf case).
- :func:`hadamard_rotate` (``csrc/hadamard_rotate.cu``) replaces
  ``hadamard_rotate``: the seeded Hadamard rotation of the ``rotq`` codec.

A wrapper launches its kernel for CUDA tensors and raises if it cannot; it
takes the plain PyTorch version only for tensors that lie on the CPU (the
tests). It counts its launches in a plain integer attribute, ``launches``.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from fedtpu_torch.obs.profile import report_build

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# Never --use_fast_math: the int8 kernel needs IEEE division and rounding,
# and the Hadamard kernel unfused adds and kept subnormals, to match fedtpu
# bit for bit. -Xptxas -v prints registers and spills per kernel.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
# name -> (source file, C entry point argument types)
_SOURCES = {
    "threshold_feedback": ("threshold_feedback.cu", [_P, _I64, _P]),
    "quantdequant_int8": ("quantdequant_int8.cu", [_P, _I64, _P]),
    "hadamard_rotate": (
        "hadamard_rotate.cu",
        [_P, _P, _P, _P, _I64, ctypes.c_int, ctypes.c_float, _P, ctypes.c_int, _P],
    ),
}
_MAX_ROWS = 65535  # K3's rows (the grouped K1 and K2 have no such limit)

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels are built from source at first use"
        )
    return found


def library_path(name: str) -> Path:
    """The shared library of kernel ``name``, keyed by its source and flags."""
    src = CSRC_DIR / _SOURCES[name][0]
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every named kernel (default: all) whose library is missing,
    one ``nvcc`` process per source, all started together. Returns each
    compiled kernel's compiler output; raises if any build fails. Each
    library compiled is reported, with its seconds, to the installed
    :class:`fedtpu_torch.obs.CompileWatcher`."""
    names = list(_SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    logs: Dict[str, str] = {}
    ends: Dict[str, float] = {}
    failed = []

    def reap(name, proc):
        logs[name], _ = proc.communicate()
        ends[name] = time.perf_counter()

    t0 = time.perf_counter()
    try:
        for name in names:
            lib = library_path(name)
            if lib.exists():
                continue
            tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / _SOURCES[name][0])]
            procs[name] = (
                subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                ),
                tmp,
                lib,
            )
        reapers = [threading.Thread(target=reap, args=(name, proc)) for name, (proc, _, _) in procs.items()]
        for t in reapers:
            t.start()
        for t in reapers:
            t.join()
        for name, (proc, tmp, lib) in procs.items():
            if proc.returncode != 0:
                failed.append(f"{name} (nvcc exit {proc.returncode}):\n{logs[name]}")
            else:
                os.replace(tmp, lib)
                report_build(ends[name] - t0, name)
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def _library(name: str) -> ctypes.CDLL:
    if name not in _loaded:
        lib_path = library_path(name)
        if not lib_path.exists():
            build([name])
        lib = ctypes.CDLL(str(lib_path))
        fn = getattr(lib, f"fedtpu_{name}")
        fn.argtypes = _SOURCES[name][1]
        fn.restype = ctypes.c_int
        err = getattr(lib, f"fedtpu_{name}_error")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _loaded[name] = lib
    return _loaded[name]


def _launch(name: str, tensor: torch.Tensor, *args) -> None:
    """Call kernel ``name``'s entry point on ``tensor``'s device and current
    stream; raise with CUDA's message if the launch was refused."""
    lib = _library(name)
    with torch.cuda.device(tensor.device):
        stream = torch.cuda.current_stream(tensor.device).cuda_stream
        code = getattr(lib, f"fedtpu_{name}")(*args, stream)
    if code != 0:
        msg = getattr(lib, f"fedtpu_{name}_error")(code).decode()
        raise RuntimeError(f"{name}: kernel launch failed ({code}: {msg})")


def _check_rows(name: str, x: torch.Tensor, per_row: torch.Tensor) -> None:
    """The grouped kernels take, for each leaf, a contiguous f32 ``[rows,
    cols]`` CUDA matrix and a contiguous f32 ``[rows]`` vector on the same
    card."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: needs a CUDA (or CPU) tensor, got {x.device}")
    if per_row.device != x.device:
        raise ValueError(f"{name}: operands on {x.device} and {per_row.device}")
    if x.dtype != torch.float32 or per_row.dtype != torch.float32:
        raise TypeError(f"{name}: needs float32, got {x.dtype} and {per_row.dtype}")
    if x.ndim != 2 or per_row.shape != (x.shape[0],):
        raise ValueError(
            f"{name}: needs [rows, cols] and [rows], got {tuple(x.shape)} and "
            f"{tuple(per_row.shape)}"
        )
    if not (x.is_contiguous() and per_row.is_contiguous()):
        raise ValueError(f"{name}: operands must be contiguous")


# ------------------------------------------------------- grouped launches

# The tile of the grouped kernels (K1, K2): 256 threads x 4 vectors of 4
# floats (each source's kTile).
GROUP_TILE = 4096
INT8_TILE = GROUP_TILE
# Leaves in one launch: each kernel's table of leaves travels in its 4 KB of
# parameters (the source's kMaxLeaves; its entry point refuses a longer one).
# K1's entry holds four pointers, K2's three.
THRESHOLD_GROUP_CAPACITY = 77
INT8_GROUP_CAPACITY = 90


class GroupLeaf(NamedTuple):
    """One leaf of a grouped launch: its position ``index`` in the caller's
    list, its ``numel`` elements, the ``head`` leading elements done one by
    one before the operands reach 16-byte alignment (at most 3, and at most
    ``numel``), the ``tail`` elements after the body's last whole 4-element
    vector, also done one by one, and its ``tiles``: tile ``t`` covers
    elements ``[head + t * GROUP_TILE, head + (t + 1) * GROUP_TILE)`` cut at
    ``numel``, and tile 0 also does the head."""

    index: int
    numel: int
    head: int
    tail: int
    tiles: int

    def tile_span(self, tile: int) -> Tuple[int, int]:
        """The ``[start, stop)`` elements of ``tile``'s vectors and tail."""
        start = self.head + tile * GROUP_TILE
        return start, min(start + GROUP_TILE, self.numel)


def _group_plan(
    sizes: Sequence[int], offsets: Optional[Sequence[int]], capacity: int
) -> List[Tuple[GroupLeaf, ...]]:
    """The launches of a grouped kernel for leaves of ``sizes`` elements
    whose operands start ``offsets`` bytes past a 16-byte boundary (default
    0; multiples of 4): the non-empty leaves in order, at most ``capacity``
    a launch."""
    offsets = [0] * len(sizes) if offsets is None else offsets
    leaves = []
    for i, (numel, offset) in enumerate(zip(sizes, offsets)):
        if numel == 0:
            continue
        head = min(numel, (16 - offset % 16) % 16 // 4)
        tiles = max(1, -(-(numel - head) // GROUP_TILE))
        leaves.append(GroupLeaf(i, numel, head, (numel - head) % 4, tiles))
    return [tuple(leaves[i : i + capacity]) for i in range(0, len(leaves), capacity)]


def _int8_group_plan(
    sizes: Sequence[int], offsets: Optional[Sequence[int]] = None
) -> List[Tuple[GroupLeaf, ...]]:
    """K2's launches: :func:`_group_plan` at ``INT8_GROUP_CAPACITY``."""
    return _group_plan(sizes, offsets, INT8_GROUP_CAPACITY)


def _empty_at_offset_of(x: torch.Tensor) -> torch.Tensor:
    """An uninitialised tensor like ``x`` that starts at ``x``'s byte
    offset modulo 16, so that a grouped kernel moves both in 16-byte
    vectors after the same head."""
    skip = x.data_ptr() % 16 // x.element_size()
    if skip == 0:
        return torch.empty_like(x)
    return torch.empty(x.numel() + skip, dtype=x.dtype, device=x.device)[skip:].view(x.shape)


def _check_group(name: str, xs: List[torch.Tensor], per_rows: List[torch.Tensor]) -> None:
    """Every leaf of a grouped call a kernel operand, all on one card."""
    for x, v in zip(xs, per_rows):
        _check_rows(name, x, v)
        if x.device != xs[0].device:
            raise ValueError(f"{name}: leaves on {xs[0].device} and {x.device}")


# ------------------------------------------------------------------ K1


def threshold_feedback_plain(
    y: torch.Tensor, thresh: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``out = where(|y| >= thresh[row], y, 0)``, ``new_e = y - out``."""
    out = torch.where(y.abs() >= thresh[:, None], y, torch.zeros_like(y))
    return out, y - out


def threshold_feedback_grouped_plain(
    ys: Sequence[torch.Tensor], threshs: Sequence[torch.Tensor]
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """:func:`threshold_feedback_plain` of every leaf: ``(outs, new_es)``."""
    pairs = [threshold_feedback_plain(y, t) for y, t in zip(ys, threshs)]
    return [o for o, _ in pairs], [e for _, e in pairs]


def threshold_feedback_grouped(
    ys: Sequence[torch.Tensor], threshs: Sequence[torch.Tensor]
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Fused top-k mask and residual split of every leaf ``ys[i] [rows,
    cols]`` f32 by its per-row magnitude thresholds ``threshs[i] [rows]``:
    ``(outs, new_es)``, in one launch for up to
    ``THRESHOLD_GROUP_CAPACITY`` leaves."""
    ys, threshs = list(ys), list(threshs)
    if len(ys) != len(threshs):
        raise ValueError(f"threshold_feedback: {len(ys)} leaves and {len(threshs)} thresholds")
    if all(y.device.type == "cpu" for y in ys):
        return threshold_feedback_grouped_plain(ys, threshs)
    _check_group("threshold_feedback", ys, threshs)
    outs = [_empty_at_offset_of(y) for y in ys]
    new_es = [_empty_at_offset_of(y) for y in ys]
    plan = _group_plan([y.numel() for y in ys], [y.data_ptr() % 16 for y in ys], THRESHOLD_GROUP_CAPACITY)
    for launch in plan:
        table = np.asarray(
            [
                (ys[leaf.index].data_ptr(), threshs[leaf.index].data_ptr(),
                 outs[leaf.index].data_ptr(), new_es[leaf.index].data_ptr(),
                 *ys[leaf.index].shape, leaf.head, leaf.tiles)
                for leaf in launch
            ],
            dtype=np.int64,
        )
        _launch("threshold_feedback", ys[0], table.ctypes.data, len(launch))
        threshold_feedback.launches += 1
    return outs, new_es


def threshold_feedback(
    y: torch.Tensor, thresh: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused top-k mask and residual split of one ``y [rows, cols]`` f32 by
    the per-row magnitude threshold ``thresh [rows]``: ``(out, new_e)``, the
    one-leaf case of :func:`threshold_feedback_grouped`."""
    outs, new_es = threshold_feedback_grouped([y], [thresh])
    return outs[0], new_es[0]


threshold_feedback.launches = 0


# ------------------------------------------------------------------ K2


def quantdequant_int8_plain(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / s'), -127, 127) * s'`` with ``s' = s > 0 ? s : 1``
    per row; ``round`` is half-to-even."""
    s = scale[:, None]
    safe = torch.where(s > 0, s, torch.ones_like(s))
    return torch.clamp(torch.round(x / safe), -127.0, 127.0) * safe


def quantdequant_int8_grouped_plain(
    xs: Sequence[torch.Tensor], scales: Sequence[torch.Tensor]
) -> List[torch.Tensor]:
    """:func:`quantdequant_int8_plain` of every leaf."""
    return [quantdequant_int8_plain(x, s) for x, s in zip(xs, scales)]


def quantdequant_int8_grouped(
    xs: Sequence[torch.Tensor], scales: Sequence[torch.Tensor]
) -> List[torch.Tensor]:
    """Simulated symmetric int8 codec of every leaf ``xs[i] [rows, cols]``
    f32 with per-row ``scales[i] [rows]`` (each row's max|x| / 127), in one
    launch for up to ``INT8_GROUP_CAPACITY`` leaves."""
    xs, scales = list(xs), list(scales)
    if len(xs) != len(scales):
        raise ValueError(f"quantdequant_int8: {len(xs)} leaves and {len(scales)} scales")
    if all(x.device.type == "cpu" for x in xs):
        return quantdequant_int8_grouped_plain(xs, scales)
    _check_group("quantdequant_int8", xs, scales)
    outs = [_empty_at_offset_of(x) for x in xs]
    plan = _int8_group_plan([x.numel() for x in xs], [x.data_ptr() % 16 for x in xs])
    for launch in plan:
        table = np.asarray(
            [
                (xs[leaf.index].data_ptr(), scales[leaf.index].data_ptr(),
                 outs[leaf.index].data_ptr(), *xs[leaf.index].shape, leaf.head, leaf.tiles)
                for leaf in launch
            ],
            dtype=np.int64,
        )
        _launch("quantdequant_int8", xs[0], table.ctypes.data, len(launch))
        quantdequant_int8.launches += 1
    return outs


def quantdequant_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Simulated symmetric int8 codec of one ``x [rows, cols]`` f32 with
    per-row ``scale [rows]``: the one-leaf case of
    :func:`quantdequant_int8_grouped`."""
    return quantdequant_int8_grouped([x], [scale])[0]


quantdequant_int8.launches = 0


# ------------------------------------------------------------------ K3

_MIN_HADAMARD_WIDTH = 128  # the narrowest row the kernel compiles a tile for

# The kernel's tile: 2^13 elements, 512 threads of 16 elements each (the
# source's kTileLog; the kernel refuses a plan made for another).
# A phase after the first runs at most 13 - 4 stages, so that its segments
# keep at least 16 contiguous columns (64 bytes).
HADAMARD_TILE_LOG = 13
# The byte budget of rows that sit between two phases (written by one, not
# yet read by the next), kept well under the H100's 50 MB L2 so that the
# next phase can find the intermediate there (16 MiB timed best, PERF.md).
HADAMARD_LAG_BYTES = 16 << 20


class HadamardPlan(NamedTuple):
    """How the kernel splits the butterfly of ``rows`` rows of width ``h``.

    The kernel works on ``units`` units of ``unit_len`` elements each: the
    rows when there are two phases or more, or the whole matrix as one unit
    (each tile then holding ``2^13 / h`` rows) when one phase does. Phase p
    is ``phases[p] = (stage_lo, stages, col_log, seg_log)``: it runs the
    butterfly's stages ``stage_lo .. stage_lo + stages - 1`` on each of
    ``tiles[p]`` tiles of a unit. A tile's local index ``L`` (``0 <= L <
    2^13``) splits into a column ``L mod 2^col_log`` and a segment ``L >>
    col_log`` and lies at unit offset ``base + (segment << seg_log) +
    column``; its stages are its local bits ``col_log .. col_log + stages -
    1``. A tile of phase p of unit u waits for every tile of phase p-1 of
    u. Work items are taken in ticket order, step by step: step s holds
    every tile of phase p of unit ``s - p * lag``, phase 0 first, so a
    phase runs ``lag`` units behind the one before it."""

    h: int
    tile_log: int
    units: int
    unit_len: int
    lag: int
    phases: Tuple[Tuple[int, int, int, int], ...]
    tiles: Tuple[int, ...]

    @property
    def lag_bytes(self) -> int:
        """Bytes of units written by a phase and not yet read by the next."""
        return 4 * self.lag * self.unit_len if len(self.phases) > 1 else 0

    def tile_base(self, phase: int, tile: int) -> int:
        """Unit offset of local index 0 of ``tile`` of ``phase``."""
        lo, k, c, seg = self.phases[phase]
        groups = (1 << seg) >> c
        return ((tile % groups) << c) + ((tile // groups) << (seg + self.tile_log - c))

    def as_array(self) -> np.ndarray:
        """The plan as the kernel's C entry point reads it (int64)."""
        head = [self.tile_log, len(self.phases), self.lag, self.units, self.unit_len]
        body = [v for ph, n in zip(self.phases, self.tiles) for v in (*ph, n)]
        return np.asarray(head + body, dtype=np.int64)


def _hadamard_plan(h: int, rows: int) -> HadamardPlan:
    """The kernel's plan for ``rows`` rows of width ``h`` (a power of two,
    at least 128): phase 0 runs stages 0 .. min(m, 13) - 1 on contiguous
    2^13-element chunks; each later phase up to 9 stages on tiles of 2^k
    segments, 2^lo apart, 2^(13 - k) columns wide. Phases lag each other
    by as many rows as HADAMARD_LAG_BYTES holds, at least one and at most
    ``rows``."""
    m = h.bit_length() - 1
    t = HADAMARD_TILE_LOG
    if m <= t:  # one phase over the whole matrix, 2^(13 - m) rows per tile
        unit_len = rows * h
        tiles = (unit_len + (1 << t) - 1) >> t
        return HadamardPlan(h, t, 1, unit_len, 0, ((0, m, 0, 0),), (tiles,))
    phases = [(0, t, 0, 0)]
    lo = t
    while lo < m:
        k = min(t - 4, m - lo)
        phases.append((lo, k, t - k, lo))
        lo += k
    lag = max(1, min(rows, HADAMARD_LAG_BYTES // (4 * h)))
    return HadamardPlan(h, t, rows, h, lag, tuple(phases), (h >> t,) * len(phases))


def _hadamard_norm(h: int) -> float:
    """``f32(1 / sqrt(h))``, as fedtpu rounds it."""
    return float(np.float32(1.0 / math.sqrt(h)))


def _check_hadamard_shape(y: torch.Tensor, signs: torch.Tensor) -> None:
    if y.ndim != 2:
        raise ValueError(f"hadamard_rotate: needs [rows, h], got {tuple(y.shape)}")
    h = y.shape[1]
    if h < 1 or h & (h - 1):
        raise ValueError(f"hadamard_rotate needs a power-of-two width, got {h}")
    if tuple(signs.shape) != (h,):
        raise ValueError(
            f"hadamard_rotate: needs signs [{h}], got {tuple(signs.shape)}"
        )


def fwht_plain(x: torch.Tensor) -> torch.Tensor:
    """Unnormalised fast Walsh-Hadamard transform over the last axis of
    ``x [rows, h]``: the stride-doubling butterfly of fedtpu's
    ``_fwht_body``, each pair ``(a, b)`` becoming ``(a + b, a - b)``, the
    strides in ascending order."""
    rows, h = x.shape
    step = 1
    while step < h:
        x = x.reshape(rows, h // (2 * step), 2, step)
        a = x[:, :, 0, :]
        b = x[:, :, 1, :]
        x = torch.stack([a + b, a - b], dim=2).reshape(rows, h)
        step *= 2
    return x


def hadamard_rotate_plain(
    y: torch.Tensor, signs: torch.Tensor, inverse: bool = False
) -> torch.Tensor:
    """``fwht(y * signs) / sqrt(h)``, or on the inverse
    ``fwht(y) / sqrt(h) * signs``, in fedtpu's order of operations."""
    _check_hadamard_shape(y, signs)
    y = y.float()
    signs = signs.float()
    if not inverse:
        y = y * signs[None, :]
    out = fwht_plain(y) * _hadamard_norm(y.shape[1])
    if inverse:
        out = out * signs[None, :]
    return out


def hadamard_rotate(
    y: torch.Tensor, signs: torch.Tensor, inverse: bool = False
) -> torch.Tensor:
    """Seeded structured rotation of ``y [rows, h]`` f32 (h a power of two,
    at least 128 on a card) by the Rademacher diagonal ``signs [h]``:
    forward ``fwht(y * signs) / sqrt(h)``; ``inverse=True`` undoes it."""
    if y.device.type == "cpu":
        return hadamard_rotate_plain(y, signs, inverse)
    if y.device.type != "cuda":
        raise ValueError(f"hadamard_rotate: needs a CUDA (or CPU) tensor, got {y.device}")
    if signs.device != y.device:
        raise ValueError(f"hadamard_rotate: operands on {y.device} and {signs.device}")
    if y.dtype != torch.float32 or signs.dtype != torch.float32:
        raise TypeError(
            f"hadamard_rotate: needs float32, got {y.dtype} and {signs.dtype}"
        )
    _check_hadamard_shape(y, signs)
    rows, h = y.shape
    if h < _MIN_HADAMARD_WIDTH:
        raise ValueError(f"hadamard_rotate: needs h >= {_MIN_HADAMARD_WIDTH}, got {h}")
    if rows > _MAX_ROWS:
        raise ValueError(f"hadamard_rotate: at most {_MAX_ROWS} rows, got {rows}")
    if not (y.is_contiguous() and signs.is_contiguous()):
        raise ValueError("hadamard_rotate: operands must be contiguous")
    if y.data_ptr() % 16:  # the kernel moves 16-byte vectors
        y = y.clone()
    if signs.data_ptr() % 16:
        signs = signs.clone()
    out = torch.empty_like(y)
    if rows:
        _hadamard_launch(y, signs, out, inverse, _hadamard_plan(h, rows))
    return out


def _hadamard_launch(
    y: torch.Tensor, signs: torch.Tensor, out: torch.Tensor, inverse: bool,
    plan: HadamardPlan,
) -> None:
    """One launch of the kernel on operands ``hadamard_rotate`` checked,
    as ``plan`` splits it (``chip_smoke.py`` also times a plan that puts
    every row's phase 0 first)."""
    # The ticket (64 bits), then one count of finished tiles for each
    # unit and phase that another phase waits on; fresh for every call,
    # on the current stream, so calls on two streams never share them.
    counters = torch.zeros(
        2 + plan.units * (len(plan.phases) - 1), dtype=torch.int32, device=y.device
    )
    arr = plan.as_array()
    _launch(
        "hadamard_rotate", y, y.data_ptr(), signs.data_ptr(), out.data_ptr(),
        counters.data_ptr(), plan.h, int(inverse), _hadamard_norm(plan.h),
        arr.ctypes.data, len(arr),
    )
    hadamard_rotate.launches += 1


hadamard_rotate.launches = 0

KERNELS = {
    "threshold_feedback": (threshold_feedback, threshold_feedback_plain),
    "quantdequant_int8": (quantdequant_int8, quantdequant_int8_plain),
    "hadamard_rotate": (hadamard_rotate, hadamard_rotate_plain),
}


def reset_launch_counts() -> None:
    for wrapper, _ in KERNELS.values():
        wrapper.launches = 0
