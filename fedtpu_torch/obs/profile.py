"""Performance observatory: the port of ``fedtpu/obs/profile.py``.

- :func:`engine_cost_model` and :func:`analytic_flops` /
  :func:`analytic_bytes`: a round's FLOPs (2 a matmul or convolution MAC,
  counted by ``torch.utils.flop_counter.FlopCounterMode``) and the bytes its
  aten ops read and write, attached to the engine once.
- :class:`RoundProfiler`: the per-round ``fedtpu_step_time_seconds``,
  ``fedtpu_achieved_flops_per_sec`` and ``fedtpu_mfu_ratio`` gauges, the
  round-record fields and the ``/statusz`` ``perf`` block, fedtpu's names
  and arithmetic.
- :class:`CompileWatcher`: fedtpu's compile counters over what stands in
  for an XLA compile here, each CUDA kernel library that
  :func:`fedtpu_torch.ops.kernels.build` compiles with ``nvcc``; a build
  after :meth:`CompileWatcher.mark_steady` (a kernel rebuilt in the middle
  of a run) warns and is flight-recorded.
- :class:`CaptureWindow`: round-windowed ``torch.profiler`` captures with
  fedtpu's ``profile_meta.json`` sidecar, written in the layout and form
  ``tools/trace_merge.py --device-trace`` reads.

Where the port departs from fedtpu:

- fedtpu traces its round program and counts a ``lax.scan`` body once, so
  its ``flops_per_round`` is one local step of every client. The port runs
  its local steps eagerly and counts the round it runs: every local step.
  At ``steps_per_round=1`` the two agree; at ``n`` steps the port's figure
  is ``n`` times fedtpu's, and it is the figure a per-step model-FLOP count
  of the same round gives.
- There is no XLA: ``xla_flops`` and ``xla_bytes`` stay ``None``,
  ``flops_source`` is ``"analytic"``, and ``xla_check`` changes nothing.
- :data:`PEAK_TABLE` holds NVIDIA parts and no TPU: a TPU's device kind
  resolves to ``(None, None)`` unless the ``FEDTPU_PEAK_*`` overrides say
  otherwise.

Nothing here imports torch when the module loads; the functions that need
it import it.
"""

from __future__ import annotations

import json
import logging
import math
import os
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

log = logging.getLogger("fedtpu_torch.obs.profile")

# ------------------------------------------------------------- peak tables
# Published per-card peaks by torch.cuda.get_device_name() substring, matched
# on the lower-case form without spaces or hyphens: (dense bf16 tensor-core
# FLOP/s, HBM bytes/s), NVIDIA's data sheets.
PEAK_TABLE: Tuple[Tuple[Tuple[str, ...], float, Optional[float]], ...] = (
    (("h10080gbhbm3", "h100sxm"), 989e12, 3.35e12),
    (("h100nvl",), 835e12, 3.9e12),
    (("h100pcie",), 756e12, 2.0e12),
    (("h200",), 989e12, 4.8e12),
)

# Operator overrides for hardware the table does not know (the CPU, other
# cards): a utilisation against a wrong peak is worse than none.
PEAK_FLOPS_ENV = "FEDTPU_PEAK_FLOPS"
PEAK_HBM_ENV = "FEDTPU_PEAK_HBM_BYTES"


def device_peaks(device_kind: str) -> Tuple[Optional[float], Optional[float]]:
    """``(peak_flops_per_s, peak_hbm_bytes_per_s)`` for a device name;
    ``(None, None)`` when unknown (the CPU, a TPU). The ``FEDTPU_PEAK_*``
    overrides win over the table."""
    peak_f = peak_b = None
    kind = (device_kind or "").lower().replace(" ", "").replace("-", "")
    for aliases, f, b in PEAK_TABLE:
        if any(a in kind for a in aliases):
            peak_f, peak_b = f, b
            break
    env_f = os.environ.get(PEAK_FLOPS_ENV)
    env_b = os.environ.get(PEAK_HBM_ENV)
    if env_f:
        try:
            peak_f = float(env_f)
        except ValueError:
            pass
    if env_b:
        try:
            peak_b = float(env_b)
        except ValueError:
            pass
    return peak_f, peak_b


# ------------------------------------------------------ FLOPs and bytes
def _conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding, _dilation,
                        transposed, _output_padding, _groups, output_mask, out_shape=None) -> int:
    """A convolution's backward: each gradient it computes, of the input
    and of the weight, costs the forward's MACs. torch's own formula
    charges the weight gradient of a grouped convolution ``groups`` times
    over (it reads the gradient as an ungrouped convolution), which counts
    a depthwise layer's once per channel."""
    from torch.utils.flop_counter import conv_flop_count

    fwd = conv_flop_count(list(x_shape), list(w_shape), list(grad_out_shape), transposed=transposed)
    return fwd * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def _flop_counter():
    """``FlopCounterMode`` with the convolution backward counted as
    :func:`_conv_backward_flop` counts it."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    return FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: _conv_backward_flop,
    })


def _byte_counter():
    """A ``TorchDispatchMode`` that adds up the bytes of every aten op's
    tensor inputs and outputs in ``total``. Views move nothing, nor do
    uninitialised allocations."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    free = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
            torch.ops.aten.empty_like.default}

    class ByteCounter(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func.is_view and func not in free:
                for t in tree_leaves((args, kwargs, out)):
                    if isinstance(t, torch.Tensor):
                        self.total += t.numel() * t.element_size()
            return out

    return ByteCounter()


def analytic_flops(fn: Callable, *args, **kwargs) -> float:
    """FLOPs of ``fn(*args, **kwargs)``: 2 a matmul or convolution MAC, as
    ``torch.utils.flop_counter.FlopCounterMode`` counts them (forward and
    backward, through ``torch.func`` transforms), a grouped convolution's
    weight gradient counted once (:func:`_conv_backward_flop`).
    Elementwise ops and reductions are not counted, as fedtpu counts none.
    fedtpu reads its figure off a traced program; the port runs ``fn`` once
    to count it."""
    with _flop_counter() as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def analytic_bytes(fn: Callable, *args, **kwargs) -> float:
    """Bytes that ``fn(*args, **kwargs)`` moves in eager PyTorch: each aten
    op's tensor inputs read and outputs written, once each, run once under a
    ``TorchDispatchMode``. Views and reshapes are free, as fedtpu skips
    layout ops. Eager mode fuses nothing, so where fedtpu charges a chain of
    elementwise ops one pass over its boundary tensors, the port charges
    every op of the chain its own reads and writes, and its figure is the
    larger; on a single matmul the two agree. A hand kernel launched
    through ``ctypes`` is not an aten op and moves no counted byte."""
    counter = _byte_counter()
    with counter:
        fn(*args, **kwargs)
    return float(counter.total)


def roofline(
    flops: Optional[float],
    bytes_accessed: Optional[float],
    peak_flops: Optional[float],
    peak_bw: Optional[float],
    achieved_flops_per_s: Optional[float] = None,
) -> Dict[str, Any]:
    """The roofline of one round: ``arith_intensity_flops_per_byte``,
    ``ridge_point_flops_per_byte``, ``roofline_bound`` ("compute" |
    "bandwidth") and, given an achieved rate, ``roofline_utilization``,
    the achieved rate over the ceiling at that intensity. Every key is
    present, None where an input is missing."""
    out: Dict[str, Any] = {
        "arith_intensity_flops_per_byte": None,
        "ridge_point_flops_per_byte": None,
        "roofline_bound": None,
        "roofline_utilization": None,
    }
    if flops and bytes_accessed:
        out["arith_intensity_flops_per_byte"] = round(flops / bytes_accessed, 3)
    if peak_flops and peak_bw:
        out["ridge_point_flops_per_byte"] = round(peak_flops / peak_bw, 3)
    ai = out["arith_intensity_flops_per_byte"]
    ridge = out["ridge_point_flops_per_byte"]
    if ai is not None and ridge is not None:
        out["roofline_bound"] = "compute" if ai >= ridge else "bandwidth"
        if achieved_flops_per_s:
            ceiling = peak_flops if ai >= ridge else peak_bw * ai
            if ceiling:
                out["roofline_utilization"] = round(achieved_flops_per_s / ceiling, 6)
    return out


# ------------------------------------------------------------- cost model
class CostModel:
    """A round's FLOP and byte figures, fedtpu's fields: the XLA figures
    (always None in the port), the analytic ones, and ``flops``, the XLA
    figure where there is one, else the analytic one."""

    def __init__(
        self,
        xla_flops: Optional[float] = None,
        xla_bytes: Optional[float] = None,
        analytic: Optional[float] = None,
        analytic_bytes: Optional[float] = None,
    ):
        self.xla_flops = xla_flops or None
        self.xla_bytes = xla_bytes or None
        self.analytic = analytic or None
        self.analytic_bytes = analytic_bytes or None
        self.flops = self.xla_flops or self.analytic
        self.source = "xla" if self.xla_flops else ("analytic" if self.analytic else None)
        self.agreement = (
            round(self.analytic / self.xla_flops, 4) if self.analytic and self.xla_flops else None
        )

    def as_dict(self) -> Dict[str, Any]:
        return {
            "flops_per_round": self.flops,
            "bytes_per_round": self.xla_bytes,
            "analytic_flops_per_round": self.analytic,
            "analytic_bytes_per_round": self.analytic_bytes,
            "flops_source": self.source,
            "analytic_vs_xla": self.agreement,
        }


def engine_cost_model(fed, xla_check: bool = True) -> CostModel:
    """The :class:`CostModel` of a :class:`fedtpu_torch.core.engine.
    Federation`'s round on its device-resident data: the next round, run
    once under both counters on a copy of the state with a copy of the
    engine's generator, so that the engine's own next round is the one it
    would have run without. Every local step is counted (see the module
    doc). ``xla_check`` is fedtpu's argument and changes nothing."""
    import torch
    from torch.utils._pytree import tree_map_only

    del xla_check  # no XLA to check against
    state = tree_map_only(torch.Tensor, torch.clone, fed.state)
    gen = torch.Generator(fed.device)
    gen.set_state(fed._generator.get_state())
    bytes_counter = _byte_counter()
    with _flop_counter() as flops, bytes_counter:
        fed._round_step(state, fed.device_batch(state.round_idx), gen)
    return CostModel(analytic=float(flops.get_total_flops()), analytic_bytes=float(bytes_counter.total))


# ---------------------------------------------------------- round profiler
class RoundProfiler:
    """Per-round MFU and step-time accounting through one Telemetry.

    ``observe_round(wall_s, rounds=n)`` after each round or block sets three
    gauges and returns the derived figures for the round record; the cost
    model is attached once with :meth:`set_cost_model`. The engines read
    the wall after a device sync (``core/engine.py``)."""

    def __init__(self, telemetry, n_devices: int = 1, device_kind: str = ""):
        self.telemetry = telemetry
        self.n_devices = max(1, int(n_devices))
        self.device_kind = device_kind
        self.peak_flops, self.peak_bw = device_peaks(device_kind)
        self.cost: Optional[CostModel] = None
        self._last: Dict[str, Any] = {}
        self._rounds = 0

    def set_cost_model(self, cost: CostModel) -> None:
        self.cost = cost

    def observe_round(self, wall_s: float, rounds: int = 1) -> Dict[str, Any]:
        """Account ``rounds`` rounds that took ``wall_s`` seconds; returns
        ``{step_time_s, achieved_flops_per_s, mfu}`` (None where it cannot
        be derived) after setting the gauges."""
        tel = self.telemetry
        step_s = wall_s / max(1, rounds)
        self._rounds += rounds
        out: Dict[str, Any] = {"step_time_s": step_s, "achieved_flops_per_s": None, "mfu": None}
        tel.gauge(
            "fedtpu_step_time_seconds",
            "wall time of the last round dispatch, per round",
        ).set(step_s)
        flops = self.cost.flops if self.cost else None
        if flops and wall_s > 0:
            achieved = flops * rounds / wall_s
            out["achieved_flops_per_s"] = achieved
            tel.gauge(
                "fedtpu_achieved_flops_per_sec",
                "model FLOPs retired per second over the last dispatch "
                "(all devices)",
            ).set(achieved)
            if self.peak_flops:
                mfu = achieved / (self.n_devices * self.peak_flops)
                out["mfu"] = mfu
                tel.gauge(
                    "fedtpu_mfu_ratio",
                    "model FLOPs utilization of the last dispatch vs "
                    "per-chip peak (device_peaks table or FEDTPU_PEAK_FLOPS)",
                ).set(mfu)
        self._last = out
        return out

    def record_fields(self) -> Dict[str, Any]:
        """The last observation's rounded fields for a round record (empty
        before any round, or when they cannot be derived)."""
        out: Dict[str, Any] = {}
        last = self._last
        if last.get("achieved_flops_per_s"):
            out["achieved_flops_per_s"] = round(last["achieved_flops_per_s"], 1)
        if last.get("mfu") is not None:
            out["mfu"] = round(last["mfu"], 6)
        return out

    def snapshot(self) -> Dict[str, Any]:
        """The ``/statusz`` ``perf`` block: the last round's figures, the
        cost model, the peaks and the roofline. The roofline reads the XLA
        bytes where the cost model has them, as fedtpu's does, else the
        analytic bytes (the port's cost model has no XLA figure)."""
        snap: Dict[str, Any] = {
            "device_kind": self.device_kind,
            "n_devices": self.n_devices,
            "peak_flops_per_s": self.peak_flops,
            "rounds_observed": self._rounds,
        }
        if self.cost is not None:
            snap.update(self.cost.as_dict())
        snap.update(self._last)
        if self.cost is not None and self._last.get("achieved_flops_per_s"):
            snap.update(roofline(
                self.cost.flops, self.cost.xla_bytes or self.cost.analytic_bytes,
                self.peak_flops, self.peak_bw,
                self._last["achieved_flops_per_s"] / self.n_devices,
            ))
        return snap


# ------------------------------------------------------- latency summaries
def latency_summary(pairs: Sequence[Tuple[str, float]], top_k: int = 3) -> Dict[str, Any]:
    """p50/p95/p99, the maximum and the ``top_k`` slowest over ``(client,
    seconds)`` pairs, the straggler block of a round record; ``{}`` for no
    pairs. Nearest-rank percentiles, rounded to the microsecond."""
    if not pairs:
        return {}
    lats = sorted(v for _, v in pairs)

    def pct(p: float) -> float:
        i = min(len(lats) - 1, max(0, math.ceil(p / 100.0 * len(lats)) - 1))
        return round(lats[i], 6)

    slowest = sorted(pairs, key=lambda cv: cv[1], reverse=True)[:top_k]
    return {
        "n": len(pairs),
        "p50_s": pct(50),
        "p95_s": pct(95),
        "p99_s": pct(99),
        "max_s": round(lats[-1], 6),
        "slowest": [[c, round(v, 6)] for c, v in slowest],
    }


# --------------------------------------------------------- compile watcher
def report_build(seconds: float, kernel: str = "") -> None:
    """One kernel library compiled in ``seconds``, handed to the installed
    :class:`CompileWatcher` if there is one (``kernels.build`` calls it)."""
    watcher = CompileWatcher._active
    if watcher is not None:
        watcher._listener(seconds, kernel)


class CompileWatcher:
    """Counts and times the kernel builds of this process: each CUDA
    library :func:`fedtpu_torch.ops.kernels.build` compiles with ``nvcc``
    (none when the library is already built). After :meth:`mark_steady`,
    the owner's word that everything it runs is built, a further build is
    a kernel rebuilt in the middle of a run: it warns, bumps
    ``fedtpu_xla_recompiles_steady_total`` and writes an ``xla_recompile``
    flight event. The metric and event names are fedtpu's, so dashboards
    read the same; their help says what the port counts.

    One watcher is installed a process (:meth:`install`,
    :meth:`uninstall`)."""

    _active: Optional["CompileWatcher"] = None

    def __init__(self, telemetry=None, flight=None):
        self.telemetry = telemetry
        self.flight = flight
        self.compiles = 0
        self.compile_seconds = 0.0
        self.recompiles_after_steady = 0
        self._steady = False
        self._installed = False
        self._lock = threading.Lock()

    def _listener(self, duration: float, kernel: str = "") -> None:
        if not self._installed:
            return
        with self._lock:
            self.compiles += 1
            self.compile_seconds += duration
            steady = self._steady
            if steady:
                self.recompiles_after_steady += 1
        tel = self.telemetry
        if tel is not None:
            tel.counter(
                "fedtpu_xla_compiles_total",
                "CUDA kernel libraries built by nvcc in this process",
            ).inc()
            tel.histogram(
                "fedtpu_xla_compile_seconds",
                "nvcc wall time per CUDA kernel library",
            ).observe(duration)
        if steady:
            log.warning(
                "kernel library %s built after steady state (%.2fs): a kernel "
                "was rebuilt in the middle of the run (builds so far: %d)",
                kernel or "?", duration, self.compiles,
            )
            if tel is not None:
                tel.counter(
                    "fedtpu_xla_recompiles_steady_total",
                    "CUDA kernel libraries built after the owner declared "
                    "steady state (each one is a latent perf bug)",
                ).inc()
            if self.flight is not None:
                self.flight.record(
                    "xla_recompile",
                    duration_s=round(duration, 4),
                    compiles_total=self.compiles,
                    kernel=kernel,
                )

    def install(self) -> "CompileWatcher":
        if self._installed:
            return self
        if CompileWatcher._active is not None:
            raise RuntimeError(
                "another CompileWatcher is already installed in this process "
                "(kernel builds report to one watcher)"
            )
        self._installed = True
        CompileWatcher._active = self
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        self._installed = False
        if CompileWatcher._active is self:
            CompileWatcher._active = None

    def mark_steady(self) -> None:
        with self._lock:
            self._steady = True

    @property
    def steady(self) -> bool:
        return self._steady

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "compiles": self.compiles,
                "compile_seconds": round(self.compile_seconds, 4),
                "steady": self._steady,
                "recompiles_after_steady": self.recompiles_after_steady,
            }


# -------------------------------------------------------- capture windows
PROFILE_META = "profile_meta.json"
# The record_function range opened right after the sidecar's wall clock is
# read: the capture's zero on the profiler's clock.
_OPEN_MARK = "fedtpu_capture_open"
# Kineto's activities of a card's own work (the events of torch versions
# that name no activity are told by their device).
_DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
_LANE_PID = 1 << 30  # + the device's index: each lane's pid


def parse_round_window(spec: str) -> Tuple[int, int]:
    """Parse ``--profile-rounds N:M`` into a half-open ``[N, M)`` round
    window (``"3:5"`` captures rounds 3 and 4). A bare ``N`` means one
    round ``[N, N+1)``."""
    try:
        if ":" in spec:
            a, b = spec.split(":", 1)
            lo, hi = int(a), int(b)
        else:
            lo = int(spec)
            hi = lo + 1
    except ValueError:
        raise ValueError(f"--profile-rounds wants N:M (half-open round window), got {spec!r}")
    if lo < 0 or hi <= lo:
        raise ValueError(f"--profile-rounds window must satisfy 0 <= N < M, got {spec!r}")
    return lo, hi


def write_profile_meta(
    trace_dir: str, role: str = "", trace_id: Optional[str] = None, extra: Optional[dict] = None,
) -> str:
    """Write the ``profile_meta.json`` sidecar into a capture's directory:
    ``wall_start`` (the wall clock at the capture's zero: the device
    trace's timestamps count from it), ``role`` and ``trace_id``, which
    ``tools/trace_merge.py`` reads to align the device lanes with the host
    spans; ``extra`` is merged in last."""
    meta = {"wall_start": time.time(), "role": role, "trace_id": trace_id, "format": "torch.profiler"}
    if extra:
        meta.update(extra)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, PROFILE_META)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(meta, fh)
    os.replace(tmp, path)
    return path


def _trace_doc(events, cuda: bool) -> dict:
    """The Chrome trace of a stopped capture's profiler events, in the form
    ``tools/trace_merge.py`` reads as device lanes: on a CUDA capture each
    card's kernels, copies and memsets in a process named
    ``/device:GPU:<n>``; on a CPU capture, where the host is the device,
    every host event in ``/device:CPU:0``. Timestamps are in µs from the
    capture's open mark (events that began before it are left out). Raises
    when the mark is missing, and when a CUDA capture holds no device
    event: a capture never writes an empty lane."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    events = list(events)
    marks = [e.start_ns() for e in events if e.device_type() == cpu and e.name() == _OPEN_MARK]
    if not marks:
        raise RuntimeError(f"profiler capture: no {_OPEN_MARK} range among {len(events)} events")
    zero = min(marks)
    out: List[dict] = []
    lanes = set()
    for e in events:
        on_card = e.device_type() != cpu
        activity = e.activity_type() if hasattr(e, "activity_type") else ("kernel" if on_card else "cpu_op")
        if (on_card != cuda or e.start_ns() < zero or e.name() == _OPEN_MARK
                or (on_card and activity not in _DEVICE_ACTIVITIES)):
            continue
        lane = e.device_index() if on_card else 0
        lanes.add(lane)
        out.append({
            "ph": "X", "cat": activity, "name": e.name(), "pid": _LANE_PID + lane,
            "tid": e.device_resource_id(), "ts": round((e.start_ns() - zero) / 1e3, 3),
            "dur": round(e.duration_ns() / 1e3, 3),
        })
    if cuda and not lanes:
        raise RuntimeError(
            "profiler capture: CUDA activity was asked for but the capture holds no device "
            "event (is CUPTI available?)"
        )
    kind = "GPU" if cuda else "CPU"
    names = [{"ph": "M", "name": "process_name", "pid": _LANE_PID + n, "args": {"name": f"/device:{kind}:{n}"}}
             for n in sorted(lanes)]
    return {"traceEvents": names + out, "displayTimeUnit": "ms"}


class CaptureWindow:
    """A round-windowed ``torch.profiler`` capture for a round loop.

    The loop calls :meth:`maybe_start` with the first round of the block it
    is about to run and :meth:`maybe_stop` with the next round after it;
    the window opens before the first block that overlaps ``[lo, hi)`` and
    closes after the block that reaches ``hi``. Blocks are captured whole.
    ``stop()`` may be called twice, and must be called when the loop ends
    so that a window over the tail is written.

    The capture records the host and, on a CUDA ``device`` (the default),
    the card; ``device="cpu"`` records the host alone. On stop the device's
    work (the card's; on the CPU, the host's ops) is written to
    ``<trace_dir>/plugins/profile/<run>/<host>.trace.json``
    (:func:`find_device_trace` finds it) with timestamps counted from the
    sidecar's ``wall_start``, so that ``tools/trace_merge.py
    --device-trace <trace_dir>`` lays it on the host spans' timeline (the
    tracer's export gives the host's side)."""

    def __init__(
        self, spec: str, trace_dir: str, role: str = "", trace_id: Optional[str] = None,
        device: Any = "cuda",
    ):
        self.lo, self.hi = parse_round_window(spec)
        self.trace_dir = trace_dir
        self.role = role
        self.trace_id = trace_id
        self.device = str(device)
        self.path: Optional[str] = None
        self._prof = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def maybe_start(self, first_round: int, last_round: Optional[int] = None) -> None:
        """Open the window if block ``[first_round, last_round]`` overlaps
        it (``last_round`` defaults to ``first_round``)."""
        if self._prof is not None:
            return
        last = first_round if last_round is None else last_round
        if first_round >= self.hi or last < self.lo:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        cuda = self.device.startswith("cuda")
        if cuda and not torch.cuda.is_available():
            raise RuntimeError("CaptureWindow: a CUDA capture needs a card; pass device='cpu' for the host alone")
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
        wall = time.time()
        with record_function(_OPEN_MARK):
            pass
        self._prof = prof
        write_profile_meta(
            self.trace_dir, role=self.role, trace_id=self.trace_id,
            extra={"round_window": [self.lo, self.hi], "wall_start": wall},
        )
        log.info("profiler capture window open: rounds [%d, %d) -> %s", self.lo, self.hi, self.trace_dir)

    def maybe_stop(self, next_round: int) -> None:
        if self._prof is not None and next_round >= self.hi:
            self.stop()

    def stop(self) -> None:
        """Close the window and write its trace; nothing when it is closed."""
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        doc = _trace_doc(prof.profiler.kineto_results.events(), self.device.startswith("cuda"))
        run = os.path.join(self.trace_dir, "plugins", "profile", time.strftime("%Y_%m_%d_%H_%M_%S"))
        os.makedirs(run, exist_ok=True)
        path = os.path.join(run, f"{socket.gethostname()}.trace.json")
        with open(path + ".tmp", "w") as fh:
            json.dump(doc, fh)
        os.replace(path + ".tmp", path)
        self.path = path
        log.info("profiler capture window closed: %s", path)


def find_device_trace(trace_dir: str) -> Optional[str]:
    """The newest ``*.trace.json[.gz]`` under ``trace_dir`` (a capture
    writes ``plugins/profile/<run>/<host>.trace.json``); None if absent."""
    hits: List[str] = []
    for dirpath, _dirs, files in os.walk(trace_dir):
        for f in files:
            if f.endswith(".trace.json.gz") or f.endswith(".trace.json"):
                hits.append(os.path.join(dirpath, f))
    return max(hits, key=os.path.getmtime) if hits else None
