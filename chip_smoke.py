#!/usr/bin/env python3
"""Smoke run of the PyTorch port (fedtpu_torch) on one NVIDIA card.

    python3 chip_smoke.py              # from the repository root
    python3 chip_smoke.py --profile DIR   # also a torch.profiler table in DIR

Phases, each of which raises on failure (exit code not 0, no result line):

1. device: a CUDA card is required; its name and power limit as
   ``nvidia-smi`` reports them; TF32 off for the parity phases.
2. build: ``nvcc`` builds every kernel from ``fedtpu_torch/csrc``.
3. kernels: each kernel against its plain PyTorch version at the compressed
   smallcnn round's shapes (eight leaves x 64 clients) and at ragged
   shapes; outputs must be bit-equal. Kernel and plain version are timed
   with CUDA events, beside the bound that the card's memory rate sets.
4. reference: a small round (4 clients) on the card against the same round
   on the CPU, where the wrappers run their plain versions.
5. slice: the bench configuration at full width (smallcnn, CIFAR-10 shapes,
   64 clients, batch 128, 6 local steps, iid, presharded, bf16) for 3
   rounds with ``compression='topk'`` and 3 with ``'int8'``, the launch
   counts reset just before and read after; then timed rounds.

The last line is ``{"ok": true, "device": {...}}``; the line with the
kernels' numbers and the card's name and power limit come just before it.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from fedtpu_torch import DataConfig, FedConfig, Federation, RoundConfig, models
from fedtpu_torch.data import datasets
from fedtpu_torch.ops import compression, kernels

NUM_CLIENTS = 64
BATCH = 128
STEPS = 391 // NUM_CLIENTS  # the reference's local-epoch share at 64 clients
CHECK_ROUNDS = 3
TIMED_ROUNDS = 5
TOPK_FRACTION = 0.01

# Published peaks (NVIDIA data sheets, dense, full power): HBM bytes/s and
# f32 FLOP/s outside the tensor cores, by the name torch reports.
CARDS = (
    ("H100 80GB HBM3", 3.35e12, 67e12),   # H100 SXM
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H200", 4.8e12, 67e12),
)

# Per kernel: the TPU kernel it replaces, its source, bytes moved per
# element and per row, and f32 operations per element.
KERNEL_INFO = {
    "threshold_feedback": dict(
        replaces="fedtpu/ops/pallas_kernels.py:108",
        tpu_function="threshold_with_feedback",
        source="fedtpu_torch/csrc/threshold_feedback.cu",
        bytes_per_elem=12, bytes_per_row=4, ops_per_elem=3,
    ),
    "quantdequant_int8": dict(
        replaces="fedtpu/ops/pallas_kernels.py:233",
        tpu_function="quantdequant_int8",
        source="fedtpu_torch/csrc/quantdequant_int8.cu",
        bytes_per_elem=8, bytes_per_row=4, ops_per_elem=5,
    ),
}


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------- 1. device


def device_phase():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    for key, bw, f32 in CARDS:
        if key in name:
            peaks = (bw, f32)
            break
    else:
        raise SystemExit(f"chip_smoke: no published peaks for card {name!r}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    log(f"device: {name} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    log(
        f"device: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"float32_matmul_precision={torch.get_float32_matmul_precision()}"
    )
    return smi, name, peaks


# -------------------------------------------------------------- 2. build


def build_phase():
    t0 = time.perf_counter()
    logs = kernels.build()
    secs = time.perf_counter() - t0
    for name, out in logs.items():
        for line in out.strip().splitlines():
            log(f"build {name}: {line.strip()}")
    for name in kernels.KERNELS:
        if not kernels.library_path(name).exists():
            raise RuntimeError(f"build: {name} has no library")
    log(f"build: {len(kernels.KERNELS)} kernels in {secs:.2f} s")


# ------------------------------------------------------------ 3. kernels


def smallcnn_leaf_sizes():
    model = models.create("smallcnn", 10)
    return {k: p.numel() for k, p in model.named_parameters()}


def _inputs(name, rng, rows, cols, dev):
    """The operands at one shape, with the edge cases the tests use: a
    -0.0, a threshold tied with a value, an all-zero row of scale 0, and
    quotients exactly halfway between integers."""
    x = rng.standard_normal((rows, cols), dtype=np.float32)
    x[0, 0] = -0.0
    if name == "threshold_feedback":
        v = np.abs(x[:, min(1, cols - 1)]).astype(np.float32)
        v[1::2] = 0.5
        if rows > 2:
            v[2] = 0.0
    else:
        v = (np.abs(x).max(axis=1) / np.float32(127.0)).astype(np.float32)
        if rows > 1:
            x[1] = ((rng.integers(-130, 130, size=cols) + 0.5) * 0.25).astype(np.float32)
            v[1] = 0.25
        if rows > 2:
            x[2] = 0.0
            v[2] = 0.0
    return torch.from_numpy(x).to(dev), torch.from_numpy(v).to(dev)


def _bits_equal(a, b) -> bool:
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _time_ms(fn, runs=21, calls=10) -> float:
    """Device time of one call, in ms: the median over ``runs`` of
    ``calls`` calls enqueued back to back between two CUDA events, divided
    by ``calls``. Each run is queued behind a device-side sleep, so the
    events time the card's work and not the host's launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)  # ~2 ms: the host enqueues meanwhile
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) / calls for a, b in pairs)


def kernel_phase(peaks):
    bw, f32_peak = peaks
    dev = torch.device("cuda")
    leaves = smallcnn_leaf_sizes()
    ragged = [(1, 1), (1, 700), (3, 257), (2, 1), (64, 1000), (5, 65537)]
    rng = np.random.default_rng(0)
    results = {}
    for name, (wrapper, plain) in kernels.KERNELS.items():
        info = KERNEL_INFO[name]
        max_err = 0.0
        ms = plain_ms = bytes_moved = ops = 0.0
        per_leaf = {}
        shapes = [(NUM_CLIENTS, c) for c in leaves.values()] + ragged
        for i, (rows, cols) in enumerate(shapes):
            x, v = _inputs(name, rng, rows, cols, dev)
            got = _as_tuple(wrapper(x, v))
            want = _as_tuple(plain(x, v))
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                max_err = max(max_err, float((g - w).abs().max()))
                if not _bits_equal(g, w):
                    raise RuntimeError(f"kernels: {name} differs from its plain version at {rows}x{cols}")
            if i < len(leaves):  # the main path's shapes: time and bound
                k = _time_ms(lambda: wrapper(x, v))
                p = _time_ms(lambda: plain(x, v))
                ms += k
                plain_ms += p
                bytes_moved += rows * cols * info["bytes_per_elem"] + rows * info["bytes_per_row"]
                ops += rows * cols * info["ops_per_elem"]
                per_leaf[f"{rows}x{cols}"] = {"ms": k, "plain_ms": p}
        bound_bytes_ms = bytes_moved / bw * 1e3
        bound_ops_ms = ops / f32_peak * 1e3
        results[name] = {
            "name": name,
            "route": "cuda",
            "source": info["source"],
            "replaces": info["replaces"],
            "tpu_function": info["tpu_function"],
            "bitwise_equal": True,
            "max_abs_err": max_err,
            "ms": ms,
            "kernel_ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bound_bytes_ms, bound_ops_ms),
            "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
            "bytes": bytes_moved,
            "library_ms": None,  # no single PyTorch call computes this function
        }
        log(
            f"kernels: {name} bit-equal at {len(shapes)} shapes; one round's 8 leaves: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {results[name]['bound_ms']:.4f} ms "
            f"({bytes_moved / 1e6:.1f} MB) | per leaf {json.dumps(per_leaf)}"
        )
    return results


# ---------------------------------------------------------- 4. reference


def _small_cfg(compression_name):
    # No augmentation: the two devices would draw different crops.
    return RoundConfig(
        model="smallcnn",
        data=DataConfig(dataset="cifar10", batch_size=8, partition="iid", augment=False),
        fed=FedConfig(num_clients=4, compression=compression_name),
        steps_per_round=2,
    )


def reference_phase():
    """The port on the card against the port on the CPU (plain versions)
    from the same init and batches: at most 0.1% of coordinates beyond
    atol=1e-5, rtol=1e-4 after two rounds (a last-bit difference in a
    delta can cross a top-k threshold or an int8 rounding boundary)."""
    rng = np.random.default_rng(1)
    images = rng.standard_normal((64, 32, 32, 3), dtype=np.float32)
    labels = rng.integers(0, 10, size=64).astype(np.int32)
    for comp in ("none", "topk", "int8"):
        cfg = _small_cfg(comp)
        cpu = Federation(cfg, seed=0, data=(images, labels), device="cpu")
        gpu = Federation(cfg, seed=0, data=(images, labels))
        gpu.state = gpu.state._replace(params={k: v.cuda() for k, v in cpu.state.params.items()})
        for r in range(2):
            cpu.step(cpu.device_batch(r, offset=r + 3))
            gpu.step(gpu.device_batch(r, offset=r + 3))
        bad = total = 0
        for k, w in cpu.state.params.items():
            g = gpu.state.params[k].cpu()
            if not torch.isfinite(g).all():
                raise RuntimeError(f"reference: non-finite {comp} {k}")
            bad += int(((g - w).abs() > 1e-5 + 1e-4 * w.abs()).sum())
            total += w.numel()
        if bad > 0.001 * total:
            raise RuntimeError(f"reference: {comp}: {bad} of {total} coordinates differ from the CPU")
        log(f"reference: {comp}: card vs CPU after 2 rounds, {bad} of {total} coordinates beyond tolerance")


# -------------------------------------------------------------- 5. slice


def bench_cfg(compression_name: str) -> RoundConfig:
    """bench.py's configuration, with the update codec switched on."""
    return RoundConfig(
        model="smallcnn",
        num_classes=10,
        data=DataConfig(
            dataset="cifar10", batch_size=BATCH, partition="iid",
            num_examples=NUM_CLIENTS * STEPS * BATCH,
        ),
        fed=FedConfig(
            num_clients=NUM_CLIENTS, compression=compression_name,
            topk_fraction=TOPK_FRACTION,
        ),
        steps_per_round=STEPS,
        dtype="bfloat16",
    )


class Recorder:
    """Wraps a codec; keeps the inputs and outputs of the round it is armed
    for, so the plain codec can be re-applied to the same tensors."""

    def __init__(self, codec: compression.Compressor):
        self.codec = codec
        self.armed = False
        self.seen = None

    def apply(self, deltas, state):
        out, new_state = self.codec.apply(deltas, state)
        if self.armed:
            clone = lambda t: {k: v.clone() for k, v in t.items()}
            self.seen = (clone(deltas), clone(state), out, new_state)
            self.armed = False
        return out, new_state

    def compressor(self) -> compression.Compressor:
        return compression.Compressor(init=self.codec.init, apply=self.apply)


def _state_tensors(state):
    yield from state.params.values()
    yield from state.opt_state.values()
    if state.comp_state:
        yield from state.comp_state.values()


def _launch_counts():
    return {name: wrapper.launches for name, (wrapper, _) in kernels.KERNELS.items()}


SLICE_CODECS = {
    "topk": ("threshold_feedback", lambda: compression.make_topk(
        TOPK_FRACTION, threshold=kernels.threshold_feedback_plain)),
    "int8": ("quantdequant_int8", lambda: compression.make_int8(
        quantdequant=kernels.quantdequant_int8_plain)),
}


def slice_phase(data):
    """The main path: CHECK_ROUNDS rounds per codec through Federation.step.
    Returns the engines (for timing) and the launch counts of this run."""
    n_leaves = len(smallcnn_leaf_sizes())
    feds = {}
    kernels.reset_launch_counts()
    for codec, (counted, make_plain) in SLICE_CODECS.items():
        cfg = bench_cfg(codec)
        rec = Recorder(compression.make_compressor(cfg.fed))
        fed = Federation(cfg, seed=0, data=data, compressor=rec.compressor())
        for r in range(CHECK_ROUNDS):
            before = _launch_counts()
            rec.armed = r == 1
            m = fed.step()
            torch.cuda.synchronize()
            after = _launch_counts()
            for name in after:
                want = n_leaves if name == counted else 0
                if after[name] - before[name] != want:
                    raise RuntimeError(
                        f"slice {codec} round {r}: {name} launched "
                        f"{after[name] - before[name]} times, expected {want}"
                    )
            loss = float(m.loss)
            if not math.isfinite(loss):
                raise RuntimeError(f"slice {codec} round {r}: loss {loss}")
            for t in _state_tensors(fed.state):
                if t.device.type != "cuda":
                    raise RuntimeError(f"slice {codec}: a state tensor is on {t.device}")
            if any(not bool(e.any()) for e in fed.state.comp_state.values()):
                raise RuntimeError(f"slice {codec} round {r}: a residual leaf is all zero")
            log(
                f"slice {codec} round {r}: loss {loss:.6f} acc {float(m.accuracy):.4f} "
                f"update_norm {float(m.update_norm):.6f} {counted} +{after[counted] - before[counted]}"
            )
        deltas, state, out, new_state = rec.seen
        out_p, new_p = make_plain().apply(deltas, state)
        for k in out:
            if not (_bits_equal(out[k], out_p[k]) and _bits_equal(new_state[k], new_p[k])):
                raise RuntimeError(f"slice {codec}: kernel codec differs from plain at {k}")
        log(f"slice {codec}: round 1's codec output and residuals bit-equal to the plain codec")
        rec.seen = None
        feds[codec] = fed
    return feds, _launch_counts()


def timing_phase(feds, data, card):
    """Rounds/s of each codec (and uncompressed) after the checked rounds,
    through Federation.run_on_device, host clock around a synchronize."""
    feds = dict(feds)
    feds["none"] = Federation(bench_cfg("none"), seed=0, data=data)
    feds["none"].run_on_device(1)  # warm-up
    rates = {}
    for codec in ("none", "topk", "int8"):
        fed = feds[codec]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = fed.run_on_device(TIMED_ROUNDS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not torch.isfinite(m.loss).all():
            raise RuntimeError(f"timing {codec}: non-finite loss {m.loss.tolist()}")
        rates[codec] = {
            "compression": codec,
            "rounds": TIMED_ROUNDS,
            "seconds": dt,
            "rounds_per_s": TIMED_ROUNDS / dt,
            "client_epochs_per_s": TIMED_ROUNDS * NUM_CLIENTS / dt,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "card": card,
        }
        log("timing: " + json.dumps(rates[codec]))
    return feds, rates


def profile_phase(fed, out_dir: Path):
    """torch.profiler over two topk rounds: CUDA time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fed.run_on_device(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fed.run_on_device(2)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # Device-side rows only (kernels, copies): an operator's row repeats
    # the time of the kernels it launched.
    busy_ms = sum(
        e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA
    ) / 1e3
    log(
        f"profile: 2 topk rounds, device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms "
        f"wall under the profiler ({100 * busy_ms / wall_ms:.1f}%)"
    )
    table = events.table(sort_by="self_device_time_total", row_limit=40)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "profile_topk.txt").write_text(table)
    prof.export_chrome_trace(str(out_dir / "profile_topk_trace.json"))
    for line in table.splitlines()[:25]:
        log(f"profile: {line}")


# --------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument(
        "--profile", metavar="DIR",
        help="also profile two topk rounds; write the table and trace to DIR",
    )
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    smi, name, peaks = device_phase()
    build_phase()
    results = kernel_phase(peaks)
    reference_phase()
    data = datasets.load("cifar10", "train", seed=0, num=NUM_CLIENTS * STEPS * BATCH)
    feds, launches = slice_phase(data)
    for kname, count in launches.items():
        if count == 0:
            raise RuntimeError(f"slice: {kname} was never launched on the main path")
        results[kname]["launches"] = count
    feds, _ = timing_phase(feds, data, smi)
    if args.profile:
        profile_phase(feds["topk"], Path(args.profile))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(results.values())}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
