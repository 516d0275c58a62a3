"""The compressed round's hand-written CUDA kernels, their plain versions
and their build.

The port of ``fedtpu.ops.pallas_kernels``. Each kernel is one CUDA C++
source under ``fedtpu_torch/csrc/`` with a plain C entry point, compiled by
``nvcc`` for ``sm_90a`` into a shared library under ``fedtpu_torch/_build/``
at its first use (or by :func:`build`) and called through ``ctypes``:

- :func:`threshold_feedback` (``csrc/threshold_feedback.cu``) replaces
  ``threshold_with_feedback``: top-k masking with error feedback.
- :func:`quantdequant_int8` (``csrc/quantdequant_int8.cu``) replaces
  ``quantdequant_int8``: the simulated int8 codec.

A wrapper launches its kernel for CUDA tensors and raises if it cannot; it
takes the plain PyTorch version only for tensors that lie on the CPU (the
tests). It counts its launches in a plain integer attribute, ``launches``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# Never --use_fast_math: the int8 kernel needs IEEE division and rounding to
# match fedtpu bit for bit. -Xptxas -v prints registers and spills per kernel.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
# name -> (source file, C entry point argument types)
_SOURCES = {
    "threshold_feedback": ("threshold_feedback.cu", [_P, _P, _P, _P, _I64, _I64, _P]),
    "quantdequant_int8": ("quantdequant_int8.cu", [_P, _P, _P, _I64, _I64, _P]),
}
_MAX_ROWS = 65535  # the kernels put rows on gridDim.y

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
    compiled kernel's compiler output; raises if any build fails."""
    names = list(_SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    logs: Dict[str, str] = {}
    failed = []
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
        for name, (proc, tmp, lib) in procs.items():
            logs[name], _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name} (nvcc exit {proc.returncode}):\n{logs[name]}")
            else:
                os.replace(tmp, lib)
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
    """The kernels take a contiguous f32 ``[rows, cols]`` CUDA matrix and a
    contiguous f32 ``[rows]`` vector on the same card."""
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
    if x.shape[0] > _MAX_ROWS:
        raise ValueError(f"{name}: at most {_MAX_ROWS} rows, got {x.shape[0]}")
    if not (x.is_contiguous() and per_row.is_contiguous()):
        raise ValueError(f"{name}: operands must be contiguous")


# ------------------------------------------------------------------ K1


def threshold_feedback_plain(
    y: torch.Tensor, thresh: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``out = where(|y| >= thresh[row], y, 0)``, ``new_e = y - out``."""
    out = torch.where(y.abs() >= thresh[:, None], y, torch.zeros_like(y))
    return out, y - out


def threshold_feedback(
    y: torch.Tensor, thresh: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused top-k mask and residual split of ``y [rows, cols]`` f32 by the
    per-row magnitude threshold ``thresh [rows]``: ``(out, new_e)``."""
    if y.device.type == "cpu":
        return threshold_feedback_plain(y, thresh)
    _check_rows("threshold_feedback", y, thresh)
    out = torch.empty_like(y)
    new_e = torch.empty_like(y)
    if y.numel():
        rows, cols = y.shape
        _launch(
            "threshold_feedback", y, y.data_ptr(), thresh.data_ptr(),
            out.data_ptr(), new_e.data_ptr(), rows, cols,
        )
        threshold_feedback.launches += 1
    return out, new_e


threshold_feedback.launches = 0


# ------------------------------------------------------------------ K2


def quantdequant_int8_plain(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / s'), -127, 127) * s'`` with ``s' = s > 0 ? s : 1``
    per row; ``round`` is half-to-even."""
    s = scale[:, None]
    safe = torch.where(s > 0, s, torch.ones_like(s))
    return torch.clamp(torch.round(x / safe), -127.0, 127.0) * safe


def quantdequant_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Simulated symmetric int8 codec of ``x [rows, cols]`` f32 with per-row
    ``scale [rows]`` (each row's max|x| / 127)."""
    if x.device.type == "cpu":
        return quantdequant_int8_plain(x, scale)
    _check_rows("quantdequant_int8", x, scale)
    out = torch.empty_like(x)
    if x.numel():
        rows, cols = x.shape
        _launch(
            "quantdequant_int8", x, x.data_ptr(), scale.data_ptr(),
            out.data_ptr(), rows, cols,
        )
        quantdequant_int8.launches += 1
    return out


quantdequant_int8.launches = 0

KERNELS = {
    "threshold_feedback": (threshold_feedback, threshold_feedback_plain),
    "quantdequant_int8": (quantdequant_int8, quantdequant_int8_plain),
}


def reset_launch_counts() -> None:
    for wrapper, _ in KERNELS.values():
        wrapper.launches = 0
