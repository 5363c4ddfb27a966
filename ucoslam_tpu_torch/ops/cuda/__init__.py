"""Build and load the hand-written CUDA kernels (`ucoslam_tpu_torch/csrc/*.cu`).

Each source is compiled on its own by `nvcc` for `sm_90a` into a shared
library with a plain C interface, loaded with `ctypes`. The library lands in
`build/ucoslam_tpu_torch/` at the repository root, named after a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one is
reused. Nothing is built when the package is imported: the first launch on a
CUDA tensor builds every kernel of `KERNELS` that is not built yet, one nvcc
each, all started together (or `build(...)` those named); a missing `nvcc`
or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

#: the kernel sources, `csrc/<name>.cu`: B1, B2, and the detect stage's F1 and F2
KERNELS = ("match_kernel", "lm_kernel", "fast_kernel")
CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "ucoslam_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
)

#: seconds spent in nvcc by this process, per kernel source
build_seconds: dict[str, float] = {}
#: held while building: in async mode the tracker and the mapping worker
#: both launch kernels
_build_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(*names: str) -> None:
    """Build the libraries of `csrc/<name>.cu` that are not built yet, with
    one nvcc process for each, all started together."""
    with _build_lock:
        _build(names)


def _build(names) -> None:
    jobs = {}
    for name in names:
        lib = _library_path(name)
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        src = CSRC_DIR / f"{name}.cu"
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        jobs[name] = (proc, tmp, lib, src, time.perf_counter())
    for name, (proc, tmp, lib, src, t0) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{err}")
        os.replace(tmp, lib)
        build_seconds[name] = time.perf_counter() - t0


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Load `csrc/<name>.cu`, building first every kernel not built yet (so
    that no later first launch waits for an nvcc of its own); cached per
    process."""
    build(*KERNELS)
    return ctypes.CDLL(str(_library_path(name)))


def check_launch(err: int, kernel: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C launcher."""
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError_t {err}")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_cuda_args(device: torch.device, **tensors: tuple[torch.Tensor, torch.dtype, tuple]) -> None:
    """Validate device, dtype, shape (None = any extent) and contiguity."""
    for name, (t, dtype, shape) in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)
        ):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
