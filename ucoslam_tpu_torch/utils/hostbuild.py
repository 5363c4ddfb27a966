"""Build host C++ sources of the port into shared libraries with g++.

A library lands in `build/ucoslam_tpu_torch/` at the repository root, named
after a hash of its source, its headers, the flags, the compiler's version
and the target options `-march=native` enables on this CPU (as g++ lists
them), so an edited source is rebuilt and a library built on one machine is
never loaded on another whose CPU or compiler differs. Nothing is built
when a module is imported: the first call that needs a library builds it.
A missing compiler or a failed build raises: no caller has a fallback.

Used by the native ArUco detector (`markers/native.py`) and the PNG
decoder's row unfilter (`io/png.py`, `csrc/host/png_unfilter.cpp`).
"""

from __future__ import annotations

import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ucoslam_tpu_torch"
HOST_DIR = Path(__file__).resolve().parents[1] / "csrc" / "host"

#: seconds g++ took in this process, per library name (absent: it was already built)
build_seconds: dict[str, float] = {}
_lock = threading.Lock()


def compiler() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the port's host libraries cannot be built")
    return cxx


@functools.cache
def host_target() -> bytes:
    """The compiler's version and the target options `-march=native`
    enables on this CPU, as g++ lists them."""
    cxx = compiler()
    parts = []
    for args in (["--version"], ["-march=native", "-Q", "--help=target"]):
        out = subprocess.run([cxx, *args], capture_output=True, text=True, timeout=60)
        if out.returncode != 0:
            raise RuntimeError(f"g++ {' '.join(args)} failed:\n{out.stderr}")
        parts.append(out.stdout)
    return "".join(parts).encode()


@dataclass(frozen=True)
class HostLibrary:
    """One C++ source built into `lib<name>_<hash>.so`."""

    name: str
    source: Path
    headers: tuple[Path, ...] = ()
    flags: tuple[str, ...] = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")

    def path(self) -> Path:
        digest = hashlib.sha256(b"".join(p.read_bytes() for p in (self.source, *self.headers))
                                + " ".join(self.flags).encode() + host_target())
        return BUILD_DIR / f"lib{self.name}_{digest.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile the library unless it is there; -> its path."""
        with _lock:
            lib = self.path()
            if lib.exists():
                return lib
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            out = subprocess.run([compiler(), *self.flags, "-o", str(tmp), str(self.source)],
                                 capture_output=True, text=True, timeout=300)
            if out.returncode != 0:
                raise RuntimeError(f"g++ failed on {self.source}:\n{out.stderr}")
            os.replace(tmp, lib)
            build_seconds[self.name] = time.perf_counter() - t0
            return lib
