"""ctypes binding of the native C++ ArUco detector.

Port of `ucoslam_tpu/markers/native.py`. The source is the port's copy of
the repository's `native/aruco_detector.cpp`,
`csrc/host/aruco_detector.cpp`: the same detector, with no built-in table
and a choice of corner order (its header says why). `g++` compiles it with
native/Makefile's flags into `build/ucoslam_tpu_torch/`, under a name made
from a hash of the source, the flags (as the CUDA libraries are named) and
the compiler and host CPU that `-march=native` stands for, at the first
detection, never when the module is imported (`utils/hostbuild.py`): a
library built on one machine is never loaded on another whose CPU or
compiler differs. The port never builds into `native/` and never loads a
library it finds there. A missing compiler or a failed build or load
raises: there is no other detector to fall back to.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from ucoslam_tpu_torch.markers.dictionary import dict_bits, load_codewords, resolve
from ucoslam_tpu_torch.utils import hostbuild
from ucoslam_tpu_torch.utils.hostbuild import BUILD_DIR  # noqa: F401

SOURCE = hostbuild.HOST_DIR / "aruco_detector.cpp"
#: native/Makefile's flags, so the port's library computes what the JAX
#: package's does, bit for bit
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared")
LIBRARY = hostbuild.HostLibrary("aruco_native", SOURCE, (), CXX_FLAGS)

#: seconds g++ took in this process (0.0 when the library was already built)
build_seconds = 0.0


def library_path():
    return LIBRARY.path()


def build():
    """Compile the detector into build/ucoslam_tpu_torch/ unless it is there."""
    global build_seconds
    lib = LIBRARY.build()
    build_seconds = hostbuild.build_seconds.get(LIBRARY.name, 0.0)
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the detector; cached per process."""
    lib = ctypes.CDLL(str(build()))
    lib.aruco_detect.restype = ctypes.c_int
    lib.aruco_detect.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
    ]
    return lib


def detect_markers_native(gray: np.ndarray, max_out: int = 32, min_perimeter: int = 40, max_correction: int = 1,
                          dictionary: str = "ARUCO_MIP_36h12"):
    """(H, W) gray image -> (ids (n,) int32, corners (n, 4, 2) float32).
    The dictionary's codewords (`dictionary.resolve`: a native/ header or
    cv2's table) are passed in. A code within `max_correction` bits of a
    word, in one of its four rotations, decodes to it (negative: one
    threshold window and no correction). Corners come in native/'s order
    for a native table and in cv2's for a cv2 one."""
    lib = load_library()
    img = np.ascontiguousarray(np.clip(gray, 0, 255), np.uint8)
    if img.ndim != 2:
        raise ValueError(f"expected a gray (H, W) image, got shape {img.shape}")
    h, w = img.shape
    corners = np.zeros((max_out, 4, 2), np.float32)
    ids = np.zeros(max_out, np.int32)
    words = np.ascontiguousarray(load_codewords(dictionary), np.uint64)
    n = lib.aruco_detect(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h,
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), len(words), dict_bits(dictionary),
        min_perimeter, max_correction, int(resolve(dictionary).source == "cv2"),
        corners.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), max_out,
    )
    del words  # the codewords stay alive until the call returns
    if n < 0:
        raise ValueError(f"the native detector refused dictionary {dictionary!r}")
    return ids[:n].copy(), corners[:n].copy()
