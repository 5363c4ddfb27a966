"""Kernel B1: fused projection matching (Hamming + gates + best-2).

Port of `ucoslam_tpu/ops/pallas/match_kernel.py::project_match_pallas`. The
CUDA kernel is `csrc/match_kernel.cu`; its source note says what bounds it on
the card and how the design answers that. `project_match_plain` is the same
function in plain PyTorch: the CPU path and the kernel's reference.
"""

from __future__ import annotations

import ctypes

import torch

from ucoslam_tpu_torch.ops import cuda
from ucoslam_tpu_torch.ops.hamming import INVALID_DIST, hamming_matrix, match_best2
from ucoslam_tpu_torch.utils.timers import timers


def project_match_plain(desc_a, uv_a, oct_a, valid_a, desc_b, uv_b, oct_b, valid_b, radius2):
    """-> (best_idx (P,), best (P,), second (P,)) int32; best_idx -1 when no
    keypoint passes the gates. The reference's dense path: the whole (P, N)
    distance matrix (XOR + popcount), masked, then best-2 per row."""
    du = uv_a[:, None, 0] - uv_b[None, :, 0]
    dv = uv_a[:, None, 1] - uv_b[None, :, 1]
    mask = (
        (du * du + dv * dv < radius2[None, :])
        & ((oct_a[:, None] - oct_b[None, :]).abs() <= 1)
        & valid_a[:, None]
        & valid_b[None, :]
    )
    idx, best, second = match_best2(hamming_matrix(desc_a, desc_b), extra_mask=mask)
    idx = torch.where(best < INVALID_DIST, idx, -1).to(torch.int32)
    return idx, best, second


def project_match(desc_a, uv_a, oct_a, valid_a, desc_b, uv_b, oct_b, valid_b, radius2):
    """B1 on the tensors' device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Shapes: desc (P|N, 8) int32 (uint32 bits), uv
    (P|N, 2) float32, octave (P|N,) int32, valid (P|N,) bool, radius2 (N,)
    float32. Any P and N."""
    if desc_a.device.type == "cpu":
        return project_match_plain(
            desc_a, uv_a, oct_a, valid_a, desc_b, uv_b, oct_b, valid_b, radius2
        )
    dev = desc_a.device
    if dev.type != "cuda":
        raise ValueError(f"project_match runs on CPU or CUDA tensors, not {dev}")
    P, N = desc_a.shape[0], desc_b.shape[0]
    cuda.check_cuda_args(
        dev,
        desc_a=(desc_a, torch.int32, (P, 8)), uv_a=(uv_a, torch.float32, (P, 2)),
        oct_a=(oct_a, torch.int32, (P,)), valid_a=(valid_a, torch.bool, (P,)),
        desc_b=(desc_b, torch.int32, (N, 8)), uv_b=(uv_b, torch.float32, (N, 2)),
        oct_b=(oct_b, torch.int32, (N,)), valid_b=(valid_b, torch.bool, (N,)),
        radius2=(radius2, torch.float32, (N,)),
    )
    if desc_a.data_ptr() % 16 or desc_b.data_ptr() % 16:
        raise ValueError("descriptor rows must be 16-byte aligned")
    idx, best, second = (torch.empty(P, dtype=torch.int32, device=dev) for _ in range(3))
    if P == 0:  # nothing to launch, and nothing to count
        return idx, best, second
    err = _library().project_match_launch(
        desc_a.data_ptr(), uv_a.data_ptr(), oct_a.data_ptr(), valid_a.data_ptr(), P,
        desc_b.data_ptr(), uv_b.data_ptr(), oct_b.data_ptr(), valid_b.data_ptr(),
        radius2.data_ptr(), N, idx.data_ptr(), best.data_ptr(), second.data_ptr(),
        cuda.stream_handle(dev),
    )
    cuda.check_launch(err, "project_match")
    timers.count("B1")
    return idx, best, second


def _library() -> ctypes.CDLL:
    lib = cuda.load_library("match_kernel")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.project_match_launch.argtypes = [p, p, p, p, i, p, p, p, p, p, i, p, p, p, p]
    lib.project_match_launch.restype = ctypes.c_int
    return lib
