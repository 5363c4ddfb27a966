"""Builds of the port's CUDA kernels for the measuring tools.

The port's own libraries (`ucoslam_tpu_torch/ops/cuda`) hold one launch of
each kernel. `build(name, *defines)` compiles `csrc/<name>.cu` again with
preprocessor flags into `build/variants/`:

- `UCOSLAM_VARIANTS` adds the launches measured against the default:
  B1 with a fixed number of lanes a point (`MATCH_GROUPS`), B2 with other
  block and cluster sizes (`LM_VARIANTS`);
- `UCOSLAM_PROBES` adds clock64() stamps at the phase boundaries and
  `probe_read` (see `probe_kernels.py`).

`match_variant` and `lm_variant` launch one of them on CUDA tensors.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import torch

#: lanes a point of B1's variant launches
MATCH_GROUPS = (8, 16, 32)
#: (threads a block, blocks a cluster) of B2's variant launches; the port's is (256, 8)
LM_VARIANTS = ((256, 1), (512, 1), (1024, 1), (256, 2), (128, 4), (256, 4), (128, 8), (256, 8))


def build(name: str, *defines: str) -> ctypes.CDLL:
    """Compile csrc/<name>.cu with -D<define> for each define and load it.
    The library's `ptxas` attribute holds ptxas's lines on each kernel's
    registers and spills."""
    from ucoslam_tpu_torch.ops import cuda

    tag = "_".join(d.lower() for d in defines) or "plain"
    out = os.path.join(os.path.dirname(cuda.BUILD_DIR), "variants", f"lib{name}_{tag}.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    src = str(cuda.CSRC_DIR / f"{name}.cu")
    flags = [f"-D{d}" for d in defines]
    proc = subprocess.run([cuda._nvcc(), *cuda.NVCC_FLAGS, *flags, "-Xptxas=-v", "-o", out, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    lib = ctypes.CDLL(out)
    lib.ptxas = [ln.strip() for ln in proc.stderr.splitlines()
                 if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "match_kernel":
        lib.project_match_launch_variant.argtypes = [p, p, p, p, i, p, p, p, p, p, i, p, p, p, i, p]
        lib.project_match_launch_variant.restype = ctypes.c_int
    else:
        lib.motion_only_lm_launch_variant.argtypes = [p, p, p, p, p, p, i, f, f, f, f, f, f, i, i, i,
                                                      p, p, i, i, p]
        lib.motion_only_lm_launch_variant.restype = ctypes.c_int
    return lib


def _check(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} variant launch failed: cudaError_t {err}")


def match_variant(lib: ctypes.CDLL, args, group: int):
    """B1 with `group` lanes for every point on project_match's arguments
    -> (idx, best, second)."""
    desc_a, uv_a, oct_a, valid_a, desc_b, uv_b, oct_b, valid_b, radius2 = args
    P, N = desc_a.shape[0], desc_b.shape[0]
    out = [torch.empty(P, dtype=torch.int32, device=desc_a.device) for _ in range(3)]
    _check(lib.project_match_launch_variant(
        desc_a.data_ptr(), uv_a.data_ptr(), oct_a.data_ptr(), valid_a.data_ptr(), P,
        desc_b.data_ptr(), uv_b.data_ptr(), oct_b.data_ptr(), valid_b.data_ptr(), radius2.data_ptr(), N,
        *(t.data_ptr() for t in out), group, torch.cuda.current_stream().cuda_stream), "project_match")
    return tuple(out)


def lm_variant(lib: ctypes.CDLL, launch: tuple[int, int], pose_init, pts3d, uv, sigma2, valid,
               fx, fy, cx, cy, depth=None, bf=None, iters=10, rounds=4, has_depth=False):
    """B2 as launched with (threads, cluster) on motion_only_lm_fused's
    arguments -> (pose (4, 4), inliers (B,) bool)."""
    from ucoslam_tpu_torch.config import CHI2_2D, CHI2_3D

    B = pts3d.shape[0]
    pose = torch.empty(4, 4, dtype=torch.float32, device=pts3d.device)
    mask = torch.empty(B, dtype=torch.uint8, device=pts3d.device)
    _check(lib.motion_only_lm_launch_variant(
        pose_init.data_ptr(), pts3d.data_ptr(), uv.data_ptr(), sigma2.data_ptr(), valid.data_ptr(),
        depth.data_ptr() if has_depth else None, B, fx, fy, cx, cy, bf or 0.0,
        float(CHI2_3D if has_depth else CHI2_2D), iters, rounds, int(has_depth),
        pose.data_ptr(), mask.data_ptr(), *launch, torch.cuda.current_stream().cuda_stream),
        "motion_only_lm")
    return pose, mask.view(torch.bool)
