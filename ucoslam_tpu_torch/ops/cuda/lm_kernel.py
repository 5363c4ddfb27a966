"""Kernel B2: fused robust motion-only LM for one camera pose, or a batch.

Port of `ucoslam_tpu/ops/pallas/lm_kernel.py::motion_only_lm_fused`, and
(`motion_only_lm_fused_batched`) of `jax.vmap` over it. The CUDA kernel is
`csrc/lm_kernel.cu`; its source note says what bounds it on the card and how
the design answers that. `motion_only_lm_plain` is the same computation in
plain PyTorch, CG(8) solve included: the CPU path and the kernel's
reference. It keeps every decision on the device (no host sync).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ucoslam_tpu_torch.config import CHI2_2D, CHI2_3D
from ucoslam_tpu_torch.geometry.se3 import _hat
from ucoslam_tpu_torch.ops import cuda
from ucoslam_tpu_torch.optim.robust import huber_weight
from ucoslam_tpu_torch.utils.timers import timers


def _f32(x) -> float:
    return float(np.float32(x))


def _cg6(H: torch.Tensor, g: torch.Tensor, n_iter: int = 8) -> torch.Tensor:
    """Solve H x = g for SPD (6, 6) H with fixed-iteration CG."""
    x = torch.zeros_like(g)
    r, p = g, g
    rs = (r * r).sum()
    for _ in range(n_iter):
        Hp = H @ p
        alpha = rs / ((p * Hp).sum() + 1e-30)
        x = x + alpha * p
        r = r - alpha * Hp
        rs_new = (r * r).sum()
        p = r + (rs_new / (rs + 1e-30)) * p
        rs = rs_new
    return x


def _se3_exp_neg(delta: torch.Tensor) -> torch.Tensor:
    """exp(-delta) for delta (6,) = [rho, phi] -> (4, 4), as the kernels do."""
    rho, phi = -delta[:3], -delta[3:]
    K = _hat(phi)
    KK = K @ K
    t2 = (phi * phi).sum()
    th = torch.sqrt(t2 + 1e-16)
    small = t2 < 1e-8
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(th)) / t2.clamp(min=1e-16))
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0, (th - torch.sin(th)) / (t2 * th).clamp(min=1e-24))
    eye = torch.eye(3, dtype=delta.dtype, device=delta.device)
    E = torch.eye(4, dtype=delta.dtype, device=delta.device)
    E[:3, :3] = eye + a * K + b * KK
    E[:3, 3] = (eye + b * K + c * KK) @ rho
    return E


def motion_only_lm_plain(
    pose_init, pts3d, uv, sigma2, valid, fx, fy, cx, cy,
    depth=None, bf=None, iters=10, rounds=4, has_depth=False,
):
    """-> (pose (4, 4), inliers (B,) bool)."""
    fx, fy, cx, cy = _f32(fx), _f32(fy), _f32(cx), _f32(cy)
    bf = _f32(bf if bf is not None else 0.0)
    delta2 = _f32(CHI2_3D if has_depth else CHI2_2D)
    cap = delta2 * 4.0
    X = pts3d.T  # (3, B)
    uo, vo = uv[:, 0], uv[:, 1]
    w_obs = 1.0 / sigma2.clamp(min=1e-9)
    validf = valid.to(torch.float32)
    d = depth if depth is not None else torch.zeros_like(sigma2)
    dmask = (d > 0).to(torch.float32) if has_depth else None
    ur_obs = uo - bf * (1.0 / d.clamp(min=1e-6))

    def project(pose):
        q = pose[:3, :3] @ X + pose[:3, 3:4]
        iz = 1.0 / q[2].clamp(min=1e-6)
        return q, fx * q[0] * iz + cx, fy * q[1] * iz + cy, iz

    def chi2_of(pose):
        q, u, v, _ = project(pose)
        ru, rv = u - uo, v - vo
        c2 = (ru * ru + rv * rv) * w_obs
        if has_depth:
            rs = (u - bf / q[2].clamp(min=1e-6)) - ur_obs
            c2 = c2 + dmask * rs * rs * w_obs
        return c2, q[2]

    pose = pose_init.to(torch.float32)
    mask = validf
    eye6 = torch.eye(6, dtype=torch.float32, device=pts3d.device)
    for _ in range(rounds):
        lam = torch.tensor(1e-3, dtype=torch.float32, device=pts3d.device)
        for _ in range(iters):
            q, u, v, iz = project(pose)
            qx, qy, qz = q[0], q[1], q[2]
            ru, rv = u - uo, v - vo
            c2 = (ru * ru + rv * rv) * w_obs
            w = w_obs * huber_weight(c2, delta2) * mask
            a, b = fx * iz, fy * iz
            cu, dv = -fx * qx * iz * iz, -fy * qy * iz * iz
            zero = torch.zeros_like(a)
            Ju = torch.stack([a, zero, cu, cu * qy, a * qz - cu * qx, -a * qy])
            Jv = torch.stack([zero, b, dv, dv * qy - b * qz, -dv * qx, b * qx])
            H = (Ju * w) @ Ju.T + (Jv * w) @ Jv.T
            g = (Ju * w) @ ru + (Jv * w) @ rv
            if has_depth:
                Jz = torch.stack([zero, zero, torch.ones_like(a), qy, -qx, zero])
                Js = (Ju + (bf * iz * iz) * Jz) * dmask
                rs = (u - bf * iz) - ur_obs
                H = H + (Js * w) @ Js.T
                g = g + (Js * w) @ rs
            new_pose = _se3_exp_neg(_cg6(H + lam * eye6, g)) @ pose
            cost_new = (mask * chi2_of(new_pose)[0].clamp(max=cap)).sum()
            cost_old = (mask * chi2_of(pose)[0].clamp(max=cap)).sum()
            improved = cost_new < cost_old
            pose = torch.where(improved, new_pose, pose)
            lam = torch.where(improved, lam * 0.5, lam * 4.0).clamp(1e-8, 1e4)
        c2, qz = chi2_of(pose)
        mask = validf * (c2 < delta2).to(torch.float32) * (qz > 0).to(torch.float32)
    return pose, mask > 0.5


def motion_only_lm_fused(
    pose_init, pts3d, uv, sigma2, valid, fx, fy, cx, cy,
    depth=None, bf=None, iters=10, rounds=4, has_depth=False,
):
    """B2 on the tensors' device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. pose_init (4, 4), pts3d (B, 3), uv (B, 2),
    sigma2 (B,) float32; valid (B,) bool; depth (B,) float32 or None.
    Returns (pose (4, 4), inliers (B,) bool)."""
    args = (pose_init, pts3d, uv, sigma2, valid, fx, fy, cx, cy)
    kw = dict(depth=depth, bf=bf, iters=iters, rounds=rounds, has_depth=has_depth)
    if pts3d.device.type == "cpu":
        return motion_only_lm_plain(*args, **kw)
    dev = pts3d.device
    if dev.type != "cuda":
        raise ValueError(f"motion_only_lm_fused runs on CPU or CUDA tensors, not {dev}")
    if has_depth and depth is None:
        raise ValueError("has_depth needs a depth tensor")
    B = pts3d.shape[0]
    tensors = dict(
        pose_init=(pose_init, torch.float32, (4, 4)), pts3d=(pts3d, torch.float32, (B, 3)),
        uv=(uv, torch.float32, (B, 2)), sigma2=(sigma2, torch.float32, (B,)),
        valid=(valid, torch.bool, (B,)),
    )
    if has_depth:
        tensors["depth"] = (depth, torch.float32, (B,))
    cuda.check_cuda_args(dev, **tensors)
    lib = _library()
    max_rows = lib.motion_only_lm_max_rows()
    if B > max_rows:
        raise ValueError(f"motion_only_lm holds at most {max_rows} rows on the SMs, got B={B}")
    pose = torch.empty(4, 4, dtype=torch.float32, device=dev)
    mask = torch.empty(B, dtype=torch.uint8, device=dev)
    err = lib.motion_only_lm_launch(
        pose_init.data_ptr(), pts3d.data_ptr(), uv.data_ptr(), sigma2.data_ptr(),
        valid.data_ptr(), depth.data_ptr() if has_depth else None, B,
        _f32(fx), _f32(fy), _f32(cx), _f32(cy), _f32(bf if bf is not None else 0.0),
        _f32(CHI2_3D if has_depth else CHI2_2D), iters, rounds, int(has_depth),
        pose.data_ptr(), mask.data_ptr(), cuda.stream_handle(dev),
    )
    cuda.check_launch(err, "motion_only_lm")
    timers.count("B2")
    return pose, mask.view(torch.bool)


def motion_only_lm_plain_batched(
    pose_init, pts3d, uv, sigma2, valid, fx, fy, cx, cy,
    depth=None, bf=None, iters=10, rounds=4, has_depth=False,
):
    """motion_only_lm_plain over the leading axis of (C, ...) inputs.
    -> (pose (C, 4, 4), inliers (C, B) bool)."""
    outs = [
        motion_only_lm_plain(
            pose_init[c], pts3d[c], uv[c], sigma2[c], valid[c], fx, fy, cx, cy,
            depth=None if depth is None else depth[c], bf=bf, iters=iters, rounds=rounds,
            has_depth=has_depth,
        )
        for c in range(pts3d.shape[0])
    ]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def motion_only_lm_fused_batched(
    pose_init, pts3d, uv, sigma2, valid, fx, fy, cx, cy,
    depth=None, bf=None, iters=10, rounds=4, has_depth=False,
):
    """B2 over C independent problems of B rows in ONE launch (a cluster a
    problem) for CUDA tensors; the plain version, problem by problem, for
    CPU tensors. pose_init (C, 4, 4), pts3d (C, B, 3), uv (C, B, 2),
    sigma2 (C, B) float32; valid (C, B) bool; depth (C, B) float32 or None.
    Returns (pose (C, 4, 4), inliers (C, B) bool)."""
    args = (pose_init, pts3d, uv, sigma2, valid, fx, fy, cx, cy)
    kw = dict(depth=depth, bf=bf, iters=iters, rounds=rounds, has_depth=has_depth)
    if pts3d.device.type == "cpu":
        return motion_only_lm_plain_batched(*args, **kw)
    dev = pts3d.device
    if dev.type != "cuda":
        raise ValueError(f"motion_only_lm_fused_batched runs on CPU or CUDA tensors, not {dev}")
    if has_depth and depth is None:
        raise ValueError("has_depth needs a depth tensor")
    if pts3d.dim() != 3:
        raise ValueError(f"pts3d has shape {tuple(pts3d.shape)}, expected (C, B, 3)")
    C, B = pts3d.shape[:2]
    tensors = dict(
        pose_init=(pose_init, torch.float32, (C, 4, 4)), pts3d=(pts3d, torch.float32, (C, B, 3)),
        uv=(uv, torch.float32, (C, B, 2)), sigma2=(sigma2, torch.float32, (C, B)),
        valid=(valid, torch.bool, (C, B)),
    )
    if has_depth:
        tensors["depth"] = (depth, torch.float32, (C, B))
    cuda.check_cuda_args(dev, **tensors)
    lib = _library()
    max_rows, max_problems = lib.motion_only_lm_max_rows(), lib.motion_only_lm_max_problems()
    if B > max_rows or not 1 <= C <= max_problems:
        raise ValueError(
            f"motion_only_lm takes 1..{max_problems} problems of at most {max_rows} rows, got C={C}, B={B}"
        )
    pose = torch.empty(C, 4, 4, dtype=torch.float32, device=dev)
    mask = torch.empty(C, B, dtype=torch.uint8, device=dev)
    err = lib.motion_only_lm_launch_batched(
        pose_init.data_ptr(), pts3d.data_ptr(), uv.data_ptr(), sigma2.data_ptr(),
        valid.data_ptr(), depth.data_ptr() if has_depth else None, C, B,
        _f32(fx), _f32(fy), _f32(cx), _f32(cy), _f32(bf if bf is not None else 0.0),
        _f32(CHI2_3D if has_depth else CHI2_2D), iters, rounds, int(has_depth),
        pose.data_ptr(), mask.data_ptr(), cuda.stream_handle(dev),
    )
    cuda.check_launch(err, "motion_only_lm (batched)")
    timers.count("B2")
    timers.count("B2_batched")
    return pose, mask.view(torch.bool)


def _library() -> ctypes.CDLL:
    lib = cuda.load_library("lm_kernel")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.motion_only_lm_launch.argtypes = [p, p, p, p, p, p, i, f, f, f, f, f, f, i, i, i, p, p, p]
    lib.motion_only_lm_launch.restype = ctypes.c_int
    lib.motion_only_lm_launch_batched.argtypes = [p, p, p, p, p, p, i, i, f, f, f, f, f, f, i, i, i, p, p, p]
    lib.motion_only_lm_launch_batched.restype = ctypes.c_int
    for fn in (lib.motion_only_lm_max_rows, lib.motion_only_lm_max_problems):
        fn.argtypes = []
        fn.restype = ctypes.c_int
    return lib
