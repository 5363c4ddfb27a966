"""Single-frame pose estimation: robust motion-only LM and PnP RANSAC.

Port of `ucoslam_tpu/optim/pnp.py`. The reference picks its LM backend with
a switch (`_use_pallas_lm`); here there is one dispatch: kernel B2 for CUDA
tensors, its plain PyTorch version for CPU tensors.

`pnp_ransac` (relocalization and loop verification) takes its hypotheses'
rows as an explicit `sample_idx`: `jax.random.categorical` cannot be
reproduced in torch, so the caller draws them on the host with `draw_rows`
from a numpy Generator (uniformly among the valid rows, with replacement, as
the reference's categorical over 0 / -1e9 logits does), and the card and the
CPU draw alike. It takes leading batch dimensions (several candidates'
problems at once); their refines are one batched launch of B2.

One departure from the reference, a fault there: `eigh` returns the DLT null
vector with an arbitrary sign, and the reference's `_dlt_pose` turns the
negative sign into a wrong rotation (its depth flip negates R into a
reflection and does not undo it), so about half of its hypotheses are lost.
Here the null vector is first signed so that det(M) >= 0, which makes every
hypothesis independent of the sign `eigh` returns.

A second one: the DLT computes in float64 (the port's second deliberate
float64 site, beside IPPE). The null vector of A^T A squares A's condition,
and in float32 it is lost once the world points lie a few of their spreads
from the world origin: with exact data, 71 of 256 hypotheses right at an
offset of 5 units and none at (20, 10, 30), where float64 gets 250
(tests/test_torch_pnp.py). Relocalization far from the map's origin then
verifies no candidate, and the card's batched float32 eigensolver fares
worse than the CPU's (ROADMAP.md Queue 3, the 150-frame `loop` run).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ucoslam_tpu_torch.config import CHI2_2D
from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.ops.cuda.lm_kernel import motion_only_lm_fused, motion_only_lm_fused_batched
from ucoslam_tpu_torch.utils.timers import timers


@dataclass
class PnPResult:
    pose_f2g: torch.Tensor  # (..., 4, 4)
    inliers: torch.Tensor  # (..., B) bool per input observation
    n_inliers: torch.Tensor  # (...)


def motion_only_lm(
    pose_init: torch.Tensor,  # (4, 4)
    pts3d: torch.Tensor,  # (B, 3) world points
    uv: torch.Tensor,  # (B, 2) undistorted observations
    sigma2: torch.Tensor,  # (B,) per-observation variance
    valid: torch.Tensor,  # (B,) bool
    cam: CameraParams,
    depth: torch.Tensor | None = None,  # (B,) stereo/RGB-D depth (0 = mono row)
    bf: float | None = None,  # baseline * fx for the stereo residual
    iters: int = 10,
    rounds: int = 4,
) -> PnPResult:
    """Fixed-iteration robust motion-only bundle adjustment; rows with depth
    add the disparity residual u_r = u - bf/z, gated at chi2(3D)."""
    pose, inliers = motion_only_lm_fused(
        pose_init, pts3d, uv, sigma2, valid, cam.fx, cam.fy, cam.cx, cam.cy,
        depth=depth, bf=bf, iters=iters, rounds=rounds, has_depth=depth is not None,
    )
    return PnPResult(pose_f2g=pose, inliers=inliers, n_inliers=inliers.sum())


def draw_rows(rng: np.random.Generator, valid: np.ndarray, n_hypotheses: int, sample_size: int = 6) -> np.ndarray:
    """Rows of each RANSAC hypothesis: valid (..., B) bool -> (..., H, S)
    int64, drawn uniformly with replacement among each problem's valid rows
    (row 0 for a problem with none, whose hypotheses then score nothing)."""
    valid = np.asarray(valid, bool)
    flat = valid.reshape(-1, valid.shape[-1])
    out = np.zeros((flat.shape[0], n_hypotheses, sample_size), np.int64)
    for k, v in enumerate(flat):
        rows = np.nonzero(v)[0]
        if len(rows):
            out[k] = rng.choice(rows, size=(n_hypotheses, sample_size), replace=True)
    return out.reshape(valid.shape[:-1] + (n_hypotheses, sample_size))


def _dlt_pose(X: torch.Tensor, uv_norm: torch.Tensor) -> torch.Tensor:
    """6+ point DLT for [R|t] from world points X (..., S, 3) and
    normalized image coordinates (..., S, 2) -> poses (..., 4, 4), in X's
    dtype, computed in float64 (module docstring)."""
    dtype = X.dtype
    X, uv_norm = X.to(torch.float64), uv_norm.to(torch.float64)
    s = X.shape[-2]
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], -1)  # (..., S, 4)
    zeros = torch.zeros_like(Xh)
    row_u = torch.cat([Xh, zeros, -uv_norm[..., 0:1] * Xh], -1)  # (..., S, 12)
    row_v = torch.cat([zeros, Xh, -uv_norm[..., 1:2] * Xh], -1)
    A = torch.cat([row_u, row_v], -2)  # (..., 2S, 12)
    _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    p = vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 4))
    # sign the null vector so that det(M) >= 0: the result no longer depends
    # on the sign eigh returns (module docstring)
    sign = torch.where(torch.linalg.det(p[..., :3]) < 0, -1.0, 1.0)
    p = p * sign[..., None, None]
    M = p[..., :3]
    U, S, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vt)
    D = torch.diag_embed(torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1))
    R = U @ D @ Vt
    scale = S.sum(-1) / 3.0 * det  # signed mean singular value
    # a rank-deficient sample (rows drawn twice) may leave M ~ 0
    scale = torch.where(scale.abs() < 1e-12, torch.full_like(scale, 1e-12), scale)
    t = p[..., 3] / scale[..., None]
    # most depths negative: flip (the DLT's sign ambiguity)
    q = X @ R.transpose(-1, -2) + t[..., None, :]
    flip = ((q[..., 2] < 0).sum(-1) > (s // 2))[..., None, None]
    R = torch.where(flip, -R, R)
    t = torch.where(flip[..., 0], -t, t)
    top = torch.cat([R, t[..., None]], -1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=X.dtype, device=X.device).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], -2).to(dtype)


def pnp_ransac(
    pts3d: torch.Tensor,  # (..., B, 3)
    uv: torch.Tensor,  # (..., B, 2) undistorted pixels
    sigma2: torch.Tensor,  # (..., B)
    valid: torch.Tensor,  # (..., B) bool
    cam: CameraParams,
    sample_idx: torch.Tensor,  # (..., H, S) int64 rows of each hypothesis (draw_rows)
    refine_iters: int = 10,
    min_inliers: int = 15,
) -> PnPResult:
    """RANSAC pose: a DLT per hypothesis, scored by the reprojection inliers
    (chi2 < CHI2_2D, positive depth); the best (most inliers, lowest index
    on ties) refined by B2 (iters `refine_iters`, 2 rounds) on its inliers.
    A problem with fewer than `min_inliers` refined inliers reports none.
    Leading dimensions are independent problems, refined in one launch."""
    lead, B = pts3d.shape[:-2], pts3d.shape[-2]
    uv_norm = torch.stack([(uv[..., 0] - cam.cx) / cam.fx, (uv[..., 1] - cam.cy) / cam.fy], -1)
    idx = sample_idx.long()
    H = idx.shape[-2]

    def take(x):  # (..., B, d) -> (..., H, S, d)
        flat = idx.reshape(lead + (-1,))
        g = torch.gather(x, -2, flat[..., None].expand(flat.shape + (x.shape[-1],)))
        return g.reshape(idx.shape + (x.shape[-1],))

    poses = _dlt_pose(take(pts3d), take(uv_norm))  # (..., H, 4, 4)
    finite = torch.isfinite(poses).flatten(-2).all(-1)
    poses = torch.where(finite[..., None, None], poses, torch.eye(4, dtype=poses.dtype, device=poses.device))
    q = pts3d[..., None, :, :] @ poses[..., :3, :3].transpose(-1, -2) + poses[..., None, :3, 3]  # (..., H, B, 3)
    r = cam.project(q) - uv[..., None, :, :]
    c2 = (r * r).sum(-1) / sigma2[..., None, :].clamp(min=1e-9)
    ok = valid[..., None, :] & (c2 < CHI2_2D) & (q[..., 2] > 0)
    n_in = torch.where(finite, ok.sum(-1), -1)
    hyp = torch.arange(H, device=pts3d.device)
    best = torch.where(n_in == n_in.amax(-1, keepdim=True), hyp, H).amin(-1)  # lowest index on ties
    best_pose = torch.gather(poses, -3, best[..., None, None, None].expand(lead + (1, 4, 4)))[..., 0, :, :]
    best_inl = torch.gather(ok, -2, best[..., None, None].expand(lead + (1, B)))[..., 0, :]
    args = (best_pose.contiguous(), pts3d.contiguous(), uv.contiguous(), sigma2.contiguous(),
            best_inl.contiguous(), cam.fx, cam.fy, cam.cx, cam.cy)
    with timers.span("tracking.refine"):
        if lead:
            flat = [a.reshape((-1,) + a.shape[len(lead):]) if torch.is_tensor(a) else a for a in args]
            pose, inliers = motion_only_lm_fused_batched(*flat, iters=refine_iters, rounds=2)
            pose, inliers = pose.reshape(lead + (4, 4)), inliers.reshape(lead + (B,))
        else:
            pose, inliers = motion_only_lm_fused(*args, iters=refine_iters, rounds=2)
    n = inliers.sum(-1)
    good = n >= min_inliers
    return PnPResult(pose_f2g=pose, inliers=inliers & good[..., None], n_inliers=torch.where(good, n, 0))
