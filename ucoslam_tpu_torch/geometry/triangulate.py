"""Batched two-view triangulation with chi-square acceptance gates.

Port of `ucoslam_tpu/geometry/triangulate.py`. DLT on the 4x4 system of two
projection equations; the null vector is the eigenvector of the smallest
eigenvalue of A^T A (`torch.linalg.eigh`, ascending as in the reference),
solved in float64 (`null_vector`). Its sign and scale cancel in the division
by w, so the point does not depend on the sign the solver returns.
"""

from __future__ import annotations

import torch

from ucoslam_tpu_torch.config import CHI2_2D
from ucoslam_tpu_torch.geometry.camera import CameraParams


#: systems a call of the batched eigensolver takes at most: on the card its
#: workspace grows with the batch (6.3 GiB for a keyframe's 6 x 2048
#: epipolar candidates, 12.6 GiB for the two-view init's 4 x 2048), and each
#: batch size leaves a block of another size in the caching allocator, so
#: four SLAM processes ran one card out of memory
EIGH_CHUNK = 2048


def null_vector(A: torch.Tensor) -> torch.Tensor:
    """(..., R, C) -> (..., C): the unit eigenvector of the smallest
    eigenvalue of A^T A, in A's dtype. The eigenproblem is solved in
    float64: in float32 its squared condition number leaves the vector of a
    poorly conditioned system (a short baseline, a near-degenerate sample)
    with errors of several percent, which no two eigensolvers share. Each
    system is solved alone, so the batch is cut into EIGH_CHUNK pieces."""
    Ad = A.double()
    M = (Ad.transpose(-1, -2) @ Ad).reshape(-1, A.shape[-1], A.shape[-1])
    vecs = torch.cat([torch.linalg.eigh(m)[1][..., :, 0] for m in M.split(EIGH_CHUNK)]) if len(M) else M[..., 0]
    return vecs.reshape(A.shape[:-2] + A.shape[-1:]).to(A.dtype)


def _projection_rows(T_g2c: torch.Tensor, cam: CameraParams) -> torch.Tensor:
    """3x4 projection matrix P = K [R|t] for pose global->camera."""
    return cam.K(T_g2c.device) @ T_g2c[..., :3, :4]


def triangulate_dlt(uv1: torch.Tensor, uv2: torch.Tensor, P1: torch.Tensor, P2: torch.Tensor) -> torch.Tensor:
    """uv1, uv2: (..., 2) undistorted pixels; P1, P2: (..., 3, 4)
    (broadcastable). Returns world points (..., 3)."""
    rows = [
        uv1[..., 0:1, None] * P1[..., 2:3, :] - P1[..., 0:1, :],
        uv1[..., 1:2, None] * P1[..., 2:3, :] - P1[..., 1:2, :],
        uv2[..., 0:1, None] * P2[..., 2:3, :] - P2[..., 0:1, :],
        uv2[..., 1:2, None] * P2[..., 2:3, :] - P2[..., 1:2, :],
    ]
    A = torch.cat(torch.broadcast_tensors(*rows), dim=-2)  # (..., 4, 4)
    X_h = null_vector(A)
    w = X_h[..., 3]
    w = torch.where(w.abs() < 1e-12, 1e-12, w)
    return X_h[..., :3] / w[..., None]


def triangulate_checked(
    uv1: torch.Tensor,
    uv2: torch.Tensor,
    T1_g2c: torch.Tensor,
    T2_g2c: torch.Tensor,
    cam1: CameraParams,
    cam2: CameraParams,
    sigma2_1: torch.Tensor,
    sigma2_2: torch.Tensor,
    min_cos_parallax: float = 0.9998,
):
    """Triangulate + the reference's acceptance gates: positive depth in both
    views, reprojection chi2 below CHI2_2D * sigma^2 in both, and enough
    parallax. uv (..., N, 2) with poses (..., 4, 4): a pose's batch dims
    are those of its points without N. Returns (X (..., N, 3), ok (..., N))."""
    P1 = _projection_rows(T1_g2c, cam1)[..., None, :, :]
    P2 = _projection_rows(T2_g2c, cam2)[..., None, :, :]
    X = triangulate_dlt(uv1, uv2, P1, P2)

    def apply(T):
        return X @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]

    Xc1, Xc2 = apply(T1_g2c), apply(T2_g2c)
    z_ok = (Xc1[..., 2] > 0) & (Xc2[..., 2] > 0)

    r1 = cam1.project(Xc1) - uv1
    r2 = cam2.project(Xc2) - uv2
    chi1 = (r1 * r1).sum(-1) / sigma2_1.clamp(min=1e-12)
    chi2 = (r2 * r2).sum(-1) / sigma2_2.clamp(min=1e-12)
    reproj_ok = (chi1 < CHI2_2D) & (chi2 < CHI2_2D)

    c1 = -T1_g2c[..., :3, :3].transpose(-1, -2) @ T1_g2c[..., :3, 3:4]
    c2 = -T2_g2c[..., :3, :3].transpose(-1, -2) @ T2_g2c[..., :3, 3:4]
    ray1 = X - c1[..., None, :, 0]
    ray2 = X - c2[..., None, :, 0]
    cosp = (ray1 * ray2).sum(-1) / (
        torch.linalg.norm(ray1, dim=-1) * torch.linalg.norm(ray2, dim=-1)
    ).clamp(min=1e-12)
    return X, z_ok & reproj_ok & (cosp < min_cos_parallax)
