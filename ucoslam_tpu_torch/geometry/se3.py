"""SO(3) / SE(3) exponential, inverse and assembly on batched tensors.

Port of part of `ucoslam_tpu/geometry/se3.py` (`so3_log` for the Sim3
pose graph). Tangent convention
xi = [rho(3), phi(3)]: translation first, rotation second;
exp(xi) = [[exp(phi), V(phi) rho], [0, 1]].
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _hat(phi: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator. phi: (..., 3) -> (..., 3, 3)."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], -1),
            torch.stack([z, zero, -x], -1),
            torch.stack([-y, x, zero], -1),
        ],
        -2,
    )


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) -> (..., 3, 3), with Taylor terms near zero."""
    theta2 = (phi * phi).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    K = _hat(phi)
    KK = K @ K
    small = theta2 < _EPS
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2.clamp(min=_EPS * _EPS))
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * KK


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3), the inverse of so3_exp for theta in [0, pi).
    theta comes from atan2 rather than arccos, whose derivative is infinite
    at theta -> 0 (the pose graph differentiates through here)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = ((trace - 1.0) * 0.5).clamp(-1.0, 1.0)
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]], -1)
    sin_t = 0.5 * torch.sqrt((w * w).sum(-1) + _EPS * _EPS)
    theta = torch.atan2(sin_t, cos_t)
    scale = torch.where(theta < 1e-4, 0.5 + theta * theta / 12.0, theta / (2.0 * sin_t.clamp(min=_EPS)))
    # near theta = pi the vee formula degenerates: the diagonal route
    near_pi = theta > 3.0
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], -1)
    axis = ((diag - cos_t[..., None]) / (1.0 - cos_t[..., None]).clamp(min=_EPS)).clamp(0.0, 1.0).sqrt()
    sgn = torch.sign(w)
    sgn = torch.where(sgn == 0, 1.0, sgn)
    return torch.where(near_pi[..., None], axis * sgn * theta[..., None], w * scale[..., None])


def _left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """V(phi): (..., 3) -> (..., 3, 3)."""
    theta2 = (phi * phi).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    K = _hat(phi)
    KK = K @ K
    small = theta2 < _EPS
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2.clamp(min=_EPS * _EPS))
    c = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0,
        (theta - torch.sin(theta)) / (theta2 * theta).clamp(min=_EPS * _EPS * _EPS),
    )
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(K.shape)
    return eye + b[..., None, None] * K + c[..., None, None] * KK


def se3_from_Rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    T = torch.zeros(batch + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """xi = [rho, phi] (..., 6) -> (..., 4, 4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    t = (_left_jacobian(phi) @ rho[..., None])[..., 0]
    return se3_from_Rt(so3_exp(phi), t)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    return se3_from_Rt(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])
