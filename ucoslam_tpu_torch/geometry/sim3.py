"""Sim(3) operations for the loop-closure pose graph.

Port of `ucoslam_tpu/geometry/sim3.py`. A Sim3 element is a (..., 4, 4)
matrix T = [[s R, t], [0, 1]] (the rotation block scaled); its tangent is
zeta = [rho (3), phi (3), sigma] (..., 7), with t = W(phi, sigma) rho
(Strasdat, "Local Accuracy and Global Consistency for Efficient Visual
SLAM", App. B). Every function is written with `torch.where` guards and no
data-dependent branch, so `torch.func.jacfwd` differentiates through it.
"""

from __future__ import annotations

import torch

from ucoslam_tpu_torch.geometry.se3 import _EPS, _hat, so3_exp, so3_log


def sim3_from_sRt(s: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    s = torch.as_tensor(s, dtype=R.dtype, device=R.device)
    batch = torch.broadcast_shapes(s.shape, R.shape[:-2], t.shape[:-1])
    top = torch.cat([(s[..., None, None] * R).expand(batch + (3, 3)), t.expand(batch + (3,))[..., None]], -1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device).expand(batch + (1, 4))
    return torch.cat([top, bottom], -2)


def sim3_scale(T: torch.Tensor) -> torch.Tensor:
    """s from the scaled rotation block (det = s^3)."""
    d = torch.linalg.det(T[..., :3, :3])
    return torch.sign(d) * d.abs().pow(1.0 / 3.0)


def sim3_parts(T: torch.Tensor):
    s = sim3_scale(T)
    return s, T[..., :3, :3] / s[..., None, None], T[..., :3, 3]


def sim3_inverse(T: torch.Tensor) -> torch.Tensor:
    s, R, t = sim3_parts(T)
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    return sim3_from_sRt(s_inv, Rt, -s_inv[..., None] * (Rt @ t[..., None])[..., 0])


def sim3_compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def sim3_apply(T: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    sR, t = T[..., :3, :3], T[..., :3, 3]
    if X.dim() >= 2 and X.shape[-2] != 3:
        return X @ sR.transpose(-1, -2) + t[..., None, :]
    return (sR @ X[..., None])[..., 0] + t


def _sim3_W(zeta: torch.Tensor) -> torch.Tensor:
    """The W matrix of sim3_exp (t = W rho), (..., 7) -> (..., 3, 3)."""
    phi, sig = zeta[..., 3:6], zeta[..., 6]
    theta2 = (phi * phi).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    K = _hat(phi)
    KK = K @ K
    es = torch.exp(sig)
    small_sig = sig.abs() < 1e-5
    small_th = theta < 1e-5
    one = torch.ones_like(sig)
    C = torch.where(small_sig, 1.0 + sig / 2.0, (es - 1.0) / torch.where(small_sig, one, sig))
    denom = (sig * sig + theta2).clamp(min=_EPS)
    A_gen = (sig * es * torch.sin(theta) + (1.0 - es * torch.cos(theta)) * theta) / (theta.clamp(min=_EPS) * denom)
    B_gen = (C - ((es * torch.cos(theta) - 1.0) * sig + es * torch.sin(theta) * theta) / denom) / theta2.clamp(min=_EPS)
    A_small = torch.where(small_sig, 0.5 + sig / 3.0, (sig * es - es + 1.0) / torch.where(small_sig, one, sig * sig))
    B_small = torch.where(
        small_sig, 1.0 / 6.0 + sig / 8.0,
        (es * (0.5 * sig * sig - sig + 1.0) - 1.0) / torch.where(small_sig, one, sig * sig * sig),
    )
    A_f = torch.where(small_th, A_small, A_gen)
    B_f = torch.where(small_th, B_small, B_gen)
    eye = torch.eye(3, dtype=zeta.dtype, device=zeta.device).expand(K.shape)
    return C[..., None, None] * eye + A_f[..., None, None] * K + B_f[..., None, None] * KK


def sim3_exp(zeta: torch.Tensor) -> torch.Tensor:
    """zeta = [rho, phi, sigma] (..., 7) -> (..., 4, 4)."""
    t = (_sim3_W(zeta) @ zeta[..., :3, None])[..., 0]
    return sim3_from_sRt(torch.exp(zeta[..., 6]), so3_exp(zeta[..., 3:6]), t)


def sim3_log(T: torch.Tensor) -> torch.Tensor:
    """Inverse of sim3_exp, (..., 4, 4) -> (..., 7): W rho = t solved for rho."""
    s, R, t = sim3_parts(T)
    phi = so3_log(R)
    sigma = torch.log(s)
    W = _sim3_W(torch.cat([torch.zeros_like(phi), phi, sigma[..., None]], -1))
    rho = torch.linalg.solve(W, t[..., None])[..., 0]
    return torch.cat([rho, phi, sigma[..., None]], -1)
