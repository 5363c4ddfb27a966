"""Sim3 pose-graph relaxation for loop closure.

Port of `ucoslam_tpu/optim/posegraph.py`: one Sim3 vertex per keyframe (the
scale frozen for stereo/RGB-D by `fix_scale`), fixed vertices held, relative
Sim3 edges weighted by covisibility, Levenberg-Marquardt with cost-based
accept/reject, poses written back as SE3 = [R t/s]. Plain PyTorch, as it is
XLA code in the reference: the per-edge 7x7 Jacobian blocks come from
forward-mode differentiation (`torch.autograd.forward_ad`) through the
Sim3 exp/log chain, all edges at once. The reference scatter-adds the blocks into the
(K, K, 7, 7) Hessian; here each edge's Jacobian is placed in its two
vertices' columns and the system is one matrix product, so the sums run in a
fixed order on the card too (no atomics).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.autograd.forward_ad as fwAD

from ucoslam_tpu_torch.geometry.sim3 import sim3_exp, sim3_inverse, sim3_log, sim3_parts


@dataclass
class PoseGraphProblem:
    poses: torch.Tensor  # (K, 4, 4) Sim3 (or SE3 with s = 1) world -> keyframe
    fixed: torch.Tensor  # (K,) bool
    edge_i: torch.Tensor  # (E,) int64
    edge_j: torch.Tensor  # (E,) int64
    edge_meas: torch.Tensor  # (E, 4, 4) measured S_i S_j^-1
    edge_weight: torch.Tensor  # (E,)
    edge_valid: torch.Tensor  # (E,) bool


def _edge_residual(di, dj, Si, Sj, meas):
    """r = log(meas^-1 exp(di) Si (exp(dj) Sj)^-1), a 7-vector."""
    rel = (sim3_exp(di) @ Si) @ sim3_inverse(sim3_exp(dj) @ Sj)
    return sim3_log(sim3_inverse(meas) @ rel)


def _edge_jacobians(Si, Sj, meas):
    """Residuals (E, 7) and their Jacobians wrt the left perturbations of
    the two vertices (E, 7, 7) each: one forward-mode pass along the 14
    tangent directions, stacked on a leading axis, for all edges at once
    (they are independent)."""
    E = Si.shape[0]
    zero = torch.zeros(14, E, 7, dtype=Si.dtype, device=Si.device)
    eye = torch.eye(14, dtype=Si.dtype, device=Si.device)[:, None, :].expand(14, E, 14)
    with fwAD.dual_level():
        di = fwAD.make_dual(zero, eye[..., :7].contiguous())
        dj = fwAD.make_dual(zero.clone(), eye[..., 7:].contiguous())
        r, dr = fwAD.unpack_dual(_edge_residual(di, dj, Si, Sj, meas))
    J = dr.permute(1, 2, 0)  # (E, 7 outputs, 14 directions)
    return r[0], J[..., :7], J[..., 7:]


def _identity(x):
    return x


def pose_graph_solve(problem: PoseGraphProblem, iters: int = 20, fix_scale: bool = False,
                     psum=_identity) -> torch.Tensor:
    """Levenberg-Marquardt on the Sim3 pose graph -> poses (K, 4, 4). Every
    accept/reject decision stays on the device. `psum` sums over an
    edge-sharded mesh (`parallel/sharded_posegraph.py`, where `problem`
    holds this rank's edges): two collectives an iteration, the system with
    its cost, then the candidate's cost."""
    poses = problem.poses.to(torch.float32)
    dev = poses.device
    K, E = poses.shape[0], problem.edge_i.shape[0]
    free = ~problem.fixed
    w = problem.edge_weight.to(torch.float32) * problem.edge_valid.to(torch.float32)
    mask = free[:, None].expand(K, 7).clone()
    if fix_scale:
        mask[:, 6] = False
    mflat = mask.reshape(-1)
    # each edge's two vertices as one-hot rows: J_full = Ji (x) e_i + Jj (x) e_j
    sel_i = torch.nn.functional.one_hot(problem.edge_i.long(), K).to(torch.float32)  # (E, K)
    sel_j = torch.nn.functional.one_hot(problem.edge_j.long(), K).to(torch.float32)
    scale_mask = torch.ones(7, device=dev)
    if fix_scale:
        scale_mask[6] = 0.0
    zero = torch.zeros(E, 7, dtype=torch.float32, device=dev)

    def residuals(p):
        return _edge_residual(zero, zero, p[problem.edge_i], p[problem.edge_j], problem.edge_meas)

    lam = torch.tensor(1e-4, dtype=torch.float32, device=dev)
    for _ in range(iters):
        r, Ji, Jj = _edge_jacobians(poses[problem.edge_i], poses[problem.edge_j], problem.edge_meas)
        Ji, Jj = Ji * scale_mask, Jj * scale_mask
        J = (Ji[:, :, None, :] * sel_i[:, None, :, None] + Jj[:, :, None, :] * sel_j[:, None, :, None])
        J = J.reshape(E * 7, K * 7)
        wr = w.repeat_interleave(7)
        H = (J.T * wr) @ J
        b = (J.T * wr) @ r.reshape(-1)
        H, b, cur_cost = psum((H, b, (w * (r * r).sum(-1)).sum()))
        keep = mflat[:, None] & mflat[None, :]
        H = torch.where(keep, H, 0.0)
        damp = torch.where(mflat, 1e-6 + lam * torch.diagonal(H).clamp(min=1e-8), 1.0)
        b = torch.where(mflat, b, 0.0)
        delta = torch.linalg.solve(H + torch.diag(damp), b).reshape(K, 7)
        delta = torch.where(mask, delta, 0.0)
        cand = torch.where(free[:, None, None], sim3_exp(-delta) @ poses, poses)
        r_new = residuals(cand)
        new_cost = psum((w * (r_new * r_new).sum(-1)).sum())
        accept = new_cost < cur_cost
        poses = torch.where(accept, cand, poses)
        lam = torch.where(accept, lam * 0.5, lam * 4.0).clamp(1e-8, 1e6)
    return poses


def sim3_to_se3(poses: torch.Tensor) -> torch.Tensor:
    """Sim3 -> SE3: [sR t] -> [R t/s]."""
    s, R, t = sim3_parts(poses)
    out = torch.zeros_like(poses)
    out[..., :3, :3] = R
    out[..., :3, 3] = t / s[..., None]
    out[..., 3, 3] = 1.0
    return out
