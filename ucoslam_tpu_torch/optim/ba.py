"""Schur-complement Levenberg-Marquardt bundle adjustment.

Port of `ucoslam_tpu/optim/ba.py`: SE3 keyframe
vertices, XYZ point vertices marginalized by the Schur complement, mono 2D
edges with information 1/sigma^2 (plus a masked stereo disparity row),
free SE3 marker vertices with 8-D corner edges (their weight balanced
against the keypoint edges of each frame), planar relative edges between
markers when `inPlaneMarkers` is on, two stages of fixed LM iterations
(Huber with delta^2 = chi2 first, then the keypoint outliers demoted and the
kernel dropped; marker edges stay quadratic and are never demoted),
adaptive damping, and the bad-association sweep. The reduced system over
V = K cameras + M markers is solved one of three ways, routed as the
reference routes them (`ba_solve`):

- dense: assembled as one matrix product `GY @ GA.T` plus the marker
  blocks, and solved by `torch.linalg.solve` (small windows);
- "cg": matrix-free block-Jacobi PCG (`cg_iters` iterations an LM step);
  the Schur matvec goes through the points and back through the
  camera->observation table, never forming S (marker problems of >= 512
  vertex slots, or on request);
- point-major (`schur_pm.py`): marker-free problems of >= 128 vertex slots
  under solver="auto", the observations regrouped by point.

Every per-camera reduction is a gather through the static
camera->observation table and a sum, and the marker blocks are added
through one-hot products, so the card sums in a fixed order and gives the
same result on every run. `local_bundle_adjustment` solves a covisibility
window, `global_bundle_adjustment` the whole map (the first keyframe fixed);
both go through `_solve_dispatch`, which shards the solve over a mesh of
ranks when there is one (`set_ba_mesh`; parallel/).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ucoslam_tpu_torch.config import CHI2_2D, CHI2_3D
from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.geometry.se3 import _hat, se3_exp
from ucoslam_tpu_torch.mapping.frame import fetch_to_host
from ucoslam_tpu_torch.mapping.map import Map
from ucoslam_tpu_torch.markers.ippe import marker_object_points
from ucoslam_tpu_torch.utils.timers import timers

#: keyframe-slot bucket of a problem (the reference's K quantum): the
#: dense/point-major rule sees the same V as the reference
K_BUCKET = 16
#: marker-vertex, marker-observation and planar-edge buckets (the reference's)
M_BUCKET, MO_BUCKET, PLAN_BUCKET = 4, 16, 4


@dataclass
class BAProblem:
    """BA problem (K, M and the marker edges padded to their buckets; masks
    define the live part). Index tensors are int64. Without markers the
    marker fields are None; without planar edges the plan_* fields are."""

    cam_pose: torch.Tensor  # (K, 4, 4) pose_f2g
    cam_fixed: torch.Tensor  # (K,) bool, held constant
    cam_valid: torch.Tensor  # (K,) bool
    pt_pos: torch.Tensor  # (P, 3)
    pt_valid: torch.Tensor  # (P,) bool
    obs_cam: torch.Tensor  # (O,) index into the cam arrays
    obs_pt: torch.Tensor  # (O,) index into the pt arrays
    obs_uv: torch.Tensor  # (O, 2)
    obs_sigma2: torch.Tensor  # (O,)
    obs_depth: torch.Tensor  # (O,) stereo depth measurement (0 = mono)
    obs_valid: torch.Tensor  # (O,) bool
    pt_obs: torch.Tensor  # (P, MO) obs index per point (-1 pad)
    bf: float  # baseline * fx
    cam_obs: torch.Tensor  # (K, CO) obs index per camera (-1 pad)
    # ---- marker SE3 vertices and 8-D corner edges ----
    mk_pose: torch.Tensor | None = None  # (M, 4, 4) pose_g2m (marker -> global)
    mk_fixed: torch.Tensor | None = None  # (M,) bool
    mk_valid: torch.Tensor | None = None  # (M,) bool
    mk_obj: torch.Tensor | None = None  # (M, 4, 3) corner object points
    mobs_cam: torch.Tensor | None = None  # (Mo,) camera vertex
    mobs_mk: torch.Tensor | None = None  # (Mo,) marker vertex
    mobs_uv: torch.Tensor | None = None  # (Mo, 4, 2) observed undistorted corners
    mobs_w: torch.Tensor | None = None  # (Mo,) information weight
    mobs_valid: torch.Tensor | None = None  # (Mo,) bool
    # ---- planar relative edges (inPlaneMarkers) ----
    plan_ref: torch.Tensor | None = None  # (Rp,) reference marker vertex
    plan_other: torch.Tensor | None = None  # (Rp,) other marker vertex
    plan_w: torch.Tensor | None = None  # (Rp,) information weight
    plan_valid: torch.Tensor | None = None  # (Rp,) bool


@dataclass
class BAResult:
    cam_pose: torch.Tensor
    pt_pos: torch.Tensor
    obs_chi2: torch.Tensor  # (O,) final per-observation chi2
    obs_bad: torch.Tensor  # (O,) bool, bad association (chi2 / negative depth)
    cost_history: torch.Tensor  # (stages * iters,)
    mk_pose: torch.Tensor | None = None  # (M, 4, 4) optimized marker poses


def _residual_jac(problem: BAProblem, cam_pose, pt_pos, cam: CameraParams):
    """Per-observation 3-row residual (u, v, and the stereo u_r = u - bf/z
    masked to zero for mono rows) and Jacobians.
    -> r (O, 3), Jc (O, 3, 6), Jp (O, 3, 3), q (O, 3), row_mask (O, 3)."""
    T = cam_pose[problem.obs_cam]
    X = pt_pos[problem.obs_pt]
    R = T[:, :3, :3]
    t = T[:, :3, 3]
    q = (R @ X[:, :, None])[:, :, 0] + t
    z = q[:, 2].clamp(min=1e-6)
    inv_z = 1.0 / z
    u_hat = cam.fx * q[:, 0] * inv_z + cam.cx
    v_hat = cam.fy * q[:, 1] * inv_z + cam.cy
    stereo = problem.obs_depth > 0
    bf = problem.bf
    ur_obs = problem.obs_uv[:, 0] - bf / problem.obs_depth.clamp(min=1e-6)
    ur_hat = u_hat - bf * inv_z
    r = torch.stack(
        [u_hat - problem.obs_uv[:, 0], v_hat - problem.obs_uv[:, 1], torch.where(stereo, ur_hat - ur_obs, 0.0)],
        -1,
    )
    zero = torch.zeros_like(inv_z)
    du_dq = torch.stack([cam.fx * inv_z, zero, -cam.fx * q[:, 0] * inv_z**2], -1)
    dv_dq = torch.stack([zero, cam.fy * inv_z, -cam.fy * q[:, 1] * inv_z**2], -1)
    dur_dq = du_dq + torch.stack([zero, zero, bf * inv_z**2], -1)
    J_proj = torch.stack([du_dq, dv_dq, dur_dq], -2)  # (O, 3, 3)
    eye = torch.eye(3, dtype=q.dtype, device=q.device).expand(q.shape[0], 3, 3)
    J_pose = torch.cat([eye, -_hat(q)], -1)  # (O, 3, 6)
    one = torch.ones_like(stereo)
    row_mask = torch.stack([one, one, stereo], -1).to(torch.float32)
    return r, J_proj @ J_pose, J_proj @ R, q, row_mask


def _inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = (a * A + b * B + c * C)[..., None, None]
    adj = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), b * f - c * e], -1),
            torch.stack([B, a * i - c * g, -(a * f - c * d)], -1),
            torch.stack([C, -(a * h - b * g), a * e - b * d], -1),
        ],
        -2,
    )
    return adj / torch.where(det.abs() < 1e-12, 1e-12, det)


def _chi2_of(problem: BAProblem, cam_pose, pt_pos, cam):
    r, _, _, q, row_mask = _residual_jac(problem, cam_pose, pt_pos, cam)
    return (r * r * row_mask).sum(-1) / problem.obs_sigma2.clamp(min=1e-9), q


def _delta2(problem: BAProblem) -> torch.Tensor:
    return torch.where(problem.obs_depth > 0, CHI2_3D, CHI2_2D)


def _marker_residual_jac(problem: BAProblem, cam_pose, mk_pose, cam: CameraParams):
    """8-row marker corner residuals (corners X_w = T_g2m obj projected
    through the camera) and their Jacobians wrt the camera and the marker
    (left perturbations). -> r (Mo, 8), Jc (Mo, 8, 6), Jm (Mo, 8, 6)."""
    Tc = cam_pose[problem.mobs_cam]  # (Mo, 4, 4)
    Tm = mk_pose[problem.mobs_mk]
    obj = problem.mk_obj[problem.mobs_mk]  # (Mo, 4, 3)
    Rc, tc = Tc[:, :3, :3], Tc[:, :3, 3]
    Xw = obj @ Tm[:, :3, :3].transpose(-1, -2) + Tm[:, None, :3, 3]  # (Mo, 4, 3)
    q = Xw @ Rc.transpose(-1, -2) + tc[:, None]  # (Mo, 4, 3)
    inv_z = 1.0 / q[..., 2].clamp(min=1e-6)
    uv_hat = torch.stack([cam.fx * q[..., 0] * inv_z + cam.cx, cam.fy * q[..., 1] * inv_z + cam.cy], -1)
    r = uv_hat - problem.mobs_uv
    zero = torch.zeros_like(inv_z)
    J_proj = torch.stack(
        [
            torch.stack([cam.fx * inv_z, zero, -cam.fx * q[..., 0] * inv_z**2], -1),
            torch.stack([zero, cam.fy * inv_z, -cam.fy * q[..., 1] * inv_z**2], -1),
        ],
        -2,
    )  # (Mo, 4, 2, 3)
    eye = torch.eye(3, dtype=q.dtype, device=q.device).expand(q.shape[:2] + (3, 3))
    Jc = J_proj @ torch.cat([eye, -_hat(q)], -1)  # camera: dq = [I, -hat(q)] xi_c
    Jm = J_proj @ (Rc[:, None] @ torch.cat([eye, -_hat(Xw)], -1))  # marker: dXw = [I, -hat(Xw)] xi_m
    Mo = r.shape[0]
    return r.reshape(Mo, 8), Jc.reshape(Mo, 8, 6), Jm.reshape(Mo, 8, 6)


def _se3_generators(device) -> torch.Tensor:
    """(6, 4, 4) se3 generators in [rho, phi] order (se3_exp's)."""
    G = torch.zeros(6, 4, 4, dtype=torch.float32, device=device)
    G[0, 0, 3] = G[1, 1, 3] = G[2, 2, 3] = 1.0
    G[3, 1, 2], G[3, 2, 1] = -1.0, 1.0
    G[4, 0, 2], G[4, 2, 0] = 1.0, -1.0
    G[5, 0, 1], G[5, 1, 0] = -1.0, 1.0
    return G


def _planar_residual_jac(problem: BAProblem, mk_pose):
    """Planar relative edge: E = T_ref^-1 T_other, residual 10 [E02, E12,
    1 - E22, E23] (the other marker's z-axis along the reference's, in its
    plane). -> r (Rp, 4), J_ref (Rp, 4, 6), J_other (Rp, 4, 6)."""
    T1 = mk_pose[problem.plan_ref]
    T2 = mk_pose[problem.plan_other]
    A = torch.linalg.inv(T1)
    E = A @ T2
    r = 10.0 * torch.stack([E[:, 0, 2], E[:, 1, 2], 1.0 - E[:, 2, 2], E[:, 2, 3]], -1)
    # left perturbations: E' ~= A (I + (xi2 - xi1)^) T2
    dE = torch.einsum("rij,kjl,rlm->rkim", A, _se3_generators(mk_pose.device), T2)  # (Rp, 6, 4, 4)
    J2 = 10.0 * torch.stack([dE[:, :, 0, 2], dE[:, :, 1, 2], -dE[:, :, 2, 2], dE[:, :, 2, 3]], -2)
    return r, -J2, J2


def _identity(x):
    return x


def _total_cost(problem: BAProblem, cam_pose, mk_pose, pt_pos, cam, active, robust: bool, psum=_identity):
    """LM acceptance cost: keypoint edges (Huber in stage 0, quadratic
    after), plus the quadratic marker and planar terms. `psum` sums the
    keypoint part over a point-sharded mesh; the marker terms are
    replicated and added after it."""
    c2, _ = _chi2_of(problem, cam_pose, pt_pos, cam)
    if robust:
        delta2 = _delta2(problem)
        rho = torch.where(c2 <= delta2, c2, 2.0 * torch.sqrt(delta2 * c2.clamp(min=1e-12)) - delta2)
    else:
        rho = c2
    cost = psum(torch.where(active, rho, 0.0).sum())
    if problem.mk_pose is not None:
        rm, _, _ = _marker_residual_jac(problem, cam_pose, mk_pose, cam)
        cost = cost + ((rm * rm).sum(-1) * problem.mobs_valid.to(torch.float32) * problem.mobs_w).sum()
        if problem.plan_ref is not None:
            rp, _, _ = _planar_residual_jac(problem, mk_pose)
            cost = cost + ((rp * rp).sum(-1) * problem.plan_valid.to(torch.float32) * problem.plan_w).sum()
    return cost


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    return torch.nn.functional.one_hot(idx, n).to(torch.float32)


def _pad_row(x: torch.Tensor) -> torch.Tensor:
    """x with one zero row appended (the target of the -1 pads)."""
    return torch.cat([x, x.new_zeros((1,) + x.shape[1:])])


def pcg(matvec, b_f: torch.Tensor, Minv: torch.Tensor, cg_iters: int) -> torch.Tensor:
    """cg_iters block-Jacobi-preconditioned CG iterations on S x = b_f from
    x = 0; a converged or degenerate iteration takes a zero step (no host
    test). Shared with `schur_pm.py`."""
    def apply_M(rv):
        return torch.einsum("vij,vj->vi", Minv, rv)

    x = torch.zeros_like(b_f)
    rr = b_f
    p = apply_M(rr)
    rz = (rr * p).sum()
    for _ in range(cg_iters):
        Sp = matvec(p)
        pSp = (p * Sp).sum()
        alpha = rz / torch.where(pSp.abs() < 1e-20, 1e-20, pSp)
        alpha = torch.where(rz < 1e-20, 0.0, alpha)
        x = x + alpha * p
        rr = rr - alpha * Sp
        zv = apply_M(rr)
        rz_new = (rr * zv).sum()
        beta = rz_new / torch.where(rz < 1e-20, 1.0, rz)
        p = zv + beta * p
        rz = rz_new
    return x


def block_jacobi(D: torch.Tensor, free: torch.Tensor) -> torch.Tensor:
    """(V, 6, 6) inverses of the Schur diagonal blocks (identity for fixed
    vertices); `inv_ex` does not test for singularity, so the host waits
    for nothing."""
    eye6 = torch.eye(6, device=D.device)
    Minv = torch.linalg.inv_ex(D + 1e-6 * eye6)[0]
    return torch.where(free[:, None, None], Minv, eye6)


def _lm_step(problem: BAProblem, cam, free, w_info, active, robust, use_cg: bool, cg_iters: int, psum,
             cam_pose, mk_pose, pt_pos, lam, cost_prev):
    K = cam_pose.shape[0]
    M = 0 if problem.mk_pose is None else mk_pose.shape[0]
    V = K + M
    P = pt_pos.shape[0]
    O = problem.obs_cam.shape[0]
    dev = cam_pose.device
    r, Jc, Jp, q, row_mask = _residual_jac(problem, cam_pose, pt_pos, cam)
    c2 = (r * r * row_mask).sum(-1) / problem.obs_sigma2.clamp(min=1e-9)
    if robust:
        w = w_info * torch.clamp(torch.sqrt(_delta2(problem) / c2.clamp(min=1e-12)), max=1.0)
    else:
        w = w_info
    Jc = Jc * row_mask[:, :, None]
    Jp = Jp * row_mask[:, :, None]

    # per-point blocks through the point->observation table (a gather)
    A = torch.einsum("oij,oik,o->ojk", Jc, Jp, w)  # (O, 6, 3)
    tbl = torch.where(problem.pt_obs >= 0, problem.pt_obs, O)  # (P, MO)
    wL = _pad_row(w)[tbl]
    JpL = _pad_row(Jp)[tbl]  # (P, MO, 3, 3)
    rL = _pad_row(r)[tbl]
    A_list = _pad_row(A)[tbl]  # (P, MO, 6, 3)
    cam_list = torch.cat([problem.obs_cam, problem.obs_cam.new_full((1,), V)])[tbl]  # (P, MO)
    Hpp = torch.einsum("pmij,pmik,pm->pjk", JpL, JpL, wL)
    bp = torch.einsum("pmij,pmi,pm->pj", JpL, rL, wL)

    # per-camera blocks through the camera->observation table (a gather);
    # the marker vertices' rows start at zero
    co = torch.where(problem.cam_obs >= 0, problem.cam_obs, O)

    def cam_reduce(contrib):
        red = _pad_row(contrib)[co].sum(1)
        return torch.cat([red, red.new_zeros((M,) + red.shape[1:])]) if M else red

    Hv = cam_reduce(torch.einsum("oij,oik,o->ojk", Jc, Jc, w))  # (V, 6, 6)
    bv = cam_reduce(torch.einsum("oij,oi,o->oj", Jc, r, w))  # (V, 6)

    eye3 = torch.eye(3, device=dev)
    eye6 = torch.eye(6, device=dev)
    Hpp_d = Hpp + lam * eye3 * torch.clamp(Hpp.diagonal(dim1=-2, dim2=-1).sum(-1)[:, None, None] / 3.0, min=1.0)
    Hpp_inv = torch.where(problem.pt_valid[:, None, None], _inv3x3(Hpp_d), 0.0)

    Y = A @ Hpp_inv[problem.obs_pt]  # (O, 6, 3)
    bcorr_o = torch.einsum("oij,oj->oi", Y, bp[problem.obs_pt])  # (O, 6)

    b_corr = -cam_reduce(bcorr_o)
    if use_cg:
        # the exact Schur diagonal blocks, for the block-Jacobi preconditioner
        # (a camera sees a point once, so only m1 == m2 terms land there)
        DK = cam_reduce(torch.einsum("oij,okj->oik", Y, A))  # (V, 6, 6)
        # the keypoint system over the mesh, one collective (one more in
        # each PCG iteration's matvec)
        Hv, bv, b_corr, DK = psum((Hv, bv, b_corr, DK))
    else:
        # Schur complement as one matrix product of the camera-contracted tables
        Y_list = torch.einsum("pmij,pjk->pmik", A_list, Hpp_inv)  # (P, MO, 6, 3)
        U = _one_hot(cam_list, V + 1)[..., :V]
        GY = torch.einsum("pmc,pmij->cipj", U, Y_list).reshape(V * 6, P * 3)
        GA = torch.einsum("pmc,pmij->cipj", U, A_list).reshape(V * 6, P * 3)
        S = -(GY @ GA.T).reshape(V, 6, V, 6).permute(0, 2, 1, 3)
        # the keypoint system over the mesh: the one collective of the step
        # but for the acceptance cost
        Hv, bv, S, b_corr = psum((Hv, bv, S, b_corr))

    binary = []  # the binary marker blocks: (one-hot a, one-hot b, (Mo, 6, 6) blocks)
    if M:
        # marker corner edges: camera and marker blocks, and the binary
        # camera<->marker blocks, summed through one-hot products
        rm, Jcm, Jmm = _marker_residual_jac(problem, cam_pose, mk_pose, cam)
        wm = problem.mobs_valid.to(torch.float32) * problem.mobs_w
        Ec, Em = _one_hot(problem.mobs_cam, V), _one_hot(K + problem.mobs_mk, V)  # (Mo, V)
        Hv = Hv + torch.einsum("ov,oij->vij", Ec, torch.einsum("oij,oik,o->ojk", Jcm, Jcm, wm)) \
            + torch.einsum("ov,oij->vij", Em, torch.einsum("oij,oik,o->ojk", Jmm, Jmm, wm))
        bv = bv + Ec.T @ torch.einsum("oij,oi,o->oj", Jcm, rm, wm) + Em.T @ torch.einsum("oij,oi,o->oj", Jmm, rm, wm)
        cross = torch.einsum("oij,oik,o->ojk", Jcm, Jmm, wm)  # (Mo, 6, 6)
        binary.append((Ec, Em, cross))
        if problem.plan_ref is not None:
            rp, J1, J2 = _planar_residual_jac(problem, mk_pose)
            wp = problem.plan_valid.to(torch.float32) * problem.plan_w
            E1, E2 = _one_hot(K + problem.plan_ref, V), _one_hot(K + problem.plan_other, V)
            Hv = Hv + torch.einsum("ov,oij->vij", E1, torch.einsum("oij,oik,o->ojk", J1, J1, wp)) \
                + torch.einsum("ov,oij->vij", E2, torch.einsum("oij,oik,o->ojk", J2, J2, wp))
            bv = bv + E1.T @ torch.einsum("oij,oi,o->oj", J1, rp, wp) + E2.T @ torch.einsum("oij,oi,o->oj", J2, rp, wp)
            binary.append((E1, E2, torch.einsum("oij,oik,o->ojk", J1, J2, wp)))
        if not use_cg:
            for Ea, Eb, blk in binary:
                S = S + torch.einsum("oa,ob,oij->abij", Ea, Eb, blk) + torch.einsum("oa,ob,oij->abji", Eb, Ea, blk)

    HvD = Hv + lam * eye6 * torch.clamp(Hv.diagonal(dim1=-2, dim2=-1).sum(-1)[:, None, None] / 6.0, min=1.0)
    b_f = torch.where(free[:, None], bv + b_corr, 0.0)
    if use_cg:
        def matvec(x):
            """S @ x without S: through the points (3x3 applies) and back
            through the camera->observation table; the binary marker blocks
            through their one-hot products."""
            u = torch.einsum("pmij,pmi->pj", A_list, _pad_row(x)[cam_list])  # (P, 3)
            v = torch.einsum("pij,pj->pi", Hpp_inv, u)
            ykp = psum(cam_reduce(torch.einsum("oij,oj->oi", A, v[problem.obs_pt])))
            y = torch.einsum("vij,vj->vi", HvD, x) - ykp
            for Ea, Eb, blk in binary:
                y = y + Ea.T @ torch.einsum("oij,oj->oi", blk, Eb @ x) + Eb.T @ torch.einsum("oji,oj->oi", blk, Ea @ x)
            return torch.where(free[:, None], y, x)

        delta_v = pcg(matvec, b_f, block_jacobi(HvD - DK, free), cg_iters)
    else:
        diag = torch.arange(V, device=dev)
        S = S.clone()
        S[diag, diag] += HvD
        # fixed / invalid vertices: identity rows, zero right-hand side
        Sf = torch.where(free[:, None, None, None] & free[None, :, None, None], S, 0.0)
        Sf[diag, diag] += torch.where(free, 0.0, 1.0)[:, None, None] * eye6
        S_full = Sf.permute(0, 2, 1, 3).reshape(6 * V, 6 * V)
        # as jnp.linalg.solve: a singular system gives a non-finite step,
        # which the cost test below rejects, instead of raising
        delta_v = torch.linalg.solve_ex(
            S_full + 1e-8 * torch.eye(6 * V, device=dev), b_f.reshape(-1)
        )[0].reshape(V, 6)
    delta_v = torch.where(free[:, None], delta_v, 0.0)

    # back-substitute the points through the same table
    dcL = _pad_row(delta_v)[cam_list]  # (P, MO, 6)
    t_contrib = torch.einsum("pmij,pmi->pj", A_list, dcL)
    delta_p = torch.einsum("pij,pj->pi", Hpp_inv, bp - t_contrib)
    delta_p = torch.where(problem.pt_valid[:, None], delta_p, 0.0)

    new_cam = torch.where(free[:K, None, None], se3_exp(-delta_v[:K]) @ cam_pose, cam_pose)
    new_mk = torch.where(free[K:, None, None], se3_exp(-delta_v[K:]) @ mk_pose, mk_pose) if M else mk_pose
    new_pt = pt_pos - delta_p
    new_cost = _total_cost(problem, new_cam, new_mk, new_pt, cam, active, robust, psum)
    improved = new_cost < cost_prev
    cam_pose = torch.where(improved, new_cam, cam_pose)
    mk_pose = torch.where(improved, new_mk, mk_pose) if M else mk_pose
    pt_pos = torch.where(improved, new_pt, pt_pos)
    cost = torch.where(improved, new_cost, cost_prev)
    lam = torch.where(improved, lam * 0.5, lam * 8.0).clamp(1e-7, 1e6)
    return cam_pose, mk_pose, pt_pos, lam, cost


def _staged_lm(problem: BAProblem, cam: CameraParams, iters: int, stages: int, use_cg: bool = False,
               cg_iters: int = 32, psum=_identity):
    """`stages` rounds of `iters` LM steps, the keypoint outliers demoted
    between them; the dense solve, or `cg_iters` PCG iterations a step.
    -> (cam_pose, mk_pose, pt_pos, costs, obs_chi2, obs_bad).

    One implementation for `ba_solve` (psum the identity) and
    `parallel.sharded_ba.sharded_ba_solve`, where the problem is this
    rank's shard (every observation of a point on the point's rank, local
    indices) and `psum` the mesh's all_reduce. The collectives, as the
    reference's: per LM step the keypoint system (Hv, bv, S or the Schur
    diagonal, the rhs correction) and the acceptance cost, plus one in each
    PCG iteration on the CG route; the stage's starting cost. Point blocks,
    the back-substitution and the outlier demotion stay on their rank;
    marker and planar edges are replicated and added after the reduction."""
    has_mk = problem.mk_pose is not None
    free = problem.cam_valid & ~problem.cam_fixed
    if has_mk:
        free = torch.cat([free, problem.mk_valid & ~problem.mk_fixed])
    cam_pose, pt_pos = problem.cam_pose, problem.pt_pos
    mk_pose = problem.mk_pose if has_mk else None
    active = problem.obs_valid
    all_costs = []
    for stage in range(stages):
        robust = stage == 0
        w_info = active.to(torch.float32) / problem.obs_sigma2.clamp(min=1e-9)
        cost = _total_cost(problem, cam_pose, mk_pose, pt_pos, cam, active, robust, psum)
        lam = torch.tensor(1e-4, dtype=torch.float32, device=cam_pose.device)
        for _ in range(iters):
            with timers.span("ba.lm_step"):
                cam_pose, mk_pose, pt_pos, lam, cost = _lm_step(
                    problem, cam, free, w_info, active, robust, use_cg, cg_iters, psum, cam_pose, mk_pose, pt_pos,
                    lam, cost)
            all_costs.append(cost)
        if stage < stages - 1:
            c2_s, q_s = _chi2_of(problem, cam_pose, pt_pos, cam)
            active = problem.obs_valid & (c2_s <= _delta2(problem)) & (q_s[:, 2] > 0)
    c2, q = _chi2_of(problem, cam_pose, pt_pos, cam)
    bad = problem.obs_valid & ((c2 > _delta2(problem)) | (q[:, 2] <= 0))
    return cam_pose, mk_pose, pt_pos, torch.stack(all_costs), c2, bad


def ba_solve(problem: BAProblem, cam: CameraParams, iters: int = 20, stages: int = 2, solver: str = "auto",
             cg_iters: int = 32) -> BAResult:
    """LM with point marginalization and free marker vertices. solver:
    "dense", "cg" (matrix-free PCG, `cg_iters` iterations a step) or "auto",
    routed as the reference: a marker-free problem of >= 128 vertex slots to
    the point-major solver (`schur_pm.py`; a graph too skewed for it falls
    through), then "cg" from 512 slots, else "dense". Only "auto" reroutes."""
    from ucoslam_tpu_torch.optim import schur_pm  # it builds on this module

    has_mk = problem.mk_pose is not None
    V = problem.cam_pose.shape[0] + (problem.mk_pose.shape[0] if has_mk else 0)
    if solver == "auto" and V >= 128:
        pm = schur_pm.pm_problem_for(problem)
        if pm is not None:
            return _pm_result(problem, pm, cam, schur_pm.pm_staged_lm(pm, cam, iters=iters, stages=stages,
                                                                       cg_iters=cg_iters))
    if solver == "auto":
        solver = "cg" if V >= 512 else "dense"
    if solver not in ("dense", "cg"):
        raise ValueError(f"unknown solver {solver!r}")
    cam_pose, mk_pose, pt_pos, costs, c2, bad = _staged_lm(problem, cam, iters, stages, solver == "cg", cg_iters)
    return BAResult(cam_pose=cam_pose, pt_pos=pt_pos, obs_chi2=c2, obs_bad=bad, cost_history=costs, mk_pose=mk_pose)


def _pm_result(problem: BAProblem, pm, cam: CameraParams, out) -> BAResult:
    """The point-major solve's outputs in the problem's observation order:
    each grid cell's chi2 and bad flag written back at its source index (the
    indices are unique; the pads all land on one spare slot, cut off); the
    observations the skew cap left out get an exact chi2 pass at the final
    estimate."""
    cam_pose, pt_pos, costs, c2_pm, bad_pm = out
    O = problem.obs_cam.shape[0]
    src = torch.where(pm.o_src >= 0, pm.o_src, O).reshape(-1)
    c2 = c2_pm.new_zeros(O + 1)
    c2[src] = c2_pm.reshape(-1)
    bad = torch.zeros(O + 1, dtype=torch.bool, device=c2.device)
    bad[src] = bad_pm.reshape(-1)
    c2, bad = c2[:O], bad[:O]
    if pm.dropped_obs:
        covered = torch.zeros(O + 1, dtype=torch.bool, device=c2.device)
        covered[src] = True
        covered = covered[:O]
        c2_full, q_full = _chi2_of(problem, cam_pose, pt_pos, cam)
        bad_full = problem.obs_valid & ((c2_full > _delta2(problem)) | (q_full[..., 2] <= 0))
        c2 = torch.where(covered, c2, c2_full)
        bad = torch.where(covered, bad, bad_full)
    return BAResult(cam_pose=cam_pose, pt_pos=pt_pos, obs_chi2=c2, obs_bad=bad, cost_history=costs, mk_pose=None)


# ----------------------------------------------------------------------
# Host-side problem construction from a Map
# ----------------------------------------------------------------------


def _build_cam_obs(obs_cam: np.ndarray, K: int) -> np.ndarray:
    """(K, CO) int32 camera->obs gather table (-1 pad), CO bucketed to 256."""
    pos = np.nonzero((obs_cam >= 0) & (obs_cam < K))[0]
    cams_all = obs_cam[pos]
    counts = np.bincount(cams_all, minlength=K) if len(cams_all) else np.zeros(K, int)
    co = max(256, -(-int(counts.max() if len(counts) else 1) // 256) * 256)
    tbl = np.full((K, co), -1, np.int32)
    order = np.argsort(cams_all, kind="stable")
    cams = cams_all[order]
    if len(cams):
        tbl[cams, _rank_in_runs(cams)] = pos[order]
    return tbl


def _rank_in_runs(sorted_keys: np.ndarray) -> np.ndarray:
    """Position of each element within its run of equal keys."""
    first = np.concatenate([[True], sorted_keys[1:] != sorted_keys[:-1]])
    start = np.maximum.accumulate(np.where(first, np.arange(len(sorted_keys)), 0))
    return np.arange(len(sorted_keys)) - start


def build_ba_problem(
    world_map: Map,
    cam: CameraParams,
    used_kfs: np.ndarray | None = None,
    fixed_kfs: np.ndarray | None = None,
    fix_first: bool = True,
    max_obs_per_point: int = 16,
    min_obs: int = 2,
) -> tuple[BAProblem, np.ndarray, np.ndarray, np.ndarray]:
    """Flatten a Map (or a keyframe window) into a BAProblem.

    used_kfs: keyframe slots to optimize (None = all active); fixed_kfs:
    slots held fixed (the window's boundary). With `detectMarkers`, the
    markers with a map pose that window keyframes observe become vertices
    (held fixed when keyframes outside the window observe them too).
    Returns (problem, kf_slots, pt_slots, mk_slots), the slot arrays
    mapping problem indices to the Map arenas.
    """
    st = world_map.state
    dev = world_map.device
    kf_active = world_map.h("kf_active")
    if used_kfs is None:
        used_kfs = np.nonzero(kf_active)[0]
    used_kfs = np.asarray(sorted(int(s) for s in used_kfs), np.int32)
    fixed_set = set(int(s) for s in (fixed_kfs if fixed_kfs is not None else []))
    if fix_first and len(used_kfs) and not fixed_set:
        fixed_set = {int(used_kfs[0])}
    all_kfs = np.asarray(sorted(set(used_kfs.tolist()) | fixed_set), np.int32)

    # only the window keyframes' rows leave the device, in one transfer
    rows = torch.from_numpy(all_kfs.astype(np.int64)).to(dev)
    kf_ids, kf_depth_all, kf_xy, kf_oct, kf_pose_w = fetch_to_host(
        st.kf_ids[rows], st.kf_depth[rows], st.kf_xy[rows], st.kf_octave[rows], st.kf_pose[rows]
    )

    # observations of points by the window keyframes
    obs_cam, obs_kpt = np.nonzero(kf_ids >= 0)
    obs_cam = obs_cam.astype(np.int32)
    obs_pt_slot = kf_ids[obs_cam, obs_kpt]

    # points: observed >= min_obs times within the window (or stereo)
    depth_per_obs = kf_depth_all[obs_cam, obs_kpt]
    uniq, counts = np.unique(obs_pt_slot, return_counts=True)
    stereo = np.isin(uniq, obs_pt_slot[depth_per_obs > 0])
    pt_slots = uniq[(counts >= min_obs) | stereo].astype(np.int32)
    pt_index = np.full(st.P, -1, np.int32)
    pt_index[pt_slots] = np.arange(len(pt_slots))

    keep = pt_index[obs_pt_slot] >= 0
    obs_cam, obs_kpt = obs_cam[keep], obs_kpt[keep]
    obs_pt = pt_index[obs_pt_slot[keep]]

    # cap the observations per point (keep the earliest keyframes)
    order = np.lexsort((obs_cam, obs_pt))
    obs_cam, obs_pt, obs_kpt = obs_cam[order], obs_pt[order], obs_kpt[order]
    rank = _rank_in_runs(obs_pt) if len(obs_pt) else np.zeros(0, np.int64)
    keep = rank < max_obs_per_point
    obs_cam, obs_pt, obs_kpt, rank = obs_cam[keep], obs_pt[keep], obs_kpt[keep], rank[keep]

    O = len(obs_cam)
    sf = world_map.params.scaleFactor
    obs_uv = kf_xy[obs_cam, obs_kpt]
    obs_sigma2 = sf ** (2.0 * kf_oct[obs_cam, obs_kpt])
    obs_depth = kf_depth_all[obs_cam, obs_kpt]
    pt_obs = np.full((len(pt_slots), max_obs_per_point), -1, np.int32)
    pt_obs[obs_pt, rank] = np.arange(O)

    # K padded to its bucket (padded cameras invalid and fixed)
    Kb = max(K_BUCKET, -(-len(all_kfs) // K_BUCKET) * K_BUCKET)
    cam_pose = np.tile(np.eye(4, dtype=np.float32), (Kb, 1, 1))
    cam_pose[: len(all_kfs)] = kf_pose_w
    cam_fixed = np.ones(Kb, bool)
    cam_fixed[: len(all_kfs)] = [int(s) in fixed_set for s in all_kfs]
    cam_valid = np.zeros(Kb, bool)
    cam_valid[: len(all_kfs)] = True

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    mk_slots, mk_fields = np.zeros(0, np.int32), {}
    if world_map.params.detectMarkers:
        mk_slots, mk_fields = _marker_fields(world_map, all_kfs, kf_oct[obs_cam, obs_kpt], obs_cam, obs_depth)
        mk_fields = {k: t(v, torch.int64 if v.dtype == np.int32 else torch.bool if v.dtype == bool else torch.float32)
                     for k, v in mk_fields.items()}

    problem = BAProblem(
        cam_pose=t(cam_pose, torch.float32),
        cam_fixed=t(cam_fixed, torch.bool),
        cam_valid=t(cam_valid, torch.bool),
        pt_pos=t(world_map.h("pt_pos")[pt_slots], torch.float32),
        pt_valid=torch.ones(len(pt_slots), dtype=torch.bool, device=dev),
        obs_cam=t(obs_cam, torch.int64),
        obs_pt=t(obs_pt, torch.int64),
        obs_uv=t(obs_uv.astype(np.float32), torch.float32),
        obs_sigma2=t(obs_sigma2.astype(np.float32), torch.float32),
        obs_depth=t(obs_depth.astype(np.float32), torch.float32),
        obs_valid=torch.ones(O, dtype=torch.bool, device=dev),
        pt_obs=t(pt_obs, torch.int64),
        bf=cam.bf,
        cam_obs=t(_build_cam_obs(obs_cam, Kb), torch.int64),
        **mk_fields,
    )
    return problem, all_kfs, pt_slots, mk_slots


def _bucket(n: int, quantum: int) -> int:
    return max(quantum, -(-n // quantum) * quantum)


def _marker_fields(world_map: Map, all_kfs: np.ndarray, obs_oct: np.ndarray, obs_cam: np.ndarray,
                   obs_depth: np.ndarray) -> tuple[np.ndarray, dict]:
    """The marker vertices and edges of a BA problem over keyframes all_kfs
    (host arrays, padded to their buckets) -> (mk_slots, fields). Each
    frame's corner edges weigh markersOptWeight (scaled down below
    minMarkersForMaxWeight markers) of its keypoint information mass; the
    planar edges (inPlaneMarkers) 0.33 of the total mass, against the most
    observed marker."""
    params = world_map.params
    kf_active, mk_pose_arr, mk_size, mk_pose_valid, kf_mk_slot, kf_mk_corners = world_map.h(
        "kf_active", "mk_pose", "mk_size", "mk_pose_valid", "kf_mk_slot", "kf_mk_corners")
    # vertices: the markers with a map pose that a window keyframe observes
    seen: dict[int, list[tuple[int, int]]] = {}
    for ci, s in enumerate(all_kfs):
        for j in range(kf_mk_slot.shape[1]):
            slot = int(kf_mk_slot[s, j])
            if slot >= 0 and mk_pose_valid[slot]:
                seen.setdefault(slot, []).append((ci, j))
    mk_slots = np.asarray(sorted(seen), np.int32)
    if len(mk_slots) == 0:
        return mk_slots, {}
    mk_vidx = {int(s): i for i, s in enumerate(mk_slots)}
    # markers that active keyframes outside the window also observe are
    # constrained by data the problem does not hold: fixed
    in_window = set(int(s) for s in all_kfs)
    fixed_mk = set()
    for s in np.nonzero(kf_active)[0]:
        if int(s) not in in_window:
            fixed_mk.update(int(v) for v in kf_mk_slot[s] if int(v) in mk_vidx)
    # each frame's keypoint information mass (mono edges 2 / sf^oct, stereo 3)
    sf = params.scaleFactor
    kpw = np.zeros(len(all_kfs), np.float64)
    np.add.at(kpw, obs_cam, np.where(obs_depth > 0, 3.0, 2.0) * sf ** (-obs_oct.astype(np.float64)))
    n_mk_frame = np.zeros(len(all_kfs), np.int32)
    for obs in seen.values():
        for ci, _ in obs:
            n_mk_frame[ci] += 1
    fmw = np.ones(len(all_kfs), np.float64)
    for ci in range(len(all_kfs)):
        if kpw[ci] > 40 and n_mk_frame[ci] > 0:
            perct = params.markersOptWeight * min(1.0, n_mk_frame[ci] / max(params.minMarkersForMaxWeight, 1))
            fmw[ci] = perct * kpw[ci] / (n_mk_frame[ci] * 8.0)
    mobs = [(ci, mk_vidx[slot], kf_mk_corners[all_kfs[ci], j], fmw[ci]) for slot, obs in seen.items() for ci, j in obs]

    Mb, Mob, n_mo = _bucket(len(mk_slots), M_BUCKET), _bucket(len(mobs), MO_BUCKET), len(mobs)
    f = dict(
        mk_pose=np.tile(np.eye(4, dtype=np.float32), (Mb, 1, 1)),
        mk_fixed=np.ones(Mb, bool),
        mk_valid=np.arange(Mb) < len(mk_slots),
        mk_obj=np.zeros((Mb, 4, 3), np.float32),
        mobs_cam=np.zeros(Mob, np.int32),
        mobs_mk=np.zeros(Mob, np.int32),
        mobs_uv=np.zeros((Mob, 4, 2), np.float32),
        mobs_w=np.zeros(Mob, np.float32),
        mobs_valid=np.arange(Mob) < n_mo,
    )
    f["mk_pose"][: len(mk_slots)] = mk_pose_arr[mk_slots]
    f["mk_fixed"][: len(mk_slots)] = [int(s) in fixed_mk for s in mk_slots]
    for i, s in enumerate(mk_slots):
        f["mk_obj"][i] = marker_object_points(np.float32(mk_size[s])).numpy()
    f["mobs_cam"][:n_mo] = [o[0] for o in mobs]
    f["mobs_mk"][:n_mo] = [o[1] for o in mobs]
    f["mobs_uv"][:n_mo] = np.stack([o[2] for o in mobs])
    f["mobs_w"][:n_mo] = [o[3] for o in mobs]
    if params.inPlaneMarkers and len(mk_slots) >= 2:
        n_obs_per_v = np.zeros(len(mk_slots), np.int32)
        for slot, obs in seen.items():
            n_obs_per_v[mk_vidx[slot]] = len(obs)
        ref_v = int(np.argmax(n_obs_per_v))
        others = [v for v in range(len(mk_slots)) if v != ref_v]
        total_w = float(np.sum(f["mobs_w"][:n_mo]) * 8.0) + float(np.sum(kpw))
        Rb = _bucket(len(others), PLAN_BUCKET)
        f.update(plan_ref=np.zeros(Rb, np.int32), plan_other=np.zeros(Rb, np.int32),
                 plan_w=np.zeros(Rb, np.float32), plan_valid=np.arange(Rb) < len(others))
        f["plan_ref"][: len(others)] = ref_v
        f["plan_other"][: len(others)] = others
        f["plan_w"][: len(others)] = 0.33 * total_w / (4.0 * len(others))
    return mk_slots, f


def apply_ba_result(
    world_map: Map, result: BAResult, kf_slots: np.ndarray, pt_slots: np.ndarray,
    problem: BAProblem, remove_bad: bool = True, mk_slots: np.ndarray | None = None,
) -> int:
    """Write the optimized poses, points and free markers back into the map
    and drop the bad associations. Returns the number of associations
    removed."""
    st = world_map.state
    dev = world_map.device
    kf_idx = torch.from_numpy(np.asarray(kf_slots, np.int64)).to(dev)
    pt_idx = torch.from_numpy(np.asarray(pt_slots, np.int64)).to(dev)
    kf_pose = st.kf_pose.clone()
    kf_pose[kf_idx] = result.cam_pose[: len(kf_slots)]
    pt_pos = st.pt_pos.clone()
    pt_pos[pt_idx] = result.pt_pos[: len(pt_slots)]
    st = st.replace(kf_pose=kf_pose, pt_pos=pt_pos)
    if mk_slots is not None and len(mk_slots) and result.mk_pose is not None:
        # the free marker vertices only (no transfer: a masked write)
        n = len(mk_slots)
        free = (problem.mk_valid & ~problem.mk_fixed)[:n]
        mk_idx = torch.from_numpy(np.asarray(mk_slots, np.int64)).to(dev)
        mk_pose = st.mk_pose.clone()
        mk_pose[mk_idx] = torch.where(free[:, None, None], result.mk_pose[:n], mk_pose[mk_idx])
        st = st.replace(mk_pose=mk_pose)
    world_map.state = st
    n_bad = 0
    if remove_bad:
        bad, obs_cam_h, obs_pt_h = fetch_to_host(result.obs_bad, problem.obs_cam, problem.obs_pt)
        if bad.any():
            # clear only the affected keyframe rows
            cams = np.asarray(kf_slots)[obs_cam_h[bad]]
            pts = np.asarray(pt_slots)[obs_pt_h[bad]]
            uniq = np.unique(cams)
            ci = {int(s): i for i, s in enumerate(uniq)}
            rows_d = torch.from_numpy(uniq.astype(np.int64)).to(dev)
            rows = world_map.state.kf_ids[rows_d].cpu().numpy().copy()
            rix = [ci[int(c)] for c in cams]
            hits = rows[rix] == pts[:, None]
            clear = np.zeros_like(rows, bool)
            np.logical_or.at(clear, rix, hits)
            n_bad = int(clear.sum())
            rows[clear] = -1
            kf_ids = world_map.state.kf_ids.clone()
            kf_ids[rows_d] = torch.from_numpy(rows).to(dev)
            world_map.state = world_map.state.replace(kf_ids=kf_ids)
    return n_bad


# ----------------------------------------------------------------------
# Distributed dispatch: the BA entry points below run the sharded solvers
# (parallel/sharded_pm.py, parallel/sharded_ba.py: the same LM cores) when
# a mesh of ranks is available and the problem is big enough to gain.
# Under torch.distributed every rank runs the same sequential-mode program
# on the same frames, so all ranks reach each BA together with the same
# problem (parallel/distributed.py). Async mapping runs local BA on each
# rank's worker thread at its own time, on maps that differ: `System`
# refuses it where the dispatch may shard (`ba_mesh_spans_ranks`).
# ----------------------------------------------------------------------

#: below this many live points, sharding costs more than it saves
DIST_BA_MIN_POINTS = 512

_ba_mesh = "auto"  # "auto" | None (single device) | a parallel.mesh.Mesh (forced)


def set_ba_mesh(mesh) -> None:
    """Override the distributed-BA dispatch: a Mesh forces the sharded
    solvers, None the single-device one, "auto" (the default) shards over
    the world when it has more than one rank on CUDA devices and the
    problem has DIST_BA_MIN_POINTS points or more. Set it before the
    `System` is made: a System in async mode checks it then."""
    global _ba_mesh
    _ba_mesh = mesh


def _auto_world() -> bool:
    """"auto" shards only across CUDA ranks, as the reference's shards only
    off the CPU; CPU worlds stay reachable through set_ba_mesh."""
    import torch.distributed as dist

    return (dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1
            and torch.cuda.is_available())


def ba_mesh_spans_ranks() -> bool:
    """True when the dispatch may shard a bundle adjustment over more than
    one rank: every rank must then reach each one together."""
    if _ba_mesh is None:
        return False
    if _ba_mesh != "auto":
        return _ba_mesh.size > 1
    return _auto_world()


def _resolve_ba_mesh(n_points: int, device):
    if _ba_mesh is None:
        return None
    if _ba_mesh != "auto":
        return _ba_mesh
    if _auto_world() and n_points >= DIST_BA_MIN_POINTS:
        from ucoslam_tpu_torch.parallel.distributed import global_mesh

        return global_mesh(device=device)
    return None


def _solve_dispatch(problem: BAProblem, cam: CameraParams, n_iters: int, n_points: int,
                    stages: int = 2) -> tuple[BAResult, BAProblem]:
    """Solve on the mesh when there is one -> (result, the problem as
    solved): the general sharded path reorders the observations, so the
    caller pairs the result with the returned problem."""
    mesh = _resolve_ba_mesh(n_points, problem.cam_pose.device)
    if mesh is not None and mesh.size > 1:
        # big marker-free problems: the communication-avoiding point-major
        # solver (two collectives an LM step, none inside PCG)
        if problem.cam_pose.shape[0] >= 128:
            from ucoslam_tpu_torch.optim import schur_pm

            pm = schur_pm.pm_problem_for(problem)
            if pm is not None:
                from ucoslam_tpu_torch.parallel.sharded_pm import shard_pm_problem, sharded_pm_solve

                spm = shard_pm_problem(pm, mesh.size)
                cam_pose, pt_pos, costs, c2, bad = sharded_pm_solve(spm, cam, mesh, iters=n_iters, stages=stages)
                dev = problem.cam_pose.device
                out = (cam_pose.to(dev), pt_pos[:problem.pt_pos.shape[0]].to(dev), costs.to(dev), c2.to(dev),
                       bad.to(dev))
                # per-observation outputs go back to the problem's own order
                return _pm_result(problem, spm.pm, cam, out), problem
        from ucoslam_tpu_torch.parallel.sharded_ba import shard_ba_problem, sharded_ba_solve

        sharded = shard_ba_problem(problem, mesh.size)
        res = sharded_ba_solve(sharded, cam, mesh, iters=n_iters, stages=stages)
        dev = problem.cam_pose.device
        res = BAResult(cam_pose=res.cam_pose.to(dev), pt_pos=res.pt_pos.to(dev), obs_chi2=res.obs_chi2.to(dev),
                       obs_bad=res.obs_bad.to(dev), cost_history=res.cost_history.to(dev),
                       mk_pose=None if res.mk_pose is None else res.mk_pose.to(dev))
        return res, sharded
    return ba_solve(problem, cam, iters=n_iters, stages=stages), problem


def global_bundle_adjustment(world_map: Map, cam: CameraParams, n_iters: int = 50, fix_first: bool = True) -> int:
    """Full-map BA (the reference's UcoSlam::globalOptimization), sharded
    over a mesh when the dispatch finds one (set_ba_mesh). Returns the
    number of bad associations removed."""
    if world_map.n_keyframes < 2:
        return 0
    problem, kf_slots, pt_slots, mk_slots = build_ba_problem(world_map, cam, fix_first=fix_first)
    if len(pt_slots) == 0:
        return 0
    result, solved = _solve_dispatch(problem, cam, n_iters, len(pt_slots))
    return apply_ba_result(world_map, result, kf_slots, pt_slots, solved, mk_slots=mk_slots)


def local_bundle_adjustment(
    world_map: Map, cam: CameraParams, center_kf: int, n_iters: int = 15, max_window: int | None = None,
) -> int:
    """Covis-window BA around a keyframe: the neighbours sharing >= 15
    points are optimized, the keyframes they share points with are held
    fixed. Returns the number of bad associations removed."""
    with timers.span("ba.local_ba"):
        with timers.span("ba.build"):
            covis = world_map.covis_matrix()
            w = covis[center_kf].copy()
            w[center_kf] = 0
            order = np.argsort(-w)
            cap = (len(order) + 1) if max_window is None else max_window
            window = [center_kf] + [int(s) for s in order[: cap - 1] if w[s] >= 15]
            if len(window) < 2:
                return 0
            window_set = set(window)
            boundary = [int(s) for s in np.nonzero(covis[window].sum(0) > 0)[0] if int(s) not in window_set]
            problem, kf_slots, pt_slots, mk_slots = build_ba_problem(
                world_map, cam, used_kfs=np.asarray(window), fixed_kfs=np.asarray(boundary, int),
                fix_first=len(boundary) == 0,
            )
        if len(pt_slots) == 0:
            return 0
        with timers.span("ba.solve"):
            result, solved = _solve_dispatch(problem, cam, n_iters, len(pt_slots))
        with timers.span("ba.apply"):
            return apply_ba_result(world_map, result, kf_slots, pt_slots, solved, mk_slots=mk_slots)
