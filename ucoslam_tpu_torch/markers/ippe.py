"""IPPE: Infinitesimal Plane-based Pose Estimation for square markers.

Port of `ucoslam_tpu/markers/ippe.py` (Collins & Bartoli, IJCV 2014): the
homography of a marker's 4 corners gives TWO closed-form poses, each
polished by 5 Gauss-Newton steps on the corners, with their reprojection
errors; err2 / err1 measures the planar ambiguity. Batched over leading
dimensions (the frame's 16 marker slots) on the corners' device, with the
reference's sign rules: the homography's null vector is normalized by
H[2, 2], which removes the sign `eigh` returns it with, and the poses are
ordered best first. The two solutions are polished as one batch, and the
small solves skip the error check (`solve_ex`), which would wait for the
card: the problem is a few hundred tiny launches, not arithmetic.

Unlike the rest of the port, IPPE computes in float64 and returns float32.
The polish solves normal equations of an ill-conditioned Jacobian (a small,
far marker's pose is weakly held along one direction). In float32 that
direction is rounding noise, and two devices or two eigensolvers disagreed
by 1e-3 on a far marker's pose; in float64 a pose moves by less than 2e-4
under 1e-4 px of corner noise (tests/test_torch_markers.py). Against the
float32 reference the difference is the reference's own rounding.

Corner order (ArUco): TL, TR, BR, BL; marker frame: x right, y up, z out of
the plane, centred.
"""

from __future__ import annotations

import torch

from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.geometry.se3 import _hat, se3_exp, se3_from_Rt


def marker_object_points(size) -> torch.Tensor:
    """(..., 4, 3) corner coordinates in the marker frame (TL, TR, BR, BL)
    for marker side lengths `size` (a float or a (...) tensor)."""
    h = (size if isinstance(size, torch.Tensor) else torch.tensor(size, dtype=torch.float32)) / 2.0
    z = torch.zeros_like(h)
    return torch.stack(
        [
            torch.stack([-h, h, z], -1),
            torch.stack([h, h, z], -1),
            torch.stack([h, -h, z], -1),
            torch.stack([-h, -h, z], -1),
        ],
        -2,
    )


def _homography_4pt(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Exact homographies (..., 3, 3) from 4 correspondences (..., 4, 2):
    the null vector of the 8 x 9 DLT system, from eigh of A^T A."""
    u1 = torch.cat([src, torch.ones_like(src[..., :1])], -1)  # (..., 4, 3)
    zeros = torch.zeros_like(u1)
    x2, y2 = dst[..., 0:1], dst[..., 1:2]
    rows1 = torch.cat([zeros, -u1, y2 * u1], -1)
    rows2 = torch.cat([u1, zeros, -x2 * u1], -1)
    A = torch.cat([rows1, rows2], -2)  # (..., 8, 9)
    _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    H = vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 3))
    return H / H[..., 2:3, 2:3]


def _rotate_vec_to_z(a: torch.Tensor) -> torch.Tensor:
    """Rotations R (..., 3, 3) with R @ (a / |a|) = e_z."""
    an = a / torch.linalg.norm(a, dim=-1, keepdim=True).clamp(min=1e-12)
    ez = torch.zeros_like(an)
    ez[..., 2] = 1.0
    v = torch.linalg.cross(an, ez)
    c = an[..., 2]
    s2 = (v * v).sum(-1)
    vx = _hat(v)
    eye = torch.eye(3, dtype=a.dtype, device=a.device).expand(vx.shape)
    R = eye + vx + vx @ vx * ((1.0 - c) / s2.clamp(min=1e-12))[..., None, None]
    return torch.where((s2 < 1e-12)[..., None, None], eye * torch.sign(c + 0.5)[..., None, None], R)


def _solve_translation(R: torch.Tensor, obj: torch.Tensor, uv_n: torch.Tensor) -> torch.Tensor:
    """Least-squares t given R: rows [I | -u] (R X + t) = 0 for each corner."""
    RX = obj @ R.transpose(-1, -2)  # (..., 4, 3)
    u, v = uv_n[..., 0], uv_n[..., 1]
    ones, zeros = torch.ones_like(u), torch.zeros_like(u)
    A_rows = torch.stack(
        [torch.stack([ones, zeros, -u], -1), torch.stack([zeros, ones, -v], -1)], -2
    )  # (..., 4, 2, 3)
    b_rows = -(A_rows @ RX[..., None])[..., 0]  # (..., 4, 2)
    A = A_rows.reshape(A_rows.shape[:-3] + (8, 3))
    b = b_rows.reshape(b_rows.shape[:-2] + (8,))
    At = A.transpose(-1, -2)
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    return torch.linalg.solve_ex(At @ A + 1e-12 * eye, At @ b[..., None])[0][..., 0]


def _reproj_err(R, t, obj, uv_n) -> torch.Tensor:
    q = obj @ R.transpose(-1, -2) + t[..., None, :]
    uv = q[..., :2] / q[..., 2:3].clamp(min=1e-9)
    return torch.sqrt(((uv - uv_n) ** 2).sum(-1).mean(-1))


def _refine_pose(R, t, obj, uv_n, iters: int = 5):
    """Polish IPPE solutions by Gauss-Newton on the 4 corners (6-DoF, 8
    residuals): the closed form is exact only at the marker centre."""
    T = se3_from_Rt(R, t)
    eye3 = torch.eye(3, dtype=R.dtype, device=R.device)
    eye6 = torch.eye(6, dtype=R.dtype, device=R.device)
    for _ in range(iters):
        q = obj @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]  # (..., 4, 3)
        z = q[..., 2:3].clamp(min=1e-9)
        r = (q[..., :2] / z - uv_n).reshape(q.shape[:-2] + (8,))
        inv_z = 1.0 / z[..., 0]
        zero = torch.zeros_like(inv_z)
        J_proj = torch.stack(
            [
                torch.stack([inv_z, zero, -q[..., 0] * inv_z**2], -1),
                torch.stack([zero, inv_z, -q[..., 1] * inv_z**2], -1),
            ],
            -2,
        )  # (..., 4, 2, 3)
        J_pose = torch.cat([eye3.expand(q.shape + (3,)), -_hat(q)], -1)  # (..., 4, 3, 6)
        J = (J_proj @ J_pose).reshape(q.shape[:-2] + (8, 6))
        Jt = J.transpose(-1, -2)
        delta = torch.linalg.solve_ex(Jt @ J + 1e-9 * eye6, Jt @ r[..., None])[0][..., 0]
        T = se3_exp(-delta) @ T
    return T[..., :3, :3], T[..., :3, 3]


def _ippe(uv_n: torch.Tensor, size: torch.Tensor):
    """IPPE on normalized image coordinates (..., 4, 2) -> two poses
    (..., 4, 4), best first, and their errors (...)."""
    obj = marker_object_points(size).to(uv_n.device)  # (..., 4, 3)
    H = _homography_4pt(obj[..., :2], uv_n)
    p, q = H[..., 0, 2], H[..., 1, 2]
    # Jacobian of the homography map at the marker centre
    J = torch.stack(
        [
            torch.stack([H[..., 0, 0] - H[..., 2, 0] * p, H[..., 0, 1] - H[..., 2, 1] * p], -1),
            torch.stack([H[..., 1, 0] - H[..., 2, 0] * q, H[..., 1, 1] - H[..., 2, 1] * q], -1),
        ],
        -2,
    )
    Rv = _rotate_vec_to_z(torch.stack([p, q, torch.ones_like(p)], -1))
    B = torch.stack(
        [
            torch.stack([Rv[..., 0, 0] - p * Rv[..., 2, 0], Rv[..., 0, 1] - p * Rv[..., 2, 1]], -1),
            torch.stack([Rv[..., 1, 0] - p * Rv[..., 2, 0], Rv[..., 1, 1] - p * Rv[..., 2, 1]], -1),
        ],
        -2,
    )
    det = B[..., 0, 0] * B[..., 1, 1] - B[..., 0, 1] * B[..., 1, 0]
    adj = torch.stack(
        [torch.stack([B[..., 1, 1], -B[..., 0, 1]], -1), torch.stack([-B[..., 1, 0], B[..., 0, 0]], -1)], -2
    )
    Binv = adj / torch.where(det.abs() < 1e-12, 1e-12, det)[..., None, None]
    A = Binv @ J
    AtA = A.transpose(-1, -2) @ A
    a00, a11, a01 = AtA[..., 0, 0], AtA[..., 1, 1], AtA[..., 0, 1]
    g = torch.sqrt(0.5 * (a00 + a11 + torch.sqrt((a00 - a11) ** 2 + 4.0 * a01**2))).clamp(min=1e-12)
    Rt = A / g[..., None, None]  # the top-left 2x2 of the rotation
    b0 = torch.sqrt((1.0 - Rt[..., 0, 0] ** 2 - Rt[..., 1, 0] ** 2).clamp(min=0.0))
    b1 = torch.sqrt((1.0 - Rt[..., 0, 1] ** 2 - Rt[..., 1, 1] ** 2).clamp(min=0.0))
    sp = -(Rt[..., 0, 0] * Rt[..., 0, 1] + Rt[..., 1, 0] * Rt[..., 1, 1])
    b1 = torch.where(sp < 0, -b1, b1)

    def build(sign):
        c1 = torch.stack([Rt[..., 0, 0], Rt[..., 1, 0], sign * b0], -1)
        c2 = torch.stack([Rt[..., 0, 1], Rt[..., 1, 1], sign * b1], -1)
        Rp = torch.stack([c1, c2, torch.linalg.cross(c1, c2)], -1)
        return Rv.transpose(-1, -2) @ Rp

    # both solutions as one batch (a leading axis of 2), polished together
    R = torch.stack([build(1.0), build(-1.0)])
    obj2, uv2 = obj.expand(R.shape[:-2] + obj.shape[-2:]), uv_n.expand(R.shape[:-2] + uv_n.shape[-2:])
    R, t = _refine_pose(R, _solve_translation(R, obj2, uv2), obj2, uv2)
    e = _reproj_err(R, t, obj2, uv2)
    (R1, R2), (t1, t2), (e1, e2) = R, t, e
    swap = e2 < e1  # best first
    Ra = torch.where(swap[..., None, None], R2, R1)
    Rb = torch.where(swap[..., None, None], R1, R2)
    ta = torch.where(swap[..., None], t2, t1)
    tb = torch.where(swap[..., None], t1, t2)
    return se3_from_Rt(Ra, ta), se3_from_Rt(Rb, tb), torch.minimum(e1, e2), torch.maximum(e1, e2)


def ippe_square_poses(corners_und: torch.Tensor, sizes: torch.Tensor, cam: CameraParams):
    """Batched IPPE over undistorted pixel corners (M, 4, 2) of markers of
    side lengths `sizes` (M,) -> (pose1 (M, 4, 4), pose2, err1 (M,), err2):
    marker -> camera poses, best first; err2 / err1 is the ambiguity.
    Computed in float64 (see the module's docstring), returned in the
    corners' dtype."""
    c = corners_und.to(torch.float64)
    uv_n = torch.stack([(c[..., 0] - cam.cx) / cam.fx, (c[..., 1] - cam.cy) / cam.fy], -1)
    return tuple(a.to(corners_und.dtype) for a in _ippe(uv_n, sizes.to(torch.float64)))
