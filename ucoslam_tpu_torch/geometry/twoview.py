"""Two-view relative geometry: H/F RANSAC, model selection, motion recovery.

Port of `ucoslam_tpu/geometry/twoview.py` (the ORB-SLAM initializer the
reference MapInitializer follows). All hypotheses run as one batch; scoring
uses the truncated chi2 scores with thresholds 3.841 (F, 1 dof) and 5.991
(H, 2 dof).

The reference draws each hypothesis' 8 rows inside its jitted function with
`jax.random.categorical`; those bits cannot be reproduced here, so
`estimate_two_view` takes the draws as an explicit (H, 8) index tensor
(`slam/initializer.py` draws them on the host from a seeded numpy generator,
so the card and the CPU see the same hypotheses).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ucoslam_tpu_torch.config import CHI2_1D, CHI2_2D
from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.geometry.se3 import se3_from_Rt
from ucoslam_tpu_torch.geometry.triangulate import null_vector, triangulate_dlt

TH_F = CHI2_1D  # 3.841
TH_H = CHI2_2D  # 5.991
TH_SCORE = CHI2_2D  # score truncation, as ORB-SLAM


def _normalize_points(uv: torch.Tensor, valid: torch.Tensor):
    """Hartley normalization. Returns (uv_norm, T (3, 3))."""
    w = valid.to(uv.dtype)
    n = w.sum().clamp(min=1.0)
    mean = (uv * w[:, None]).sum(0) / n
    d = ((uv - mean).abs() * w[:, None]).sum(0) / n
    s = 1.0 / d.clamp(min=1e-6)
    T = torch.eye(3, dtype=uv.dtype, device=uv.device)
    T[0, 0], T[1, 1] = s[0], s[1]
    T[0, 2], T[1, 2] = -mean[0] * s[0], -mean[1] * s[1]
    return (uv - mean) * s, T


def _fundamental_8pt(uv1: torch.Tensor, uv2: torch.Tensor) -> torch.Tensor:
    """8-point F from (..., 8, 2) normalized pairs, rank 2 enforced."""
    u1, v1 = uv1[..., 0], uv1[..., 1]
    u2, v2 = uv2[..., 0], uv2[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, torch.ones_like(u1)], -1)
    F = null_vector(A).reshape(uv1.shape[:-2] + (3, 3))
    U, S, Vt = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], -1)
    return (U * S[..., None, :]) @ Vt


def _homography_4pt(uv1: torch.Tensor, uv2: torch.Tensor) -> torch.Tensor:
    """DLT H from (..., S>=4, 2) pairs (normalized coords)."""
    u1 = torch.cat([uv1, torch.ones_like(uv1[..., :1])], -1)  # (..., S, 3)
    zeros = torch.zeros_like(u1)
    x2, y2 = uv2[..., 0:1], uv2[..., 1:2]
    rows1 = torch.cat([zeros, -u1, y2 * u1], -1)  # (..., S, 9)
    rows2 = torch.cat([u1, zeros, -x2 * u1], -1)
    A = torch.cat([rows1, rows2], -2)
    return null_vector(A).reshape(uv1.shape[:-2] + (3, 3))


def _homogeneous(uv: torch.Tensor) -> torch.Tensor:
    return torch.cat([uv, torch.ones_like(uv[..., :1])], -1)


def _sym_epipolar_chi2(F12, uv1, uv2):
    """Per-match symmetric epipolar chi2 pair (d(x1, F^T x2), d(x2, F x1));
    F12 (..., 3, 3) against (M, 2) matches -> (..., M) each."""
    x1, x2 = _homogeneous(uv1), _homogeneous(uv2)
    l2 = x1 @ F12.transpose(-1, -2)  # lines in image 2
    l1 = x2 @ F12  # lines in image 1
    num = (x2 * l2).sum(-1)
    d2_2 = num * num / (l2[..., 0] ** 2 + l2[..., 1] ** 2).clamp(min=1e-12)
    d2_1 = num * num / (l1[..., 0] ** 2 + l1[..., 1] ** 2).clamp(min=1e-12)
    return d2_1, d2_2


def _sym_transfer_chi2(H, Hinv, uv1, uv2):
    """Symmetric transfer errors of homographies H (..., 3, 3), given
    their inverses."""
    x1, x2 = _homogeneous(uv1), _homogeneous(uv2)
    Hx1 = x1 @ H.transpose(-1, -2)
    Hx1 = Hx1[..., :2] / Hx1[..., 2:3].clamp(min=1e-12) * torch.sign(Hx1[..., 2:3] + 1e-30)
    Hx2 = x2 @ Hinv.transpose(-1, -2)
    Hx2 = Hx2[..., :2] / Hx2[..., 2:3].clamp(min=1e-12) * torch.sign(Hx2[..., 2:3] + 1e-30)
    e12 = ((Hx1 - uv2) ** 2).sum(-1)
    e21 = ((Hx2 - uv1) ** 2).sum(-1)
    return e21, e12


@dataclass
class TwoViewModel:
    F: torch.Tensor  # (3, 3) best fundamental (pixel coords)
    H: torch.Tensor  # (3, 3) best homography (pixel coords)
    score_f: torch.Tensor  # ()
    score_h: torch.Tensor  # ()
    inliers_f: torch.Tensor  # (M,) bool
    inliers_h: torch.Tensor  # (M,) bool
    best_f: torch.Tensor  # () index of the winning F hypothesis
    best_h: torch.Tensor  # () index of the winning H hypothesis


def _truncated_score(c1, c2, th, valid):
    ok = (c1 < th) & (c2 < th) & valid
    sc = torch.where(c1 < th, TH_SCORE - c1, 0.0) + torch.where(c2 < th, TH_SCORE - c2, 0.0)
    return (sc * valid.to(torch.float32)).sum(-1), ok


def estimate_two_view(
    uv1: torch.Tensor,  # (M, 2) undistorted pixels in frame 1
    uv2: torch.Tensor,  # (M, 2) matched pixels in frame 2
    valid: torch.Tensor,  # (M,) bool
    sigma2: torch.Tensor,  # (M,) per-match variance
    sample_idx: torch.Tensor,  # (H, 8) int rows drawn for each hypothesis
) -> TwoViewModel:
    """RANSAC both F and H on the same matches, every hypothesis at once;
    the best of each by score, the lowest index on ties (as jnp.argmax).
    The minimal-sample fits run in float64 (a near-degenerate sample's
    null vector moves by percents under float32 rounding) and the scoring
    in float32."""
    n1, T1 = _normalize_points(uv1.double(), valid)
    n2, T2 = _normalize_points(uv2.double(), valid)
    idx = sample_idx.long()
    Fn = _fundamental_8pt(n1[idx], n2[idx])
    Fs = (T2.T @ Fn @ T1).float()
    Hn = _homography_4pt(n1[idx[:, :4]], n2[idx[:, :4]])
    # the transfer score counts only points mapped with w > 0, so an H is
    # worth something only with one of its two signs; the eigensolver's
    # sign is arbitrary (the reference keeps whichever LAPACK returned), so
    # each H gets the sign that maps its own sample with positive w
    w = (_homogeneous(n1[idx[:, :4]]) * Hn[:, None, 2, :]).sum((-1, -2))
    Hn = Hn * torch.where(w < 0, -1.0, 1.0).to(Hn.dtype)[:, None, None]
    Hs = torch.linalg.inv(T2) @ Hn @ T1
    Hinv = torch.linalg.inv(Hs).float()  # a degenerate sample's H is near singular
    Hs = Hs.float()

    d1, d2 = _sym_epipolar_chi2(Fs, uv1, uv2)
    sf, okf = _truncated_score(d1 / sigma2, d2 / sigma2, TH_F, valid)
    e1, e2 = _sym_transfer_chi2(Hs, Hinv, uv1, uv2)
    sh, okh = _truncated_score(e1 / sigma2, e2 / sigma2, TH_H, valid)
    bi_f, bi_h = torch.argmax(sf), torch.argmax(sh)
    return TwoViewModel(
        F=Fs[bi_f], H=Hs[bi_h], score_f=sf[bi_f], score_h=sh[bi_h],
        inliers_f=okf[bi_f], inliers_h=okh[bi_h], best_f=bi_f, best_h=bi_h,
    )


def _candidate_poses_from_E(E: torch.Tensor):
    """4 candidate (R, t) from an essential matrix; t normalized."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    t = t / torch.linalg.norm(t).clamp(min=1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _candidate_poses_from_H(H_cal: torch.Tensor):
    """8 candidate (R, t) from a calibrated homography (Faugeras 1988);
    H_cal = K2^-1 H K1 maps normalized coords 1 -> 2."""
    U, S, Vt = torch.linalg.svd(H_cal)
    d1, d2, d3 = S[0], S[1], S[2]
    s = torch.linalg.det(U) * torch.linalg.det(Vt)

    denom1 = (d1 * d1 - d3 * d3).clamp(min=1e-12)
    aux1 = torch.sqrt(((d1 * d1 - d2 * d2) / denom1).clamp(min=0.0))
    aux3 = torch.sqrt(((d2 * d2 - d3 * d3) / denom1).clamp(min=0.0))
    x1s = torch.stack([aux1, aux1, -aux1, -aux1])
    x3s = torch.stack([aux3, -aux3, aux3, -aux3])
    root = torch.sqrt(((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3)).clamp(min=0.0))
    # case d' = +d2
    sin_t = root / ((d1 + d3) * d2).clamp(min=1e-12)
    cos_t = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2).clamp(min=1e-12)
    # case d' = -d2
    sin_p = root / ((d1 - d3) * d2).clamp(min=1e-12)
    cos_p = (d1 * d3 - d2 * d2) / ((d1 - d3) * d2).clamp(min=1e-12)
    zero, one = torch.zeros_like(d1), torch.ones_like(d1)

    def rot(rows):
        return torch.stack([torch.stack(r) for r in rows])

    Rs, ts = [], []
    for i in range(4):  # d' = +d2; the sin sign couples to sign(x1) sign(x3)
        eps = torch.sign(x1s[i] + 1e-30) * torch.sign(x3s[i] + 1e-30)
        st = eps * sin_t
        Rp = rot([[cos_t, zero, -st], [zero, one, zero], [st, zero, cos_t]])
        Rs.append(s * U @ Rp @ Vt)
        ts.append(U @ ((d1 - d3) * torch.stack([x1s[i], zero, -x3s[i]])))
    for i in range(4):  # d' = -d2
        eps = torch.sign(x1s[i] + 1e-30) * torch.sign(x3s[i] + 1e-30)
        sp = eps * sin_p
        Rp = rot([[cos_p, zero, sp], [zero, -one, zero], [sp, zero, -cos_p]])
        Rs.append(s * U @ Rp @ Vt)
        ts.append(U @ ((d1 + d3) * torch.stack([x1s[i], zero, x3s[i]])))
    ts = torch.stack(ts)
    return torch.stack(Rs), ts / torch.linalg.norm(ts, dim=-1, keepdim=True).clamp(min=1e-12)


@dataclass
class Reconstruction:
    ok: torch.Tensor  # () bool
    pose_21: torch.Tensor  # (4, 4) pose of frame 2 wrt frame 1 (cam1 -> cam2)
    points: torch.Tensor  # (M, 3) triangulated in frame-1 camera coords
    point_ok: torch.Tensor  # (M,) bool
    n_good: torch.Tensor  # () int


def _check_pose(R, t, uv1, uv2, valid, cam1: CameraParams, cam2: CameraParams, sigma2):
    """Triangulate all matches under candidate poses R (C, 3, 3), t (C, 3);
    count cheirality + reprojection inliers and the representative parallax
    (ORB-SLAM CheckRT). -> good (C, M), X (C, M, 3), parallax_cos (C,)."""
    dev = uv1.device
    P1 = cam1.K(dev) @ torch.eye(4, device=dev)[:3, :4]
    P2 = cam2.K(dev) @ se3_from_Rt(R, t)[..., :3, :4]
    X = triangulate_dlt(uv1, uv2, P1, P2[:, None])
    z1 = X[..., 2]
    Xc2 = X @ R.transpose(-1, -2) + t[:, None, :]
    z2 = Xc2[..., 2]
    r1 = cam1.project(X) - uv1
    r2 = cam2.project(Xc2) - uv2
    c1 = (r1 * r1).sum(-1) / sigma2
    c2 = (r2 * r2).sum(-1) / sigma2
    o2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    ray2 = X - o2[:, None, :]
    cosp = (X * ray2).sum(-1) / (
        torch.linalg.norm(X, dim=-1) * torch.linalg.norm(ray2, dim=-1)
    ).clamp(min=1e-12)
    good = valid & (z1 > 0) & (z2 > 0) & (c1 < CHI2_2D * 2) & (c2 < CHI2_2D * 2) & (cosp < 0.99998)
    # representative parallax: ~the 50th best cos (ORB-SLAM: min over top 50)
    parallax_cos = torch.quantile(torch.where(good, cosp, 1.0), 0.1, dim=-1)
    return good, X, parallax_cos


def reconstruct_two_view(
    model: TwoViewModel,
    uv1: torch.Tensor,
    uv2: torch.Tensor,
    valid: torch.Tensor,
    sigma2: torch.Tensor,
    cam1: CameraParams,
    cam2: CameraParams,
    min_triangulated: int = 50,
    min_parallax_deg: float = 1.0,
) -> Reconstruction:
    """Select H vs F (ratio 0.40, as ORB-SLAM) and recover the motion."""
    dev = uv1.device
    ratio_h = model.score_h / (model.score_h + model.score_f).clamp(min=1e-9)
    use_h = ratio_h > 0.40
    K1, K2 = cam1.K(dev), cam2.K(dev)
    Rs_e, ts_e = _candidate_poses_from_E(K2.T @ model.F @ K1)
    Rs_h, ts_h = _candidate_poses_from_H(torch.linalg.inv(K2) @ model.H @ K1)
    Rs = torch.cat([Rs_e, Rs_h])  # (12, 3, 3)
    ts = torch.cat([ts_e, ts_h])
    fam_ok = torch.cat([(~use_h).expand(4), use_h.expand(8)])
    inliers = torch.where(use_h, model.inliers_h, model.inliers_f) & valid

    goods, Xs, pcs = _check_pose(Rs, ts, uv1, uv2, inliers, cam1, cam2, sigma2)
    n_goods = torch.where(fam_ok, goods.sum(-1), -1)
    best = torch.argmax(n_goods)
    n_best = n_goods[best]
    second = torch.sort(n_goods).values[-2]  # winner must dominate
    parallax_ok = pcs[best] < torch.cos(torch.deg2rad(torch.tensor(min_parallax_deg, device=dev)))
    ok = (
        (n_best >= min_triangulated)
        & (second.to(torch.float32) < 0.9 * n_best.to(torch.float32))
        & parallax_ok
    )
    return Reconstruction(
        ok=ok, pose_21=se3_from_Rt(Rs[best], ts[best]), points=Xs[best],
        point_ok=goods[best], n_good=n_best,
    )
