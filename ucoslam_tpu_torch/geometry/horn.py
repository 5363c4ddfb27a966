"""Horn 1987 closed-form trajectory alignment and ATE (numpy).

Port of `ucoslam_tpu/geometry/horn.py`.
"""

from __future__ import annotations

import numpy as np


def horn_align(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Closed-form similarity (s, R, t) minimizing ||s R src + t - dst||^2."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs * xs).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est: np.ndarray, gt: np.ndarray, with_scale: bool = True) -> float:
    """RMSE of the translational error after Horn alignment."""
    s, R, t = horn_align(est, gt, with_scale)
    aligned = (s * (R @ est.T)).T + t
    err = aligned - gt
    return float(np.sqrt((err * err).sum(-1).mean()))
