"""Plain reference of the tracker's answers: camera poses against the
scene's true trajectory, after the best similarity (Umeyama / Horn), in
float64 numpy. A monocular map is defined up to a similarity, so that is the
alignment a pose sequence is judged after."""

from __future__ import annotations

import numpy as np


def centre(pose_f2g) -> np.ndarray:
    T = np.asarray(pose_f2g, np.float64)
    return -T[:3, :3].T @ T[:3, 3]


def sim3_rmse(est: np.ndarray, gt: np.ndarray) -> float:
    """RMS distance between gt (N, 3) and est (N, 3) after the similarity
    that brings est closest to gt."""
    est, gt = np.asarray(est, np.float64), np.asarray(gt, np.float64)
    ms, md = est.mean(0), gt.mean(0)
    src, dst = est - ms, gt - md
    U, S, Vt = np.linalg.svd(dst.T @ src / len(est))
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ D @ Vt
    var = (src**2).sum(1).mean()
    s = np.trace(np.diag(S) @ D) / var if var > 0 else 1.0
    moved = s * src @ R.T + md
    return float(np.sqrt(((moved - gt) ** 2).sum(1).mean()))


def session_ate(pairs: list, gt_poses) -> float | None:
    """pairs: [(frame index, pose_f2g)] of one session (or stream), a frame
    possibly more than once; None with fewer than 3 poses (no similarity is
    defined)."""
    if len(pairs) < 3:
        return None
    est = np.stack([centre(p) for _, p in pairs])
    gt = np.stack([centre(gt_poses[i]) for i, _ in pairs])
    return sim3_rmse(est, gt)
