"""Plain references of a stereo session's answers, in float64 numpy,
importing nothing of the program:

- `stereo_depth`: the depth of each left keypoint from the uint8 rectified
  pair and the program's left and right keypoints and descriptors;
- `rigid_rmse` / `session_metric_ate`: camera centres against the scene's
  true trajectory after the best rigid motion, with no scale: a stereo map's
  scale is the rig's baseline, so a pose sequence is judged metric.

The depth rules are the program's (`FrameExtractor.process_stereo`), which
depart from ORB-SLAM2's `Frame::ComputeStereoMatches` in three places:
ORB-SLAM2 searches a row band that widens with the right keypoint's octave
(2 x scaleFactor^octave rows) and takes the best distance under (TH_HIGH +
TH_LOW) / 2 without a mutual check, where this band is +-2 rows at every
octave and a match must be each side's best; its SAD runs on the keypoint's
pyramid level at integer pixels over +-5 offsets, where this one runs on the
full-resolution images at bilinear samples over +-4; and it fits a parabola
to the minimum and its neighbours, where this fits the equiangular (V) vertex,
exact for the piecewise-linear SAD of a step edge.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import ate

#: the SAD patch's half-width and the search's half-range along the row (px)
SAD_HALF, SAD_RANGE = 5, 4
#: rows between a left keypoint and a right keypoint it may match
ROW_BAND = 2.0
#: larger than any Hamming distance of 256 bits
INVALID = 10_000
#: a byte's set bits
_POPCOUNT8 = np.array([bin(b).count("1") for b in range(256)], np.int64)


def hamming_pairs(desc_a: np.ndarray, desc_b: np.ndarray, ia: np.ndarray, ib: np.ndarray) -> np.ndarray:
    """Hamming distance of each pair (desc_a[ia[k]], desc_b[ib[k]]) of (.., 8)
    uint32 descriptors."""
    a = np.ascontiguousarray(desc_a, np.uint32).view(np.uint8).reshape(len(desc_a), 32)
    b = np.ascontiguousarray(desc_b, np.uint32).view(np.uint8).reshape(len(desc_b), 32)
    return _POPCOUNT8[a[ia] ^ b[ib]].sum(1)


def bilinear(img: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """img (H, W) at (x, y): the top-left neighbour clipped to [0, W-2] x
    [0, H-2] and the weights to [0, 1], so a sample past a border takes the
    border's pixels."""
    h, w = img.shape
    x0 = np.clip(np.floor(x), 0, w - 2).astype(np.int64)
    y0 = np.clip(np.floor(y), 0, h - 2).astype(np.int64)
    fx, fy = np.clip(x - x0, 0.0, 1.0), np.clip(y - y0, 0.0, 1.0)
    return (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x0 + 1] * fx * (1 - fy)
            + img[y0 + 1, x0] * (1 - fx) * fy + img[y0 + 1, x0 + 1] * fx * fy)


def row_matches(xy_l, oct_l, desc_l, valid_l, xy_r, oct_r, desc_r, valid_r, max_disp: float,
                max_desc_dist: float) -> np.ndarray:
    """(N,) index of each left keypoint's right match, -1 where none: among
    the right keypoints within ROW_BAND rows, at a disparity in (0, max_disp)
    and within one octave, the one of least Hamming distance, when the left
    keypoint is also its best and the distance is at most max_desc_dist.
    Ties go to the lowest index on both sides."""
    n, m = len(xy_l), len(xy_r)
    disp = xy_l[:, None, 0] - xy_r[None, :, 0]
    mask = ((np.abs(xy_l[:, None, 1] - xy_r[None, :, 1]) <= ROW_BAND) & (disp > 0) & (disp < max_disp)
            & (np.abs(oct_l[:, None].astype(np.int64) - oct_r[None, :]) <= 1) & valid_l[:, None] & valid_r[None, :])
    ia, ib = np.nonzero(mask)
    dist = np.full((n, m), INVALID, np.int64)
    dist[ia, ib] = hamming_pairs(desc_l, desc_r, ia, ib)
    fwd = np.argmin(dist, 1) if m else np.zeros(n, np.int64)
    best = dist[np.arange(n), fwd] if m else np.full(n, INVALID)
    bwd = np.argmin(dist, 0) if n else np.zeros(m, np.int64)
    ok = (best <= max_desc_dist) & (bwd[fwd] == np.arange(n)) if m else np.zeros(n, bool)
    return np.where(ok, fwd, -1)


def stereo_depth(left: np.ndarray, right: np.ndarray, xy_l, oct_l, desc_l, valid_l, xy_r, oct_r, desc_r, valid_r,
                 bf: float, max_disp: float, max_desc_dist: float) -> np.ndarray:
    """(N,) depth of each left keypoint, 0 where none.

    left, right: (H, W) uint8 rectified pair; xy: (., 2) pixels; desc: (., 8)
    uint32 words; bf: baseline x fx; max_disp: bf / baseline (a point nearer
    than the baseline is no match). Each row match (`row_matches`) is refined
    along the row: the SAD of the 11x11 bilinear patch around the left
    keypoint against the right one's at 9 offsets (-4..4 px), the
    equiangular vertex of the least SAD and its two neighbours; a least SAD
    at either end of the search is rejected. depth = bf / disparity, kept
    where the refined disparity lies in (0, max_disp)."""
    xy_l, xy_r = np.asarray(xy_l, np.float64), np.asarray(xy_r, np.float64)
    valid_l, valid_r = np.asarray(valid_l, bool), np.asarray(valid_r, bool)
    idx = row_matches(xy_l, np.asarray(oct_l), desc_l, valid_l, xy_r, np.asarray(oct_r), desc_r, valid_r,
                      max_disp, max_desc_dist)
    depth = np.zeros(len(xy_l))
    rows = np.nonzero(idx >= 0)[0]
    if not len(rows):
        return depth
    img_l, img_r = np.asarray(left, np.float64), np.asarray(right, np.float64)
    W, R = SAD_HALF, SAD_RANGE
    gy, gx = np.mgrid[-W:W + 1, -W:W + 1].astype(np.float64)
    gx, gy = gx.reshape(-1), gy.reshape(-1)  # (121,), x fastest
    xl, yl = xy_l[rows, 0], xy_l[rows, 1]
    xr0, yr = xy_r[idx[rows], 0], xy_r[idx[rows], 1]
    patch_l = bilinear(img_l, xl[:, None] + gx, yl[:, None] + gy)  # (n, 121)
    offs = np.arange(-R, R + 1, dtype=np.float64)
    patch_r = bilinear(img_r, xr0[:, None, None] + offs[None, :, None] + gx, yr[:, None, None] + gy)  # (n, 9, 121)
    sad = np.abs(patch_r - patch_l[:, None, :]).sum(-1)
    j = np.argmin(sad, 1)
    jc = np.clip(j, 1, 2 * R - 1)
    s0, s1, s2 = (sad[np.arange(len(rows)), jc + k] for k in (-1, 0, 1))
    hi = np.maximum(s0, s2)
    with np.errstate(divide="ignore", invalid="ignore"):
        delta = np.where(hi > s1 + 1e-6, 0.5 * (s0 - s2) / (hi - s1), 0.0)
    disparity = xl - (xr0 + (jc - R) + np.clip(delta, -1.0, 1.0))
    good = (j >= 1) & (j <= 2 * R - 1) & (disparity > 0) & (disparity < max_disp)
    depth[rows] = np.where(good, bf / np.maximum(disparity, 1e-3), 0.0)
    return depth


def rigid_rmse(est: np.ndarray, gt: np.ndarray) -> float:
    """RMS distance between gt (N, 3) and est (N, 3) after the rotation and
    translation (no scale) that bring est closest to gt (Kabsch)."""
    est, gt = np.asarray(est, np.float64), np.asarray(gt, np.float64)
    ms, md = est.mean(0), gt.mean(0)
    src, dst = est - ms, gt - md
    U, _, Vt = np.linalg.svd(dst.T @ src)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    moved = src @ (U @ D @ Vt).T + md
    return float(np.sqrt(((moved - gt) ** 2).sum(1).mean()))


def session_metric_ate(pairs: list, gt_poses) -> float | None:
    """pairs: [(frame index, pose_f2g)] of one session; None with fewer than
    3 poses (as `ate.session_ate`)."""
    if len(pairs) < 3:
        return None
    est = np.stack([ate.centre(p) for _, p in pairs])
    gt = np.stack([ate.centre(gt_poses[i]) for i, _ in pairs])
    return rigid_rmse(est, gt)
