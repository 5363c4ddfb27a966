"""The FREAK and SURF descriptor tables: retina sampling and SURF-LSH.

Port of `ucoslam_tpu/features/descriptors.py` (numpy, built once from fixed
seeds, so both packages hold the same arrays). Both families share the ORB
extractor's detection and patches (`features/orb.py`) and give the same
packed 256-bit format, so B1 and the Hamming code serve them unchanged:

- FREAK (Alahi et al., CVPR 2012): a 43-point retina (a fovea and 7 rings
  of 6) with ring-proportional Gaussian receptive fields; one (patch -> 43)
  weight table per rotation bin; 256 point-pair comparisons.
- SURF (Bay et al., ECCV 2006): central-difference gradients rotated into
  the keypoint's frame, pooled over a Gaussian-weighted 4x4 grid into the
  64-d (sum dx, sum |dx|, sum dy, sum |dy|) vector, then binarized by the
  sign of 256 seeded random projections (LSH).

The tables have DESC_BINS = 64 rotation bins, and the extractor quantizes a
FREAK or SURF keypoint's angle to these 64 (ORB keeps its own 32).
"""

from __future__ import annotations

import functools

import numpy as np

PATCH_RADIUS = 15  # features/orb.py's PATCH_RADIUS
DESC_BINS = 64  # rotation bins of the FREAK and SURF tables
N_BITS = 256

_P = 2 * PATCH_RADIUS + 1


def _freak_pattern() -> np.ndarray:
    """(43, 3) retina sampling points (x, y, sigma): ring radii shrink toward
    the fovea, each receptive field's sigma grows with its ring's spacing."""
    R = 13.0  # rotated samples stay inside the 31x31 patch
    ring_frac = [1.0, 0.78, 0.6, 0.45, 0.32, 0.22, 0.14]
    pts = [(0.0, 0.0, 0.6)]  # fovea
    for k, fr in enumerate(ring_frac):
        r = R * fr
        sigma = max(0.6, 0.45 * r * (ring_frac[0] - ring_frac[-1]) / len(ring_frac) + 0.25 * r / 3.0)
        phase = (np.pi / 6.0) * (k % 2)  # alternate rings staggered by half a step
        for j in range(6):
            a = phase + 2.0 * np.pi * j / 6.0
            pts.append((r * np.cos(a), r * np.sin(a), sigma))
    return np.asarray(pts, np.float32)


FREAK_POINTS = _freak_pattern()
N_FREAK = FREAK_POINTS.shape[0]


def _freak_pairs(seed: int = 7) -> np.ndarray:
    """(256, 2) comparison pairs, drawn without replacement with a weight
    that grows with the two points' distance (coarse pairs first)."""
    rng = np.random.default_rng(seed)
    ii, jj = np.triu_indices(N_FREAK, k=1)
    d = np.linalg.norm(FREAK_POINTS[ii, :2] - FREAK_POINTS[jj, :2], axis=1)
    w = d + 1.0
    sel = rng.choice(ii.shape[0], size=N_BITS, replace=False, p=w / w.sum())
    return np.stack([ii[sel], jj[sel]], -1).astype(np.int32)


FREAK_PAIRS = _freak_pairs()


def _patch_offsets() -> tuple[np.ndarray, np.ndarray]:
    ys, xs = np.mgrid[-PATCH_RADIUS : PATCH_RADIUS + 1, -PATCH_RADIUS : PATCH_RADIUS + 1]
    return xs.reshape(-1).astype(np.float32), ys.reshape(-1).astype(np.float32)


@functools.lru_cache(maxsize=1)
def freak_tables() -> np.ndarray:
    """(DESC_BINS, P*P, 43): column s of tables[b] is the normalized Gaussian
    over the patch pixels around retina point s rotated by 2*pi*b/DESC_BINS
    (cut at 3 sigma)."""
    xs, ys = _patch_offsets()
    tables = np.zeros((DESC_BINS, _P * _P, N_FREAK), np.float32)
    for b in range(DESC_BINS):
        a = 2.0 * np.pi * b / DESC_BINS
        ca, sa = np.cos(a), np.sin(a)
        cx = ca * FREAK_POINTS[:, 0] - sa * FREAK_POINTS[:, 1]
        cy = sa * FREAK_POINTS[:, 0] + ca * FREAK_POINTS[:, 1]
        sig = FREAK_POINTS[:, 2]
        d2 = (xs[:, None] - cx[None, :]) ** 2 + (ys[:, None] - cy[None, :]) ** 2
        w = np.exp(-d2 / (2.0 * sig[None, :] ** 2))
        w[d2 > (3.0 * sig[None, :]) ** 2] = 0.0
        tables[b] = w / w.sum(axis=0, keepdims=True).clip(1e-9)
    return tables


SURF_GRID = 4  # 4x4 subregions
#: half-extent of the grid in the keypoint's frame: at most PATCH_RADIUS /
#: sqrt(2), so that the rotated grid stays inside the patch at every bin
SURF_HALF = 10.5


@functools.lru_cache(maxsize=1)
def surf_tables() -> np.ndarray:
    """(DESC_BINS, P*P, 16) pooling masks: each patch pixel, rotated by
    -2*pi*b/DESC_BINS into the keypoint's frame, weighs into its subregion
    with a Gaussian of sigma 0.8 * SURF_HALF; each subregion's mass is 1."""
    xs, ys = _patch_offsets()
    g = np.exp(-(xs**2 + ys**2) / (2.0 * (0.4 * SURF_HALF * 2) ** 2))
    cellw = 2.0 * SURF_HALF / SURF_GRID
    tables = np.zeros((DESC_BINS, _P * _P, SURF_GRID * SURF_GRID), np.float32)
    for b in range(DESC_BINS):
        a = 2.0 * np.pi * b / DESC_BINS
        ca, sa = np.cos(a), np.sin(a)
        ux = ca * xs + sa * ys
        uy = -sa * xs + ca * ys
        gx = np.floor((ux + SURF_HALF) / cellw).astype(np.int64)
        gy = np.floor((uy + SURF_HALF) / cellw).astype(np.int64)
        inside = (gx >= 0) & (gx < SURF_GRID) & (gy >= 0) & (gy < SURF_GRID)
        idx = np.nonzero(inside)[0]
        tables[b, idx, (gy * SURF_GRID + gx)[idx]] = g[idx]
    return tables / tables.sum(axis=1, keepdims=True).clip(1e-9)


@functools.lru_cache(maxsize=1)
def surf_lsh_projection(seed: int = 1234) -> np.ndarray:
    """(64, 256) seeded random-hyperplane projection."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((4 * SURF_GRID * SURF_GRID, N_BITS)).astype(np.float32)
