"""FAST-9/16 corner scores, 3x3 non-maximum suppression and grid top-k.

Port of `ucoslam_tpu/ops/fast.py`. The 16 Bresenham-circle neighbours are
16 shifted image planes; the arc test is a log-step min over rolled planes.
`jax.lax.top_k` puts the lower index first among equal values and
`torch.topk` promises no order, so selection here is a stable descending
sort, which keeps the reference's keypoint order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# 16 Bresenham circle offsets of radius 3, in circular order, as (dy, dx).
CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)
BORDER = 3


def _circle_stack(img: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (16, H, W): plane i holds the circle-i neighbour of each
    pixel, read from edge-replicated padding at the border."""
    padded = F.pad(img[None, None], (BORDER,) * 4, mode="replicate")[0, 0]
    h, w = img.shape
    return torch.stack([
        padded[BORDER + int(dy) : BORDER + int(dy) + h, BORDER + int(dx) : BORDER + int(dx) + w]
        for dy, dx in CIRCLE
    ])


def _min_over_arc(vals: torch.Tensor) -> torch.Tensor:
    """(16, H, W) -> (16, H, W): out[i] = min(vals[i..i+8] circular)."""
    m2 = torch.minimum(vals, torch.roll(vals, -1, 0))
    m4 = torch.minimum(m2, torch.roll(m2, -2, 0))
    m8 = torch.minimum(m4, torch.roll(m4, -4, 0))
    return torch.minimum(m8, torch.roll(vals, -8, 0))


def fast_score_map(img: torch.Tensor, threshold) -> torch.Tensor:
    """(H, W) float32 -> (H, W) FAST scores: the largest threshold at which
    the pixel is still a corner, 0 where it is none (and on the border)."""
    circ = _circle_stack(img)
    center = img[None]
    score = torch.maximum(
        _min_over_arc(circ - center).amax(0), _min_over_arc(center - circ).amax(0)
    )
    score = torch.where(score > threshold, score, 0.0)
    h, w = img.shape
    interior = torch.zeros_like(score, dtype=torch.bool)
    interior[BORDER : h - BORDER, BORDER : w - BORDER] = True
    return torch.where(interior, score, 0.0)


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression keeping strict local maxima; a plateau
    keeps its first pixel in scan order."""
    h, w = score.shape
    p = F.pad(score, (1, 1, 1, 1), value=-1.0)

    def shifted(dy, dx):
        return p[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    offsets = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0)]
    neigh_max = shifted(*offsets[0])
    for o in offsets[1:]:
        neigh_max = torch.maximum(neigh_max, shifted(*o))
    earlier_max = shifted(-1, -1)
    for o in ((-1, 0), (-1, 1), (0, -1)):
        earlier_max = torch.maximum(earlier_max, shifted(*o))
    keep = (score > neigh_max) | ((score == neigh_max) & (score > earlier_max))
    return torch.where(keep, score, 0.0)


def stable_topk(x: torch.Tensor, k: int):
    """Top-k along the last dim, lower index first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def cell_topk(score: torch.Tensor, cell: int, k_per_cell: int):
    """The best `k_per_cell` of each `cell`-sized tile (tiles row-major, the
    image zero-padded to whole tiles): (values (tiles, k), in-tile index
    (tiles, k) int64, row-major in the tile)."""
    h, w = score.shape
    gh, gw = -(-h // cell), -(-w // cell)
    s = F.pad(score, (0, gw * cell - w, 0, gh * cell - h))
    cells = s.reshape(gh, cell, gw, cell).permute(0, 2, 1, 3).reshape(gh * gw, cell * cell)
    return stable_topk(cells, min(k_per_cell, cell * cell))


def grid_topk(vals: torch.Tensor, idx: torch.Tensor, gw: int, cell: int, total_k: int):
    """The best `total_k` of `cell_topk`'s candidates of an image `gw` tiles
    wide, taken tile-major: (xy (total_k, 2) float32, scores (total_k,),
    valid (total_k,))."""
    c = torch.arange(vals.shape[0], device=vals.device)
    ys = ((c // gw) * cell)[:, None] + idx // cell
    xs = ((c % gw) * cell)[:, None] + idx % cell
    flat_vals, flat_x, flat_y = vals.reshape(-1), xs.reshape(-1), ys.reshape(-1)
    if flat_vals.numel() < total_k:
        # tiny image: fewer candidate slots than requested keypoints
        pad = total_k - flat_vals.numel()
        flat_vals, flat_x, flat_y = (F.pad(a, (0, pad)) for a in (flat_vals, flat_x, flat_y))
    top_vals, top_i = stable_topk(flat_vals, total_k)
    xy = torch.stack([flat_x[top_i], flat_y[top_i]], -1).to(torch.float32)
    return xy, top_vals, top_vals > 0.0

