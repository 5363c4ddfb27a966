"""Hamming distances and best-2 matching for 256-bit binary descriptors.

Port of `ucoslam_tpu/ops/hamming.py`. Descriptors are (n, 8) int32 tensors
holding the bits of the reference's uint32 words (torch's uint32 has few
operations). Distances are XOR + SWAR popcount on int32: exact integers,
whatever the matmul precision setting.
"""

from __future__ import annotations

import math

import torch

DESC_WORDS = 8  # 8 x 32 bits = 256 bits
INVALID_DIST = 10_000  # sentinel larger than any Hamming distance


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element bit count of an int32 tensor (two's-complement bits)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F  # from here on the sign bit is clear
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """(..., N, 8) x (..., M, 8) int32 descriptors -> (..., N, M) int32
    Hamming distances (leading dims broadcast). One word at a time, so no
    (N, M, 8) intermediate exists."""
    dist = popcount32(desc_a[..., :, None, 0] ^ desc_b[..., None, :, 0])
    for w in range(1, DESC_WORDS):
        dist += popcount32(desc_a[..., :, None, w] ^ desc_b[..., None, :, w])
    return dist


def match_best2(
    dist: torch.Tensor,
    valid_rows: torch.Tensor | None = None,
    valid_cols: torch.Tensor | None = None,
    extra_mask: torch.Tensor | None = None,
):
    """Best and second-best match per row of an (..., N, M) int32 distance
    matrix.

    Masked entries become INVALID_DIST. Returns (best_idx (..., N) int64,
    best (..., N) int32, second (..., N) int32); the best index is the lowest
    column among equal minima (torch.argmin returns the first minimum) and
    the second best is the runner-up at a different column.
    """
    d = dist
    if valid_cols is not None:
        d = torch.where(valid_cols[..., None, :], d, INVALID_DIST)
    if extra_mask is not None:
        d = torch.where(extra_mask, d, INVALID_DIST)
    best_idx = torch.argmin(d, dim=-1)
    best = torch.gather(d, -1, best_idx[..., None])[..., 0]
    cols = torch.arange(d.shape[-1], device=d.device)
    second = torch.where(cols == best_idx[..., None], INVALID_DIST, d).amin(-1)
    if valid_rows is not None:
        best = torch.where(valid_rows, best, INVALID_DIST)
        second = torch.where(valid_rows, second, INVALID_DIST)
    return best_idx, best, second


def mutual_best(dist: torch.Tensor) -> torch.Tensor:
    """(N, M) -> (N,) column of each row's mutual nearest neighbour, -1 where
    the row's best column has another row as its best. Ties go to the lowest
    index on both axes (torch.argmin returns the first minimum), so a column
    whose entries are all equal points at row 0."""
    fwd = torch.argmin(dist, dim=1)
    bwd = torch.argmin(dist, dim=0)
    mutual = bwd[fwd] == torch.arange(dist.shape[0], device=dist.device)
    return torch.where(mutual, fwd, -1)


def filter_ambiguous_train_sized(
    best_idx: torch.Tensor, best_dist: torch.Tensor, num_cols: int
) -> torch.Tensor:
    """Keep, per train column, only the query row with the smallest distance
    (lowest row on ties). Returns a bool keep-mask over rows; leading dims
    of (..., N) inputs are independent problems."""
    dev = best_idx.device
    lead, n = best_idx.shape[:-1], best_idx.shape[-1]
    n_problems = math.prod(lead)
    offset = (torch.arange(n_problems, device=dev) * num_cols).reshape(lead + (1,))
    idx = (best_idx.long() + offset).reshape(-1)
    dist = best_dist.to(torch.int32).reshape(-1)
    col_min = torch.full((n_problems * num_cols,), INVALID_DIST, dtype=torch.int32, device=dev)
    col_min = col_min.scatter_reduce(0, idx, dist, reduce="amin")
    is_min = dist == col_min[idx]
    rows = torch.arange(n, dtype=torch.int32, device=dev).repeat(n_problems)
    row_of_min = torch.full((n_problems * num_cols,), n, dtype=torch.int32, device=dev)
    row_of_min = row_of_min.scatter_reduce(
        0, idx, torch.where(is_min, rows, n), reduce="amin"
    )
    return (is_min & (row_of_min[idx] == rows)).reshape(best_idx.shape)
