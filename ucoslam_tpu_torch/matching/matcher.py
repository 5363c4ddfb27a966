"""Frame-to-frame descriptor matching with ratio, orientation and epipolar gates.

Port of `ucoslam_tpu/matching/matcher.py` (`match_frames`,
`match_frames_epipolar`, `match_frames_bow`): one dense Hamming matrix,
Lowe's ratio test, the rotation-consistency histogram (3 dominant bins), and
one query per train column. `match_frames_epipolar` also takes a batch of
train frames along a leading axis (the mapper's covisible neighbours, all in
one pass); `match_frames_bow` admits only pairs quantized to the same
vocabulary word. Ties go to the lowest index everywhere, as in the reference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ucoslam_tpu_torch.config import CHI2_1D
from ucoslam_tpu_torch.geometry.epipolar import epipolar_line_sq_dist
from ucoslam_tpu_torch.mapping.frame import Frame
from ucoslam_tpu_torch.mapping.kfdatabase import quantize_words
from ucoslam_tpu_torch.ops.fast import stable_topk
from ucoslam_tpu_torch.ops.hamming import (
    INVALID_DIST,
    filter_ambiguous_train_sized,
    hamming_matrix,
    match_best2,
)

N_ROT_BINS = 30  # orientation consistency histogram bins (as ORB-SLAM)


@dataclass
class FrameMatches:
    train_idx: torch.Tensor  # (..., N1) int32 match in frame 2 per frame-1 kpt, -1 none
    dist: torch.Tensor  # (..., N1) int32 descriptor distance
    valid: torch.Tensor  # (..., N1) bool
    n_matches: torch.Tensor  # (...) matches


def _rotation_consistency(angle1, angle2, train_idx, valid):
    """Keep only matches whose angle difference falls in the 3 dominant
    histogram bins; angle2 (..., N2) is gathered by train_idx (..., N1)."""
    diff = angle1 - torch.gather(angle2, -1, train_idx.long())
    two_pi = torch.tensor(2.0 * math.pi, dtype=torch.float32, device=diff.device)
    diff = torch.fmod(diff, two_pi)  # floor modulo, computed as jnp.mod does
    diff = torch.where((diff != 0) & (diff < 0), diff + two_pi, diff)
    bins = (diff / two_pi * N_ROT_BINS).to(torch.int32).clamp(0, N_ROT_BINS - 1)
    hist = torch.zeros(valid.shape[:-1] + (N_ROT_BINS,), dtype=torch.int32, device=diff.device)
    hist = hist.scatter_add(-1, torch.where(valid, bins, 0).long(), valid.to(torch.int32))
    _, top3 = stable_topk(hist, 3)  # lowest bin first among equal counts
    in_top = (bins[..., :, None] == top3[..., None, :]).any(-1)
    return valid & in_top


def _accept(idx, best, second, v1, angle1, angle2, max_desc_dist, nn_ratio, check_rotation, n2):
    accept = (best <= max_desc_dist) & (best.to(torch.float32) < nn_ratio * second.to(torch.float32)) & v1
    if check_rotation:
        accept = _rotation_consistency(angle1, angle2, idx, accept)
    keep = filter_ambiguous_train_sized(idx, torch.where(accept, best, INVALID_DIST), n2)
    accept = accept & keep
    return FrameMatches(
        train_idx=torch.where(accept, idx.to(torch.int32), -1),
        dist=best,
        valid=accept,
        n_matches=accept.sum(-1),
    )


def match_frames(
    f1: Frame,
    f2: Frame,
    max_desc_dist: float,
    nn_ratio: float = 0.8,
    only_unassigned_1: bool = False,
    only_unassigned_2: bool = False,
    check_rotation: bool = True,
    max_octave_diff: int = 2,
) -> FrameMatches:
    """MODE_ALL / MODE_UNASSIGNED matching."""
    d = hamming_matrix(f1.desc, f2.desc)
    v1, v2 = f1.valid, f2.valid
    if only_unassigned_1:
        v1 = v1 & (f1.ids < 0)
    if only_unassigned_2:
        v2 = v2 & (f2.ids < 0)
    oct_ok = (f1.octave[:, None] - f2.octave[None, :]).abs() <= max_octave_diff
    idx, best, second = match_best2(d, valid_rows=v1, valid_cols=v2, extra_mask=oct_ok)
    return _accept(
        idx, best, second, v1, f1.angle, f2.angle, max_desc_dist, nn_ratio, check_rotation, f2.n
    )


def match_frames_epipolar(
    f1: Frame,
    f2: Frame,
    F12: torch.Tensor,  # (..., 3, 3) fundamental matrix, x2^T F12 x1 = 0
    sigma2_2: torch.Tensor,  # (..., N2) per-kpt variance in frame 2
    max_desc_dist: float,
    nn_ratio: float = 0.8,
    only_unassigned: bool = True,
) -> FrameMatches:
    """Epipolar-gated matching for triangulating new points. f2's tensors
    (and F12, sigma2_2) may carry a leading batch axis of train frames."""
    d = hamming_matrix(f1.desc, f2.desc)
    v1, v2 = f1.valid, f2.valid
    if only_unassigned:
        v1 = v1 & (f1.ids < 0)
        v2 = v2 & (f2.ids < 0)
    epi = epipolar_line_sq_dist(F12, f1.und_xy, f2.und_xy)  # (..., N1, N2)
    epi_ok = epi < CHI2_1D * sigma2_2[..., None, :]
    idx, best, second = match_best2(d, valid_rows=v1, valid_cols=v2, extra_mask=epi_ok)
    v1 = v1.expand(idx.shape)
    return _accept(
        idx, best, second, v1, f1.angle, f2.angle.expand(idx.shape[:-1] + f2.angle.shape[-1:]),
        max_desc_dist, nn_ratio, True, f2.desc.shape[-2],
    )


def match_frames_bow(
    f1: Frame,
    f2: Frame,
    vocab: torch.Tensor,  # (V, 8) int32 vocabulary words
    max_desc_dist: float,
    nn_ratio: float = 0.8,
    check_rotation: bool = True,
) -> FrameMatches:
    """Word-aligned matching: only descriptor pairs quantized to the same
    vocabulary word are candidates (the fBow2 node-aligned iteration as an
    equality mask over word ids)."""
    word_ok = quantize_words(f1.desc, vocab)[:, None] == quantize_words(f2.desc, vocab)[None, :]
    idx, best, second = match_best2(
        hamming_matrix(f1.desc, f2.desc), valid_rows=f1.valid, valid_cols=f2.valid, extra_mask=word_ok
    )
    return _accept(idx, best, second, f1.valid, f1.angle, f2.angle, max_desc_dist, nn_ratio, check_rotation, f2.n)
