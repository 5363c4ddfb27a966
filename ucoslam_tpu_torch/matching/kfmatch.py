"""Frame <-> candidate-keyframe matching with geometric (PnP) verification.

Port of `ucoslam_tpu/matching/kfmatch.py`, shared by relocalization and
keypoint loop detection: per candidate keyframe, the frame's descriptors are
matched against the map points that keyframe observes (padded to the frame's
keypoint capacity, so the cost is O(candidates x N^2), whatever the map's
size) and the matches are verified by PnP RANSAC.

The batch is the real candidates, C = len(cands) <= max_cands, not the
reference's padded 5 (padded rows give no candidate). All C refines are one
batched launch of kernel B2 on the card. The RANSAC rows are drawn by the
caller's `draw(valid (C, B) bool ndarray, n_hypotheses) -> (C, H, 6)`
(`optim.pnp.draw_rows` over its Generator; a test hands the reference's own
draws through it).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ucoslam_tpu_torch.config import Params
from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.mapping.frame import Frame, fetch_to_host
from ucoslam_tpu_torch.mapping.map import Map
from ucoslam_tpu_torch.ops.hamming import INVALID_DIST, filter_ambiguous_train_sized, hamming_matrix, match_best2
from ucoslam_tpu_torch.optim.pnp import pnp_ransac

Draw = Callable[[np.ndarray, int], np.ndarray]


class CandidateMatch(NamedTuple):
    ok: bool
    pose_f2g: np.ndarray | None  # (4, 4) verified pose
    n_matches: int
    n_inliers: int


def _match_candidate(pt_desc, row_valid, frame_desc, frame_valid, max_desc_dist: float):
    """Best-2 ratio matching of candidate points (..., cap, 8) against the
    frame's keypoints, one point per keypoint. -> (idx, accept, n_accept)."""
    d = hamming_matrix(pt_desc, frame_desc)
    idx, best, second = match_best2(d, valid_rows=row_valid, valid_cols=frame_valid)
    accept = (best <= max_desc_dist) & (best.to(torch.float32) < 0.75 * second.to(torch.float32))
    keep = filter_ambiguous_train_sized(idx, torch.where(accept, best, INVALID_DIST), frame_desc.shape[0])
    accept = accept & keep
    return idx, accept, accept.sum(-1)


def _candidate_rows(world_map: Map, cands: list[int]):
    """-> (slots (C, cap) int64 tensor, row_valid (C, cap) bool tensor): the
    point slots each candidate observes, padded to the frame capacity."""
    st = world_map.state
    cap = st.N
    kf_ids = world_map.h("kf_ids")
    slots = np.zeros((len(cands), cap), np.int64)
    n_sel = np.zeros(len(cands), np.int64)
    for ci, cand in enumerate(cands):
        ids = kf_ids[cand]
        sel = ids[ids >= 0][:cap]
        n_sel[ci] = len(sel)
        slots[ci, : len(sel)] = sel
    dev = world_map.device
    row_valid = np.arange(cap)[None, :] < n_sel[:, None]
    return torch.from_numpy(slots).to(dev), torch.from_numpy(row_valid).to(dev)


def match_keyframe_points_pnp_batch(
    world_map: Map,
    frame: Frame,
    cands: list[int],
    cam: CameraParams,
    params: Params,
    draw: Draw,
    min_matches: int = 25,
    min_inliers: int = 20,
    max_cands: int = 5,
) -> list[CandidateMatch]:
    """Verify the first `max_cands` candidates in one batch (one launch of
    B2 for all their refines)."""
    cands = list(cands)[:max_cands]
    if not cands:
        return []
    slots, row_valid = _candidate_rows(world_map, cands)
    st = world_map.state
    idx, accept, n_acc = _match_candidate(
        st.pt_desc[slots], row_valid, frame.desc, frame.valid, float(np.float32(params.maxDescDistance))
    )
    safe = torch.where(accept, idx, 0)
    uv = frame.und_xy[safe]
    log_sf = torch.log(torch.tensor(params.scaleFactor, dtype=torch.float32, device=uv.device))
    sigma2 = torch.exp(2.0 * frame.octave[safe].to(torch.float32) * log_sf)
    sample_idx = torch.from_numpy(draw(accept.cpu().numpy(), params.ransacIters)).to(uv.device)
    res = pnp_ransac(st.pt_pos[slots], uv, sigma2, accept, cam, sample_idx)
    n_acc, n_inl, poses = fetch_to_host(n_acc, res.n_inliers, res.pose_f2g)
    out = []
    for ci in range(len(cands)):
        ok = int(n_acc[ci]) >= min_matches and int(n_inl[ci]) >= min_inliers
        out.append(CandidateMatch(ok, poses[ci].astype(np.float32) if ok else None, int(n_acc[ci]), int(n_inl[ci])))
    return out


def match_keyframe_points_pnp(
    world_map: Map,
    frame: Frame,
    cand: int,
    cam: CameraParams,
    params: Params,
    draw: Draw,
    min_matches: int = 25,
    min_inliers: int = 20,
) -> CandidateMatch:
    """Match `frame` against the map points keyframe `cand` observes and
    verify with PnP RANSAC: the batch of one."""
    if int((world_map.h("kf_ids")[cand] >= 0).sum()) < min_matches:
        return CandidateMatch(False, None, 0, 0)
    cm = match_keyframe_points_pnp_batch(world_map, frame, [cand], cam, params, draw, min_matches, min_inliers)[0]
    return cm._replace(n_inliers=0) if cm.n_matches < min_matches else cm
