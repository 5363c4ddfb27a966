"""Per-frame tracking: projection matching + robust pose refinement.

Port of `ucoslam_tpu/slam/tracker.py` (`_track_step` and `Tracker.track`).
Each track attempt runs the two-stage track: a wide match from the prior,
motion-only LM, a re-match from the refined pose at half the radius, and a
final refine, so kernels B1 and B2 each launch twice per attempt on the card.
Relocalization is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ucoslam_tpu_torch.config import Params
from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.mapping.frame import Frame, fetch_to_host
from ucoslam_tpu_torch.mapping.map import Map, MapState
from ucoslam_tpu_torch.matching.projection import match_points_to_frame
from ucoslam_tpu_torch.optim.pnp import motion_only_lm

#: marker-corner rows appended to the motion-only LM (4 per frame marker);
#: zero and invalid until markers are ported, kept so B2 sees the same B
MK_ROWS = 64


@dataclass
class TrackResult:
    ok: bool
    pose_f2g: np.ndarray  # (4, 4) host copy
    frame: Frame  # with ids assigned for the inlier matches
    n_matches: int
    n_inliers: int
    matched_point_slots: np.ndarray  # (n,) int32 slots of the inlier points
    vis_mask: torch.Tensor | None = None  # (P,) bool points searched this frame
    seen_mask: torch.Tensor | None = None  # (P,) bool points matched as inliers
    host_ids: np.ndarray | None = None  # (N,) int32
    host_depth: np.ndarray | None = None  # (N,) float32
    host_valid: np.ndarray | None = None  # (N,) bool


def _track_step(
    state: MapState,
    frame: Frame,
    cam: CameraParams,
    prior: torch.Tensor,  # (4, 4)
    proj_dist_thr: float,
    max_desc_dist: float,
    scale_factor: float,
    mk_X: torch.Tensor,  # (MK_ROWS, 3) marker-corner world points
    mk_uv: torch.Tensor,  # (MK_ROWS, 2) observed undistorted corners
    mk_valid: torch.Tensor,  # (MK_ROWS,) bool
    use_depth: bool = False,  # stereo/RGB-D rows in the LM
):
    """Match the active map points against the frame and refine the pose.

    -> (pose, ids (N,), inlier (P,), n_matched, n_inliers, vis (P,), seen (P,)),
    all tensors on the state's device.
    """
    dev = state.pt_pos.device
    P, n = state.P, frame.n
    pt_slots = torch.arange(P, dtype=torch.int32, device=dev)
    log_sf = torch.log(torch.tensor(scale_factor, dtype=torch.float32, device=dev))
    sigma2 = torch.exp(2.0 * frame.octave.to(torch.float32) * log_sf)

    def match_and_refine(pose0, thr, iters, rounds):
        m = match_points_to_frame(
            state.pt_pos, state.pt_desc, state.pt_normal, state.pt_min_dist,
            state.pt_max_dist, state.pt_active, frame, cam, pose0, thr,
            max_desc_dist, scale_factor,
        )
        # compact to KEYPOINT-major rows before the LM (N rows, not P)
        safe_k = torch.where(m.point_valid, m.kpt_idx, n).long()
        pt_of_kpt = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
        pt_of_kpt = pt_of_kpt.scatter(0, safe_k, pt_slots)[:n]
        obs_valid = pt_of_kpt >= 0
        X = state.pt_pos[pt_of_kpt.clamp(min=0).long()]
        # marker weight balancing (w_markers = 0.3 of the total edge mass)
        kp_w = torch.where(obs_valid, 1.0 / sigma2, 0.0).sum()
        n_mk = mk_valid.reshape(-1, 4).any(1).sum().to(torch.float32)
        total_e = m.n_matched.to(torch.float32) + n_mk
        w_mk = (0.3 * total_e / 0.7) / kp_w.clamp(min=1e-6)
        sigma2_mk = 1.0 / w_mk.clamp(min=1e-9)
        X_all = torch.cat([X, mk_X])
        uv_all = torch.cat([frame.und_xy, mk_uv])
        sig_all = torch.cat([sigma2, sigma2_mk.expand(MK_ROWS)])
        valid_all = torch.cat([obs_valid, mk_valid])
        depth_all = bf = None
        if use_depth:
            depth_all = torch.cat([frame.depth, torch.zeros(MK_ROWS, device=dev)])
            bf = cam.bl * cam.fx
        res = motion_only_lm(
            pose0, X_all, uv_all, sig_all, valid_all, cam,
            depth=depth_all, bf=bf, iters=iters, rounds=rounds,
        )
        return m, pt_of_kpt, obs_valid, res

    # two-stage track: wide association from the prior, then a re-match from
    # the refined pose at a tight radius and a final refine
    _, _, _, res0 = match_and_refine(prior, torch.tensor(proj_dist_thr, device=dev), 10, 4)
    thr2 = torch.tensor(max(0.5 * np.float32(proj_dist_thr), 6.0), dtype=torch.float32, device=dev)
    m, pt_of_kpt, obs_valid, res = match_and_refine(res0.pose_f2g, thr2, 10, 2)
    inlier_kpt = res.inliers[:n] & obs_valid
    ids = torch.where(inlier_kpt, pt_of_kpt, -1)
    # inlier keypoints -> point slots (the seen-counter mask)
    safe_p = torch.where(inlier_kpt, pt_of_kpt, P).long()
    inlier = torch.zeros(P + 1, dtype=torch.bool, device=dev)
    inlier = inlier.scatter(0, safe_p, True)[:P]
    return res.pose_f2g, ids, inlier, m.n_matched, inlier_kpt.sum(), m.point_valid, inlier


class Tracker:
    def __init__(self, params: Params, cam: CameraParams, device):
        self.params = params
        self.cam = cam
        self.device = torch.device(device)
        self.n_attempts = 0  # _track_step calls (each launches B1 and B2 twice)
        self._zero_mk = (
            torch.zeros(MK_ROWS, 3, device=self.device),
            torch.zeros(MK_ROWS, 2, device=self.device),
            torch.zeros(MK_ROWS, dtype=torch.bool, device=self.device),
        )

    def _step(self, world_map: Map, frame: Frame, prior: torch.Tensor, thr: float):
        self.n_attempts += 1
        p = self.params
        return _track_step(
            world_map.state, frame, self.cam, prior, thr, float(p.maxDescDistance),
            float(p.scaleFactor), *self._zero_mk, use_depth=self.cam.bl > 0,
        )

    def track(self, world_map: Map, frame: Frame, prior: torch.Tensor) -> TrackResult:
        p = self.params
        pose, ids, inlier, n_matched, n_inliers, vis, seen = self._step(
            world_map, frame, prior, float(p.projDistThr)
        )
        # ONE bundled transfer for everything the host control flow needs
        # (the keyframe policy and insertion read the frame's depth/valid)
        pose_np, ids_np, inlier_np, n_matched_np, n_inl, depth_np, valid_np = fetch_to_host(
            pose, ids, inlier, n_matched, n_inliers, frame.depth, frame.valid
        )
        n_inl = int(n_inl)
        if n_inl < 15:
            # one retry with a widened search radius
            pose, ids, inlier, n_matched, n_inliers, vis, seen = self._step(
                world_map, frame, prior, float(p.projDistThr * 2.5)
            )
            pose_np, ids_np, inlier_np, n_matched_np, n_inl = fetch_to_host(
                pose, ids, inlier, n_matched, n_inliers
            )
            n_inl = int(n_inl)
        ok = n_inl >= 15
        return TrackResult(
            ok=ok,
            pose_f2g=pose_np,
            frame=frame.replace(ids=ids, pose_f2g=pose),
            n_matches=int(n_matched_np),
            n_inliers=n_inl,
            matched_point_slots=np.nonzero(inlier_np)[0].astype(np.int32),
            vis_mask=vis if ok else None,
            seen_mask=seen if ok else None,
            host_ids=ids_np,
            host_depth=depth_np,
            host_valid=valid_np,
        )

    def relocalize(self, world_map: Map, frame: Frame) -> TrackResult:
        raise NotImplementedError(
            "relocalization is not ported yet (ROADMAP.md, Queue 1 item 2: relocalization "
            "- kfmatch, pnp_ransac)"
        )
