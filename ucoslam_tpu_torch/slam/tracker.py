"""Per-frame tracking: projection matching + robust pose refinement.

Port of `ucoslam_tpu/slam/tracker.py`. Each track attempt runs the
two-stage track: a wide match from the prior, motion-only LM, a re-match from
the refined pose at half the radius, and a final refine, so kernels B1 and B2
each launch twice per attempt on the card.

Relocalization has the reference's two paths. With a keyframe database, the
BoW candidates are verified in one batch (`matching.kfmatch`: one batched
launch of B2 for their PnP refines) and the best-supported verified pose
seeds `track`. With a dummy database, the frame is matched against the whole
point arena (`_reloc_match`) and one PnP RANSAC (B2 at B = the arena's size)
seeds `track`. The RANSAC rows come from the tracker's numpy Generator,
seeded with the reference's PRNG constant, in a fixed order.

The LM of every attempt has MK_ROWS rows beyond the keypoints': the corners
of the frame's markers that have a map pose (4 rows each), fixed 3D->2D
edges weighted so that the markers carry 0.3 of the total edge mass, and
invalid zero rows where there are none. They are built on the host from the
frame's markers and the map's host mirror and uploaded in one transfer.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ucoslam_tpu_torch.config import Params
from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.mapping.frame import Frame, fetch_to_host
from ucoslam_tpu_torch.mapping.map import Map, MapState
from ucoslam_tpu_torch.markers.ippe import marker_object_points
from ucoslam_tpu_torch.matching.kfmatch import match_keyframe_points_pnp_batch
from ucoslam_tpu_torch.matching.projection import match_points_to_frame
from ucoslam_tpu_torch.ops.hamming import INVALID_DIST, filter_ambiguous_train_sized, hamming_matrix, match_best2
from ucoslam_tpu_torch.optim.pnp import draw_rows, motion_only_lm, pnp_ransac
from ucoslam_tpu_torch.utils.timers import timers

#: marker-corner rows appended to the motion-only LM (4 per frame marker)
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
        with timers.span("tracking.project_match"):
            m = match_points_to_frame(
                state.pt_pos, state.pt_desc, state.pt_normal, state.pt_min_dist,
                state.pt_max_dist, state.pt_active, frame, cam, pose0, thr,
                max_desc_dist, scale_factor,
            )
        with timers.span("tracking.refine"):
            return refine(m, pose0, iters, rounds)

    def refine(m, pose0, iters, rounds):
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
            # float32(fx) x float32(bl) in float32; the reference's
            # cam.bl * cam.fx is the same product (JAX takes the Python bl
            # as float32), e.g. exactly 125 for fx 500 and bl 0.25
            bf = cam.bf
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


def _reloc_match(state: MapState, frame: Frame, max_desc_dist: float):
    """Brute-force 3D-2D matches for relocalization: every active map point
    against every keypoint (P x N Hamming distances), best-2 ratio 0.75, one
    point per keypoint. -> (kpt_idx (P,), valid (P,))."""
    d = hamming_matrix(state.pt_desc, frame.desc)
    idx, best, second = match_best2(d, valid_rows=state.pt_active, valid_cols=frame.valid)
    accept = (best <= max_desc_dist) & (best.to(torch.float32) < 0.75 * second.to(torch.float32))
    keep = filter_ambiguous_train_sized(idx, torch.where(accept, best, INVALID_DIST), frame.n)
    return torch.where(accept & keep, idx, -1), accept & keep


class Tracker:
    def __init__(self, params: Params, cam: CameraParams, device):
        self.params = params
        self.cam = cam
        self.device = torch.device(device)
        self.n_attempts = 0  # _track_step calls (each launches B1 and B2 twice)
        self.n_relocalizations = 0  # relocalize calls
        self._rng = np.random.default_rng(0xC0FFEE)  # RANSAC rows, in call order
        self._zero_mk = (
            torch.zeros(MK_ROWS, 3, device=self.device),
            torch.zeros(MK_ROWS, 2, device=self.device),
            torch.zeros(MK_ROWS, dtype=torch.bool, device=self.device),
        )

    def _marker_rows(self, world_map: Map, frame: Frame):
        """Fixed 3D->2D corner rows of the frame's markers whose map pose is
        known: (X (MK_ROWS, 3), uv (MK_ROWS, 2), valid (MK_ROWS,))."""
        mk = frame.markers
        if not self.params.detectMarkers or not mk.valid.any():
            return self._zero_mk
        map_ids, pose_valid, mk_pose, mk_size = world_map.h("mk_id", "mk_pose_valid", "mk_pose", "mk_size")
        rows = np.zeros((MK_ROWS, 6), np.float32)  # X, uv, valid: one upload
        k = 0
        for i in np.nonzero(mk.valid)[0]:
            sel = np.nonzero((map_ids == mk.id[i]) & pose_valid)[0]
            if not len(sel) or k + 4 > MK_ROWS:
                continue
            s = int(sel[0])
            obj = marker_object_points(np.float32(mk_size[s])).numpy()
            rows[k : k + 4, :3] = obj @ mk_pose[s][:3, :3].T + mk_pose[s][:3, 3]
            rows[k : k + 4, 3:5] = mk.und_corners[i]
            rows[k : k + 4, 5] = 1.0
            k += 4
        if k == 0:
            return self._zero_mk
        rows = torch.from_numpy(rows).to(self.device)
        return rows[:, :3].contiguous(), rows[:, 3:5].contiguous(), rows[:, 5] > 0

    def _step(self, world_map: Map, frame: Frame, prior: torch.Tensor, thr: float, mk_rows):
        self.n_attempts += 1
        p = self.params
        return _track_step(
            world_map.state, frame, self.cam, prior, thr, float(p.maxDescDistance),
            float(p.scaleFactor), *mk_rows, use_depth=self.cam.bl > 0,
        )

    def track(self, world_map: Map, frame: Frame, prior: torch.Tensor) -> TrackResult:
        with timers.span("tracking.track"):
            return self._track(world_map, frame, prior)

    def _track(self, world_map: Map, frame: Frame, prior: torch.Tensor) -> TrackResult:
        p = self.params
        mk_rows = self._marker_rows(world_map, frame)
        pose, ids, inlier, n_matched, n_inliers, vis, seen = self._step(
            world_map, frame, prior, float(p.projDistThr), mk_rows
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
                world_map, frame, prior, float(p.projDistThr * 2.5), mk_rows
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

    def _draw(self, valid: np.ndarray, n_hypotheses: int) -> np.ndarray:
        return draw_rows(self._rng, valid, n_hypotheses)

    def _lost(self, frame: Frame) -> TrackResult:
        return TrackResult(False, None, frame, 0, 0, np.zeros(0, np.int32))

    def relocalize(self, world_map: Map, frame: Frame, kfdb=None) -> TrackResult:
        """Relocalize a lost tracker: through the keyframe database's BoW
        candidates when there is a real one, else by brute force against
        the whole point arena (module docstring)."""
        with timers.span("tracking.relocalize"):
            return self._relocalize(world_map, frame, kfdb)

    def _relocalize(self, world_map: Map, frame: Frame, kfdb) -> TrackResult:
        self.n_relocalizations += 1
        p = self.params
        if kfdb is not None and not kfdb.dummy:
            cands = kfdb.relocalization_candidates(
                frame.desc, frame.valid, world_map.keyframes.active, covis=world_map.covis_matrix()
            )
            with timers.span("tracking.ransac"):
                cms = match_keyframe_points_pnp_batch(
                    world_map, frame, cands, self.cam, p, self._draw, min_matches=20, min_inliers=15
                )
            # the best-supported verified pose first
            for cm in sorted(cms, key=lambda c: -c.n_inliers):
                if cm.ok:
                    res = self.track(world_map, frame, torch.from_numpy(cm.pose_f2g).to(self.device))
                    if res.ok:
                        return res
            return self._lost(frame)
        st = world_map.state
        kpt_idx, valid = _reloc_match(st, frame, float(np.float32(p.maxDescDistance)))
        safe = torch.where(valid, kpt_idx, 0)
        uv = frame.und_xy[safe]
        log_sf = torch.log(torch.tensor(p.scaleFactor, dtype=torch.float32, device=self.device))
        sigma2 = torch.exp(2.0 * frame.octave[safe].to(torch.float32) * log_sf)
        with timers.span("tracking.ransac"):
            sample_idx = torch.from_numpy(self._draw(valid.cpu().numpy(), p.ransacIters)).to(self.device)
            res = pnp_ransac(st.pt_pos, uv, sigma2, valid, self.cam, sample_idx)
            n_inliers = int(res.n_inliers)
        if n_inliers < 20:
            return self._lost(frame)
        # refine with projection tracking from the RANSAC pose
        return self.track(world_map, frame, res.pose_f2g)
