"""Map bootstrapping from two views, from depth or from markers.

Port of `ucoslam_tpu/slam/initializer.py`. The keypoint path matches the
reference frame against the current one, runs the F and H hypotheses,
recovers the motion, triangulates, and normalizes the scale to median scene
depth 1. The hypotheses' rows are drawn on the host from a numpy generator
seeded 0x1717 (the reference's PRNG key), uniformly among the valid
matches, and handed to `estimate_two_view`, so the card and the CPU draw
the same hypotheses. `reseed_two_view` seeds a fresh map segment the same
way after a long tracking loss. The marker path (`initialize_from_markers`)
seeds a metric map from one unambiguous marker view, or from a marker seen
in the reference and the current frame; `marker_metric_scale` gives a
keypoint init its metric baseline from a marker seen in both frames. A
stereo or RGB-D frame seeds a metric map alone (`initialize_from_depth`).
"""

from __future__ import annotations

import numpy as np
import torch

from ucoslam_tpu_torch.config import Params
from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.geometry.twoview import estimate_two_view, reconstruct_two_view
from ucoslam_tpu_torch.mapping.frame import Frame, fetch_to_host
from ucoslam_tpu_torch.mapping.map import FLAG_STEREO, Map
from ucoslam_tpu_torch.matching.matcher import match_frames
from ucoslam_tpu_torch.slam.markermap import _reproj_corner_err, record_marker_observations, resolve_marker_slots

#: F/H hypotheses drawn per attempt (the reference's default n_hypotheses)
N_HYPOTHESES = 256


def _min_max_dist(dist: np.ndarray, octave: np.ndarray, params: Params):
    """MapPoint scale-invariance bounds from creation distance + octave."""
    sf = params.scaleFactor
    max_d = dist * (sf**octave)
    min_d = max_d / (sf ** (params.nOctaveLevels - 1))
    return min_d, max_d


def _view_normals(pts_w: np.ndarray, pose_f2g: np.ndarray) -> np.ndarray:
    R, t = pose_f2g[:3, :3], pose_f2g[:3, 3]
    rays = pts_w - (-R.T @ t)
    return (rays / np.linalg.norm(rays, axis=1, keepdims=True).clip(1e-9)).astype(np.float32)


class MapInitializer:
    """Two-view bootstrap writing directly into a Map."""

    def __init__(self, params: Params, cam: CameraParams):
        self.params = params
        self.cam = cam
        self.ref_frame: Frame | None = None
        self._rng = np.random.default_rng(0x1717)

    def set_reference_frame(self, frame: Frame) -> None:
        self.ref_frame = frame

    def initialize_from_depth(self, frame: Frame, world_map: Map) -> bool:
        """One-frame bootstrap from per-keypoint depth (stereo/RGB-D): each
        valid keypoint with depth becomes a FLAG_STEREO point, unprojected at
        the identity pose, and the frame the first keyframe. False, the map
        untouched, with fewer than 100 such keypoints. One device->host
        fetch."""
        depth, valid, cam_pts, octave, desc = fetch_to_host(
            frame.depth, frame.valid, self.cam.unproject(frame.und_xy, frame.depth), frame.octave, frame.desc
        )
        valid = valid & (depth > 0)
        if int(valid.sum()) < 100:
            return False
        idx = np.nonzero(valid)[0]  # the camera is the world for the first keyframe
        min_d, max_d = _min_max_dist(np.linalg.norm(cam_pts[idx], axis=1), octave[idx], self.params)
        slots = world_map.add_points(
            pos=cam_pts[idx],
            normal=_view_normals(cam_pts[idx], np.eye(4, dtype=np.float32)),
            desc=desc[idx],
            min_dist=min_d,
            max_dist=max_d,
            flags=np.full(len(idx), FLAG_STEREO, np.int32),
            creation_kf=0,
        )
        ids = np.full(frame.n, -1, np.int32)
        ids[idx] = slots
        dev = frame.und_xy.device
        world_map.add_keyframe(frame.replace(ids=torch.from_numpy(ids).to(dev),
                                             pose_f2g=torch.eye(4, dtype=torch.float32, device=dev)))
        return True

    def initialize_from_markers(self, frame: Frame, world_map: Map):
        """Marker bootstrap with real scale: one frame when a marker is
        unambiguous (err_ratio > aruco_minerrratio_valid) and
        aruco_allowOneFrameInitialization, else two frames, the IPPE
        ambiguity resolved across the reference and the current view.
        -> (ok, cur_frame); on success the map holds the keyframe(s) and
        the marker's pose."""
        p = self.params
        mk = frame.markers
        if not mk.valid.any():
            return False, frame
        dev = frame.und_xy.device
        eye = torch.eye(4, dtype=torch.float32, device=dev)
        size = p.aruco_markerSize

        if p.aruco_allowOneFrameInitialization:
            good = np.nonzero(mk.valid & (mk.err_ratio > p.aruco_minerrratio_valid))[0]
            if len(good):
                i = int(good[0])
                cur = frame.replace(pose_f2g=eye)
                slots = resolve_marker_slots(world_map, mk)
                world_map.set_markers([slots[i]], mk_pose=mk.pose1[i][None], mk_pose_valid=[True])
                record_marker_observations(world_map, world_map.add_keyframe(cur), mk, slots)
                return True, cur

        if self.ref_frame is None:
            return False, frame
        rmk = self.ref_frame.markers
        if not rmk.valid.any():
            return False, frame
        shared = [
            (int(np.nonzero(rmk.id == m)[0][0]), int(np.nonzero(mk.id == m)[0][0]))
            for m in set(rmk.id[rmk.valid]) & set(mk.id[mk.valid])
        ]
        if not shared:
            return False, frame
        ri, ci = shared[0]
        best, best_err = None, np.inf
        for g2m in (rmk.pose1[ri], rmk.pose2[ri]):  # the reference camera is the global frame
            for pose_c in (mk.pose1[ci], mk.pose2[ci]):
                T_cur = pose_c @ np.linalg.inv(g2m)
                err = _reproj_corner_err(g2m, np.eye(4, dtype=np.float32), rmk.und_corners[ri], size, self.cam) \
                    + _reproj_corner_err(g2m, T_cur, mk.und_corners[ci], size, self.cam)
                if err < best_err:
                    best, best_err = (g2m, T_cur), err
        if best is None or best_err > 4.0:
            return False, frame
        # a baseline between the two views, or an unambiguous view
        g2m, T_cur = best
        unamb = mk.err_ratio[ci] > p.aruco_minerrratio_valid or rmk.err_ratio[ri] > p.aruco_minerrratio_valid
        if float(np.linalg.norm(T_cur[:3, 3])) < p.minBaseLine * 0.5 and not unamb:
            return False, frame
        ref = self.ref_frame.replace(pose_f2g=eye)
        cur = frame.replace(pose_f2g=torch.from_numpy(T_cur.astype(np.float32)).to(dev))
        slots_r = resolve_marker_slots(world_map, rmk)
        world_map.set_markers([slots_r[ri]], mk_pose=g2m[None].astype(np.float32), mk_pose_valid=[True])
        record_marker_observations(world_map, world_map.add_keyframe(ref), rmk, slots_r)
        slots_c = resolve_marker_slots(world_map, mk)
        record_marker_observations(world_map, world_map.add_keyframe(cur), mk, slots_c)
        return True, cur

    def marker_metric_scale(self, ref_markers, cur_markers) -> tuple | None:
        """Metric baseline of a keypoint two-view init from a marker seen in
        both frames: its IPPE poses give the metric motion between them.
        -> (metric_baseline, ref marker index, g2m) or None."""
        if not (ref_markers.valid.any() and cur_markers.valid.any()):
            return None
        rids, cids = ref_markers.id, cur_markers.id
        shared = [
            (int(np.nonzero(rids == m)[0][0]), int(np.nonzero(cids == m)[0][0]))
            for m in set(rids[ref_markers.valid]) & set(cids[cur_markers.valid])
        ]
        if not shared:
            return None
        ri, ci = shared[0]
        size = self.params.aruco_markerSize
        best, best_err = None, np.inf
        for g2m in (ref_markers.pose1[ri], ref_markers.pose2[ri]):
            for pose_c in (cur_markers.pose1[ci], cur_markers.pose2[ci]):
                T_cur = pose_c @ np.linalg.inv(g2m)
                err = _reproj_corner_err(g2m, np.eye(4, dtype=np.float32), ref_markers.und_corners[ri], size,
                                         self.cam) \
                    + _reproj_corner_err(g2m, T_cur, cur_markers.und_corners[ci], size, self.cam)
                if err < best_err:
                    best, best_err = (g2m, T_cur), err
        # the sum of two per-view RMS errors must admit the detector's
        # corner noise (1-4 px on rendered markers)
        if best is None or best_err > 10.0:
            return None
        g2m, T_cur = best
        return float(np.linalg.norm(T_cur[:3, 3])), ri, g2m.astype(np.float32)

    def reseed_two_view(self, frame: Frame, world_map: Map, anchor_pose: np.ndarray, baseline_hint: float,
                        creation_kf: int):
        """Two-view init of a fresh, disconnected map segment inside the
        existing map, after unrecoverable tracking loss: the stored reference
        frame is anchored at `anchor_pose` (its dead-reckoned pose_f2g), and
        the scale set so that the two-view baseline equals `baseline_hint`
        (from the motion model). -> (status, cur_frame_with_pose, (ref slot,
        cur slot)), the slots empty unless status is "ok"."""
        if self.ref_frame is None:
            return "no_ref", frame, ()
        ref = self.ref_frame
        got = self._two_view_geometry(frame)
        if isinstance(got, str):
            return got, frame, ()
        pts, ok, pose_21, train_idx = got
        base = float(np.linalg.norm(pose_21[:3, 3]))
        if base < 1e-6:
            return "no_geometry", frame, ()
        s = float(np.clip(baseline_hint / base, 1e-3, 1e3))
        pts = pts * s
        pose_21[:3, 3] *= s
        anchor = np.asarray(anchor_pose, np.float64)
        A_inv = np.linalg.inv(anchor)  # global coordinates: X_g = anchor^-1 X_refcam
        pts_g = pts[ok] @ A_inv[:3, :3].T + A_inv[:3, 3]
        idx1 = np.nonzero(ok)[0]
        idx2 = train_idx[idx1]
        ref_octave, ref_desc = fetch_to_host(ref.octave, ref.desc)
        dist = np.linalg.norm(pts[idx1], axis=1)
        min_d, max_d = _min_max_dist(dist, ref_octave[idx1], self.params)
        slots = world_map.add_points(
            pos=pts_g.astype(np.float32),
            normal=_view_normals(pts_g, anchor.astype(np.float32)),
            desc=ref_desc[idx1],
            min_dist=min_d,
            max_dist=max_d,
            flags=np.zeros(len(idx1), np.int32),
            creation_kf=creation_kf,
        )
        ids1 = np.full(ref.n, -1, np.int32)
        ids1[idx1] = slots
        ids2 = np.full(frame.n, -1, np.int32)
        ids2[idx2] = slots
        dev = ref.und_xy.device
        pose_cur = (pose_21.astype(np.float64) @ anchor).astype(np.float32)
        ref2 = ref.replace(ids=torch.from_numpy(ids1).to(dev),
                           pose_f2g=torch.from_numpy(anchor.astype(np.float32)).to(dev))
        cur = frame.replace(ids=torch.from_numpy(ids2).to(dev), pose_f2g=torch.from_numpy(pose_cur).to(dev))
        s1 = world_map.add_keyframe(ref2)
        s2 = world_map.add_keyframe(cur)
        return "ok", cur, (s1, s2)

    def _draw_samples(self, valid: np.ndarray, device) -> torch.Tensor:
        rows = np.nonzero(valid)[0]
        idx = self._rng.choice(rows, size=(N_HYPOTHESES, 8), replace=True)
        return torch.from_numpy(idx.astype(np.int64)).to(device)

    def _two_view_geometry(self, frame: Frame):
        """Match vs the stored reference frame, H/F RANSAC, motion recovery,
        triangulation. -> an error-status string, or (points_refcam,
        point_ok, pose_21, train_idx) on the host."""
        ref = self.ref_frame
        p = self.params
        matches = match_frames(ref, frame, float(p.maxDescDistance), nn_ratio=0.9)
        n_matches, valid = fetch_to_host(matches.n_matches, matches.valid)
        if int(n_matches) < 100:
            return "few_matches"
        dev = ref.und_xy.device
        t_idx = matches.train_idx
        uv1 = ref.und_xy
        uv2 = frame.und_xy[torch.where(t_idx >= 0, t_idx, 0).long()]
        log_sf = torch.log(torch.tensor(p.scaleFactor, dtype=torch.float32, device=dev))
        sigma2 = torch.exp(2.0 * ref.octave.to(torch.float32) * log_sf)
        model = estimate_two_view(uv1, uv2, matches.valid, sigma2, self._draw_samples(valid, dev))
        rec = reconstruct_two_view(
            model, uv1, uv2, matches.valid, sigma2, self.cam, self.cam,
            min_triangulated=50, min_parallax_deg=1.0,
        )
        ok, points, point_ok, pose_21, train_idx = fetch_to_host(
            rec.ok, rec.points, rec.point_ok, rec.pose_21, t_idx
        )
        if not bool(ok):
            return "no_geometry"
        return points, point_ok, pose_21.copy(), train_idx

    def initialize_two_view(self, frame: Frame, world_map: Map):
        """Attempt a two-view init against the stored reference frame.
        -> (status, cur_frame_with_pose); status "ok" on success, else
        "no_ref" / "few_matches" / "no_geometry". On success the map holds
        two keyframes and the triangulated points, at median depth 1."""
        if self.ref_frame is None:
            return "no_ref", frame
        ref = self.ref_frame
        got = self._two_view_geometry(frame)
        if isinstance(got, str):
            return got, frame
        pts, ok, pose2, train_idx = got
        med = float(np.median(pts[ok][:, 2]))
        if med <= 1e-6:
            return "no_geometry", frame
        scale = 1.0 / med
        pts = pts * scale
        pose2[:3, 3] *= scale

        idx1 = np.nonzero(ok)[0]  # keypoint index in the reference frame
        idx2 = train_idx[idx1]
        ref_octave, ref_desc = fetch_to_host(ref.octave, ref.desc)
        octave1 = ref_octave[idx1]
        dist = np.linalg.norm(pts[idx1], axis=1)
        min_d, max_d = _min_max_dist(dist, octave1, self.params)
        slots = world_map.add_points(
            pos=pts[idx1],
            normal=_view_normals(pts[idx1], np.eye(4, dtype=np.float32)),
            desc=ref_desc[idx1],
            min_dist=min_d,
            max_dist=max_d,
            flags=np.zeros(len(idx1), np.int32),
            creation_kf=0,
        )
        ids1 = np.full(ref.n, -1, np.int32)
        ids1[idx1] = slots
        ids2 = np.full(frame.n, -1, np.int32)
        ids2[idx2] = slots
        dev = ref.und_xy.device
        ref2 = ref.replace(
            ids=torch.from_numpy(ids1).to(dev), pose_f2g=torch.eye(4, dtype=torch.float32, device=dev)
        )
        cur = frame.replace(ids=torch.from_numpy(ids2).to(dev), pose_f2g=torch.from_numpy(pose2).to(dev))
        world_map.add_keyframe(ref2)
        world_map.add_keyframe(cur)
        return "ok", cur
