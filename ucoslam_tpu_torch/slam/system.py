"""Top-level SLAM orchestration and the tracking state machine.

Port of `ucoslam_tpu/slam/system.py`: per frame, initialize from two views
while the map is empty, else track with the motion-model prior, decide on a
keyframe and hand it to the MapManager, inline in sequential mode
(`runSequential`, deterministic) or to its mapping worker in async mode;
LOCALIZATION mode tracks without mapping. In async mode a frame tracks
against a snapshot of the map taken at its head, first adopting the pose
correction the worker published for the last keyframe it mapped; a
frame that needs a keyframe waits until the worker is idle; the
point-counter bumps go to the worker, and there is no re-seed (map writes
belong to the worker). A lost frame
relocalizes (BoW candidates through the keyframe database, or brute force
for a dummy one), and when that fails the frame's markers with a map pose
give a pose to track from, or the pose itself; after
`reseedAfterLostFrames` lost SLAM frames a fresh map segment is re-seeded
from two views at the dead-reckoned pose; after a loop correction the
tracker adopts the corrected keyframe pose, and after a marker rescale of
the map it rescales its own motion model. Markers initialize the map (one
unambiguous frame, or two frames), or make a keypoint init metric (the
hybrid init); a stereo or RGB-D frame initializes a metric map alone, or
the frame stays uninitialized.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from ucoslam_tpu_torch.config import Mode, Params, TrackingState
from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.mapping.frame import Frame, fetch_to_host
from ucoslam_tpu_torch.mapping.kfdatabase import KeyFrameDataBase
from ucoslam_tpu_torch.mapping.map import Map
from ucoslam_tpu_torch.optim import ba
from ucoslam_tpu_torch.slam.initializer import MapInitializer
from ucoslam_tpu_torch.slam.mapmanager import MapManager
from ucoslam_tpu_torch.slam.markermap import best_pose_from_valid_markers, record_marker_observations, resolve_marker_slots
from ucoslam_tpu_torch.slam.tracker import TrackResult, Tracker
from ucoslam_tpu_torch.utils.timers import timers


def disable_tf32() -> None:
    """Full float32 matmuls and convolutions on the card, as the reference
    forces f32 matmuls: reduced precision made mono ATE 11x worse."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class System:
    def __init__(self, params: Params, cam: CameraParams, world_map: Map | None = None,
                 kfdb: KeyFrameDataBase | None = None, device="cuda"):
        disable_tf32()
        params = params.effective()
        self.params = params
        self.cam = cam
        self.device = torch.device(device)
        self.map = world_map if world_map is not None else Map(params, device=self.device)
        self.tracker = Tracker(params, cam, self.device)
        self.initializer = MapInitializer(params, cam)
        self.manager = MapManager(params, cam, kfdb=kfdb, device=self.device)
        if kfdb is None:
            # no serialized database came with the map: derive it
            self._add_to_kfdb(self.map.keyframes.active_slots())
        self.mode = Mode.SLAM
        self.state = TrackingState.LOST
        self.pose = None  # last pose_f2g (numpy 4x4) or None
        self.prev_pose = None
        self.velocity = np.eye(4, dtype=np.float32)  # motion-model increment
        self.frames_since_kf = 0
        self.last_kf_inliers = 0
        self._last_kf_rot = None  # rotation (3x3) of the last inserted keyframe
        self._lost_streak = 0  # consecutive lost frames (re-seed trigger)
        self._reseed_anchor = None  # dead-reckoned pose at the re-seed reference frame
        self._reseed_ref_fseq = 0
        self._dead_pose = None  # motion-model extrapolation while lost
        self._init_failures = 0
        self.n_marker_poses = 0  # lost frames the markers gave a pose to
        self.stats_log = []
        if not params.runSequential:
            if ba.ba_mesh_spans_ranks():
                raise ValueError(
                    "runSequential=False with bundle adjustment sharded over the ranks: each rank's mapping "
                    "worker would reach the collectives at its own time, on its own map; run every rank "
                    "sequentially (runSequential=True), or keep each rank's solves on its device "
                    "(optim.ba.set_ba_mesh(None))")
            self.manager.start_async(self.map)

    def _add_to_kfdb(self, slots) -> None:
        st = self.map.state
        for s in slots:
            self.manager.kfdb.add(int(s), st.kf_desc[int(s)], st.kf_kpt_valid[int(s)])

    # -- helpers --------------------------------------------------------
    def _prior(self) -> torch.Tensor:
        prior = np.eye(4, dtype=np.float32) if self.pose is None else self.velocity @ self.pose
        return torch.from_numpy(np.ascontiguousarray(prior, np.float32)).to(self.device)

    def _update_motion_model(self, new_pose: np.ndarray) -> None:
        if self.pose is not None:
            self.velocity = (new_pose @ np.linalg.inv(self.pose)).astype(np.float32)
        self.prev_pose = self.pose
        self.pose = new_pose.astype(np.float32)

    # -- main entry -----------------------------------------------------
    def process_frame(self, frame: Frame) -> np.ndarray | None:
        """Process one extracted frame; returns pose_f2g or None if lost."""
        is_async = self.manager.is_async
        if is_async:
            self._consume_map_update()
        if self.map.n_keyframes == 0:
            if self.mode == Mode.LOCALIZATION:
                return None
            with timers.span("slam.initialize"):
                return self._try_initialize(frame)

        # async: one consistent state for the whole frame, whatever the worker writes
        view = self.map.snapshot() if is_async else self.map
        if self.state == TrackingState.TRACKING:
            res = self.tracker.track(view, frame, self._prior())
        elif self.params.reLocalizationWithKeyPoints:
            res = self.tracker.relocalize(view, frame, kfdb=self.manager.kfdb)
        else:
            res = TrackResult(False, None, frame, 0, 0, np.zeros(0, np.int32))

        if not res.ok and self.params.detectMarkers and (
            self.params.reLocalizationWithMarkers or self.state == TrackingState.TRACKING
        ):
            # the pose from the observed markers with a map pose, then a
            # keypoint track from it; the marker pose itself if that fails
            mk_pose = best_pose_from_valid_markers(view, frame.markers, self.cam)
            if mk_pose is not None:
                self.n_marker_poses += 1
                retry = self.tracker.track(view, frame, torch.from_numpy(mk_pose).to(self.device))
                if retry.ok:
                    res = retry
                else:
                    pose_t = torch.from_numpy(mk_pose).to(self.device)
                    res = dataclasses.replace(res, ok=True, pose_f2g=mk_pose, frame=frame.replace(pose_f2g=pose_t))

        if not res.ok:
            self.state = TrackingState.LOST
            self._lost_streak += 1
            if self.pose is not None:
                base = self._dead_pose if self._dead_pose is not None else self.pose
                self._dead_pose = (self.velocity @ base).astype(np.float32)
            pose = self._try_reseed(frame)
            if pose is not None:
                self._log(frame, pose, self.last_kf_inliers)
                return pose
            self._log(frame, None, 0)
            return None

        self.state = TrackingState.TRACKING
        self._lost_streak = 0
        self._reseed_anchor = None
        self._dead_pose = None
        pose = np.asarray(res.pose_f2g)
        self._update_motion_model(pose)
        self.frames_since_kf += 1
        if res.vis_mask is not None:
            if is_async:
                self.manager.enqueue_stats(res.vis_mask, res.seen_mask)
            else:
                self.map.bump_point_stats(res.vis_mask, res.seen_mask)

        need_kf = self.mode == Mode.SLAM and self._need_keyframe(res)
        # running max of tracked inliers since the last keyframe, after the decision
        self.last_kf_inliers = max(self.last_kf_inliers, res.n_inliers)
        if is_async:
            if need_kf:
                # a keyframe goes to an idle worker (backpressure: MapManager)
                self.manager.wait_for_worker()
            if need_kf and self.manager.enqueue_keyframe(
                res.frame, trace_frame=timers.frame(), host_ids=res.host_ids, host_depth=res.host_depth,
                host_valid=res.host_valid,
            ):
                self.frames_since_kf = 0
                self.last_kf_inliers = max(res.n_inliers, 1)
                self._last_kf_rot = pose[:3, :3].copy()
            self._log(frame, pose, res.n_inliers)
            return pose
        if need_kf:
            self.manager.last_scale_correction = 1.0
            loops_before = self.manager.loop_closures
            with timers.span("mapping.new_keyframe"):
                kf_slot = self.manager.new_keyframe(
                    self.map, res.frame, host_ids=res.host_ids, host_depth=res.host_depth, host_valid=res.host_valid
                )
            if self.manager.loop_closures != loops_before:
                # a loop moved the world: adopt the corrected keyframe pose
                # and reset the motion model
                pose = self.map.h("kf_pose")[kf_slot].copy()
                self.pose = pose
                self.prev_pose = None
                self.velocity = np.eye(4, dtype=np.float32)
            s = self.manager.last_scale_correction
            if s != 1.0:
                # the whole world, this frame's pose included, was rescaled
                self.pose[:3, 3] *= s
                if self.prev_pose is not None:
                    self.prev_pose = self.prev_pose.copy()
                    self.prev_pose[:3, 3] *= s
                self.velocity = self.velocity.copy()
                self.velocity[:3, 3] *= s
            self.frames_since_kf = 0
            self.last_kf_inliers = max(res.n_inliers, 1)
            self._last_kf_rot = pose[:3, :3].copy()
        self._log(frame, pose, res.n_inliers)
        return pose

    def _try_reseed(self, frame: Frame) -> np.ndarray | None:
        """Fresh-segment re-seed after unrecoverable tracking loss: once
        relocalization has failed `reseedAfterLostFrames` SLAM frames in a
        row, park a reference frame at the dead-reckoned pose, then two-view
        initialize a new, disconnected map segment there. The keyframe
        database spans both segments, so a later loop can stitch them.
        -> the frame's pose, or None."""
        p = self.params
        if (
            p.reseedAfterLostFrames <= 0
            or self.mode != Mode.SLAM
            or self.manager.is_async  # map writes belong to the worker
            or self._lost_streak < p.reseedAfterLostFrames
            or self._dead_pose is None
        ):
            return None
        if self._reseed_anchor is None:
            self.initializer.set_reference_frame(frame)
            self._reseed_anchor = self._dead_pose.copy()
            self._reseed_ref_fseq = int(frame.fseq)
            return None
        gap = max(1, int(frame.fseq) - self._reseed_ref_fseq)
        baseline = max(1e-3, float(np.linalg.norm(self.velocity[:3, 3])) * gap)
        status, cur, slots = self.initializer.reseed_two_view(
            frame, self.map, self._reseed_anchor, baseline, creation_kf=self.manager.kf_counter
        )
        if status == "few_matches":
            # the scene moved past the parked reference: re-park here
            self.initializer.set_reference_frame(frame)
            self._reseed_anchor = self._dead_pose.copy()
            self._reseed_ref_fseq = int(frame.fseq)
            return None
        if status != "ok":
            return None  # low parallax so far: wait for baseline
        self._add_to_kfdb(slots)
        self.manager.kf_counter += 2
        self.state = TrackingState.TRACKING
        pose = cur.pose_f2g.cpu().numpy().astype(np.float32)
        self.pose = pose
        self.prev_pose = None
        self.velocity = np.eye(4, dtype=np.float32)
        self.frames_since_kf = 0
        self.last_kf_inliers = max(int((cur.ids >= 0).sum()), 30)
        self._last_kf_rot = pose[:3, :3].copy()
        self._lost_streak = 0
        self._reseed_anchor = None
        self._dead_pose = None
        return pose

    def _try_initialize(self, frame: Frame) -> np.ndarray | None:
        p = self.params
        has_markers = p.detectMarkers and bool(frame.markers.valid.any())
        # a marker init when keypoints are poor, one frame is allowed, or
        # markers are forced
        if has_markers and (p.forceInitializationFromMarkers or p.aruco_allowOneFrameInitialization
                            or not bool(frame.valid.any())):
            ok, cur = self.initializer.initialize_from_markers(frame, self.map)
            if ok:
                self.manager.metric_locked = True  # a marker init is metric
                return self._finish_init(frame, cur)
        if p.forceInitializationFromMarkers:
            self.initializer.set_reference_frame(frame)
            self._log(frame, None, 0)
            return None
        depth_any, n_kpts = fetch_to_host((frame.depth > 0).any(), frame.valid.sum())
        if depth_any:
            # a depth frame seeds a metric map alone; on failure no two-view
            # attempt follows
            if not self.initializer.initialize_from_depth(frame, self.map):
                return None
            self.manager.metric_locked = True
            self.state = TrackingState.TRACKING
            pose = np.eye(4, dtype=np.float32)
            self._update_motion_model(pose)
            self.manager.kf_counter = 1
            self.last_kf_inliers = int(n_kpts)
            self._last_kf_rot = pose[:3, :3].copy()
            self._add_to_kfdb(self.map.keyframes.active_slots())
            self._log(frame, pose, self.last_kf_inliers)
            return pose
        if self.initializer.ref_frame is None:
            self.initializer.set_reference_frame(frame)
            self._log(frame, None, 0)
            return None
        ref_markers = self.initializer.ref_frame.markers
        status, cur = self.initializer.initialize_two_view(frame, self.map)
        if status != "ok":
            self._init_failures += 1
            # markers alone only after the keypoint path failed repeatedly: a
            # zero-baseline marker init would beat a hybrid init a frame later
            if has_markers and self._init_failures > 5:
                ok, mcur = self.initializer.initialize_from_markers(frame, self.map)
                if ok:
                    self.manager.metric_locked = True
                    return self._finish_init(frame, mcur)
            # re-seed the reference only when the scene moved on; a geometric
            # failure usually means not enough baseline yet
            if status == "few_matches":
                self.initializer.set_reference_frame(frame)
            self._log(frame, None, 0)
            return None
        if has_markers:  # hybrid: keypoint geometry, marker metric scale
            cur = self._apply_marker_scale(ref_markers, cur)
        return self._finish_init(frame, cur)

    def _apply_marker_scale(self, ref_markers, cur: Frame) -> Frame:
        """Rescale a fresh two-view map to the metric baseline a marker seen
        in both init frames gives, register that marker (its pose in the
        reference camera's frame, which the scaling leaves in place) and
        both keyframes' marker observations. -> cur with its scaled pose."""
        got = self.initializer.marker_metric_scale(ref_markers, cur.markers)
        if got is None:
            return cur
        metric_baseline, ri, g2m = got
        T_cur = cur.pose_f2g.cpu().numpy().copy()
        map_baseline = float(np.linalg.norm(T_cur[:3, 3]))
        if map_baseline < 1e-6 or metric_baseline < 1e-6:
            return cur
        s = metric_baseline / map_baseline
        self.map.scale(s)
        self.manager.metric_locked = True  # the hybrid init is metric now
        kf_slots = self.map.keyframes.active_slots()
        slots_r = resolve_marker_slots(self.map, ref_markers)
        self.map.set_markers([slots_r[ri]], mk_pose=g2m[None], mk_pose_valid=[True])
        record_marker_observations(self.map, int(kf_slots[0]), ref_markers, slots_r)
        slots_c = resolve_marker_slots(self.map, cur.markers)
        record_marker_observations(self.map, int(kf_slots[1]), cur.markers, slots_c)
        T_cur[:3, 3] *= s
        return cur.replace(pose_f2g=torch.from_numpy(T_cur.astype(np.float32)).to(cur.pose_f2g.device))

    def _finish_init(self, frame: Frame, cur: Frame) -> np.ndarray:
        self.state = TrackingState.TRACKING
        pose = cur.pose_f2g.cpu().numpy()
        self._update_motion_model(pose)
        self.manager.kf_counter = self.map.n_keyframes
        self.last_kf_inliers = max(int((cur.ids >= 0).sum()), 30)
        self._last_kf_rot = pose[:3, :3].copy()
        # the bootstrap keyframes must be searchable in the database
        self._add_to_kfdb(self.map.keyframes.active_slots())
        self._log(frame, pose, self.last_kf_inliers)
        return pose

    def _need_keyframe(self, res: TrackResult) -> bool:
        """Keyframe policy: needed when the tracked inliers drop below
        thRefRatio x the running max since the last keyframe, when tracking
        has gone stale, when (stereo) tracked close points are scarce, or
        when the view has rotated kfRotationDeg past the last keyframe; the
        frame qualifies with >= 20 inliers at KFMinConfidence."""
        p = self.params
        if self.frames_since_kf < 1:
            return False
        ref = max(self.last_kf_inliers, 1)
        th = p.thRefRatio if self.cam.bl <= 0 else min(p.thRefRatio, 0.75)
        need = (res.n_inliers < th * ref and res.n_inliers > 15) or self.frames_since_kf >= 20
        if not need and self.cam.bl > 0:
            depth, ids, kvalid = res.host_depth, res.host_ids, res.host_valid
            if depth is None:  # a pose the markers gave: no bundled fetch came with it
                depth, ids, kvalid = fetch_to_host(res.frame.depth, res.frame.ids, res.frame.valid)
            close = (depth > 0) & (depth < 40.0 * self.cam.bl)
            tracked_close = int((close & (ids >= 0)).sum())
            creatable = int((close & (ids < 0) & kvalid).sum())
            need = tracked_close < 100 and creatable > 70
        if not need and p.kfRotationDeg > 0 and self._last_kf_rot is not None and self.pose is not None:
            dR = self.pose[:3, :3] @ self._last_kf_rot.T
            cosang = np.clip((np.trace(dR) - 1.0) / 2.0, -1.0, 1.0)
            need = np.degrees(np.arccos(cosang)) >= p.kfRotationDeg
        confidence = res.n_inliers / max(res.n_matches, 1)
        if need and res.n_inliers >= 20 and confidence >= p.KFMinConfidence:
            return True
        # marker-carried tracking (few keypoint inliers, markers in view):
        # a keyframe every few frames, so mapping can triangulate once
        # baseline appears
        return bool(p.detectMarkers and res.n_inliers < 20 and self.frames_since_kf >= 4
                    and res.frame.markers.valid.any())

    def _log(self, frame: Frame, pose, n_inliers) -> None:
        self.stats_log.append({
            "fseq": int(frame.fseq),
            "tracked": pose is not None,
            "n_inliers": n_inliers,
            "n_points": self.map.n_points,
            "n_kf": self.map.n_keyframes,
        })

    def _consume_map_update(self) -> None:
        """Adopt the pose correction the worker published: the keyframe the
        last candidate became moved (local BA, a loop, a rescale), so the
        tracker's pose moves with it. A loop or a rescale resets the motion
        model; otherwise the previous pose moves too, so the velocity holds."""
        upd = self.manager.consume_update()
        if upd is None or self.pose is None:
            return
        self.pose = (self.pose @ upd["dT"]).astype(np.float32)
        if upd["big_change"] or upd["scale"] != 1.0:
            self.prev_pose = None
            self.velocity = np.eye(4, dtype=np.float32)
        elif self.prev_pose is not None:
            self.prev_pose = (self.prev_pose @ upd["dT"]).astype(np.float32)
            self.velocity = (self.pose @ np.linalg.inv(self.prev_pose)).astype(np.float32)

    def wait_for_finished(self) -> None:
        """Drain the mapping worker (async mode), raising its error if one
        step failed, and adopt its last correction."""
        if self.manager.is_async:
            self.manager.wait_idle()
            self._consume_map_update()

    def shutdown(self) -> None:
        self.manager.stop_async()

    # -- public control -------------------------------------------------
    def set_mode(self, mode: Mode) -> None:
        self.mode = mode

    def set_params(self, params: Params) -> None:
        """Propagate a live Params change into every captured copy."""
        params = params.effective()
        self.params = params
        self.tracker.params = params
        self.initializer.params = params
        self.manager.params = params
        self.manager.loop_detector.params = params

    def reset_tracker(self) -> None:
        """Re-enter a known map."""
        self.state = TrackingState.LOST
        self.pose = None
        self.velocity = np.eye(4, dtype=np.float32)
        self._lost_streak = 0
        self._reseed_anchor = None
        self._dead_pose = None

    def global_signature(self) -> int:
        """Order-sensitive hash over map + params + tracker state (the
        reference's System.global_signature)."""
        h = hashlib.blake2b(digest_size=8)

        def upd_f(x):
            a = np.asarray(x, np.float64)
            h.update(np.round(a * 1e4).astype(np.int64).tobytes())

        h.update(self.map.signature().to_bytes(8, "little"))
        h.update(self.params.signature().to_bytes(8, "little", signed=False))
        upd_f(np.zeros((4, 4)) if self.pose is None else self.pose)
        upd_f(np.zeros((4, 4)) if self.prev_pose is None else self.prev_pose)
        upd_f(self.velocity)
        for v in (
            int(self.state), int(self.mode), self.frames_since_kf,
            self.manager.kf_counter, self.last_kf_inliers, int(self.manager.metric_locked),
        ):
            h.update(int(v).to_bytes(8, "little", signed=True))
        return int.from_bytes(h.digest(), "little")
