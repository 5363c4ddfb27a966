"""Tracking state machine for LOCALIZATION mode.

Port of the LOCALIZATION path of `ucoslam_tpu/slam/system.py`
(`System.process_frame`): track against the loaded map with the motion-model
prior, update the motion model, bump the point statistics. SLAM mode
(initialization, keyframes, mapping, re-seeding) is not ported yet.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ucoslam_tpu_torch.config import Mode, Params, TrackingState
from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.mapping.frame import Frame
from ucoslam_tpu_torch.mapping.map import Map
from ucoslam_tpu_torch.slam.tracker import TrackResult, Tracker

NOT_PORTED_SLAM = (
    "SLAM mode is not ported yet (ROADMAP.md, Queue 1: SLAM mode - initializer, "
    "twoview, matcher, mapmanager, local BA)"
)


def disable_tf32() -> None:
    """Full float32 matmuls and convolutions on the card, as the reference
    forces f32 matmuls: reduced precision made mono ATE 11x worse."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class System:
    def __init__(self, params: Params, cam: CameraParams, world_map: Map, device="cuda"):
        disable_tf32()
        self.params = params.effective()
        self.cam = cam
        self.device = torch.device(device)
        self.map = world_map
        self.tracker = Tracker(self.params, cam, self.device)
        self.mode = Mode.SLAM
        self.state = TrackingState.LOST
        self.pose = None  # last pose_f2g (numpy 4x4) or None
        self.prev_pose = None
        self.velocity = np.eye(4, dtype=np.float32)  # motion-model increment
        self.frames_since_kf = 0
        self.last_kf_inliers = 0
        self.kf_counter = 0
        self.metric_locked = False

    def _prior(self) -> torch.Tensor:
        prior = np.eye(4, dtype=np.float32) if self.pose is None else self.velocity @ self.pose
        return torch.from_numpy(np.ascontiguousarray(prior, np.float32)).to(self.device)

    def _update_motion_model(self, new_pose: np.ndarray) -> None:
        if self.pose is not None:
            self.velocity = (new_pose @ np.linalg.inv(self.pose)).astype(np.float32)
        self.prev_pose = self.pose
        self.pose = new_pose.astype(np.float32)

    def process_frame(self, frame: Frame) -> np.ndarray | None:
        """Process one extracted frame; returns pose_f2g or None if lost."""
        if self.map.n_keyframes == 0:
            if self.mode == Mode.LOCALIZATION:
                return None
            raise NotImplementedError(NOT_PORTED_SLAM)
        if self.mode != Mode.LOCALIZATION:
            raise NotImplementedError(NOT_PORTED_SLAM)

        if self.state == TrackingState.TRACKING:
            res = self.tracker.track(self.map, frame, self._prior())
        elif self.params.reLocalizationWithKeyPoints:
            res = self.tracker.relocalize(self.map, frame)
        else:
            res = TrackResult(False, None, frame, 0, 0, np.zeros(0, np.int32))

        if not res.ok:
            self.state = TrackingState.LOST
            return None

        self.state = TrackingState.TRACKING
        pose = np.asarray(res.pose_f2g)
        self._update_motion_model(pose)
        self.frames_since_kf += 1
        if res.vis_mask is not None:
            self.map.bump_point_stats(res.vis_mask, res.seen_mask)
        self.last_kf_inliers = max(self.last_kf_inliers, res.n_inliers)
        return pose

    def set_mode(self, mode: Mode) -> None:
        self.mode = mode

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
            self.kf_counter, self.last_kf_inliers, int(self.metric_locked),
        ):
            h.update(int(v).to_bytes(8, "little", signed=True))
        return int.from_bytes(h.digest(), "little")
