"""Public facade: the UcoSlam-equivalent user-facing class.

Port of part of `ucoslam_tpu/api.py`: load a checkpoint the reference wrote
(`readFromFile`), switch to LOCALIZATION (`setMode`) and serve frames
(`process`), plus the pose and signature queries. Building a map (setParams
+ SLAM mode), saving and global BA are not ported yet.
"""

from __future__ import annotations

import numpy as np

from ucoslam_tpu_torch.config import Mode, TrackingState
from ucoslam_tpu_torch.features.frame_extractor import FrameExtractor
from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.io.serialize import load_map, load_map_extra_arrays, load_map_meta
from ucoslam_tpu_torch.mapping.map import Map
from ucoslam_tpu_torch.slam.system import System


class UcoSlam:
    def __init__(self, device="cuda"):
        self.device = device
        self._system: System | None = None
        self._extractor: FrameExtractor | None = None
        self._map: Map | None = None
        self._kfdb_arrays: dict = {}

    def process(self, img: np.ndarray, fseq: int = 0) -> np.ndarray | None:
        """Monocular frame -> pose_f2g (4x4) or None when lost."""
        return self._system.process_frame(self._extractor.process(img, fseq))

    def setMode(self, mode: Mode) -> None:
        self._system.set_mode(mode)

    def readFromFile(self, path: str, cam: CameraParams) -> None:
        """Restore a session checkpoint: the map plus the tracker state
        (pose, velocity, state, mode, counters)."""
        self._map = load_map(path, self.device)
        params = self._map.params
        if params.detectMarkers:
            raise NotImplementedError(
                "marker detection is not ported yet (ROADMAP.md, Queue 1: markers)"
            )
        # the keyframe database: read, unused until relocalization is ported
        self._kfdb_arrays = load_map_extra_arrays(path)
        meta = load_map_meta(path).get("extra", {})
        sysd = self._system = System(params, cam, self._map, self.device)
        self._extractor = FrameExtractor(params, cam, self.device)
        if meta.get("fast_threshold") is not None:
            self._extractor.orb.fast_threshold = float(meta["fast_threshold"])
        if "metric_locked" in meta:
            sysd.metric_locked = bool(meta["metric_locked"])
        else:
            st = self._map.state
            sysd.metric_locked = bool(st.mk_pose_valid.any() or (st.kf_depth > 0).any())
        if meta.get("pose") is not None:
            sysd.pose = np.asarray(meta["pose"], np.float32)
            sysd.state = TrackingState(meta.get("state", 0))
        if meta.get("prev_pose") is not None:
            sysd.prev_pose = np.asarray(meta["prev_pose"], np.float32)
        if meta.get("velocity") is not None:
            sysd.velocity = np.asarray(meta["velocity"], np.float32)
        sysd.frames_since_kf = meta.get("frames_since_kf", 0)
        sysd.mode = Mode(meta.get("mode", 0))
        sysd.kf_counter = meta.get("kf_counter", self._map.n_keyframes)
        sysd.last_kf_inliers = meta.get("last_kf_inliers", 0)

    @property
    def map(self) -> Map:
        return self._map

    def getSignatureStr(self) -> str:
        return f"{self._system.global_signature():016x}"

    def getCurrentPose_f2g(self) -> np.ndarray | None:
        return self._system.pose
