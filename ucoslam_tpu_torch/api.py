"""Public facade: the UcoSlam-equivalent user-facing class.

Port of `ucoslam_tpu/api.py`: `setParams` (a fresh map, or one passed in;
`vocabulary`, a `.fbow` file for the keyframe database, e.g.
`io.fbow.default_vocab_path()`) -> `process` (monocular),
`processStereo` (a rectified pair; `io.stereorectify.StereoRectify` makes
one from a calibrated rig) or `processRGBD` (an image and its raw depth) per
frame -> `saveToFile` (map, tracker state, keyframe database, extractor
sensitivity); `readFromFile` restores all of it; `setMode`,
`updateParams`, `resetTracker` (the next frame relocalizes),
`globalOptimization` (full-map BA), the pose and signature queries,
`prefetch` (start the next image's copy to the card), `waitForFinished`
(drain the mapping worker of `runSequential=False`) and `clear` (stop it).
With `detectMarkers` (the default) `setParams` and `readFromFile` build the
native ArUco detector from the `aruco_*` parameters and raise when it cannot
be built.
"""

from __future__ import annotations

import numpy as np

from ucoslam_tpu_torch.config import Mode, Params, TrackingState
from ucoslam_tpu_torch.features.frame_extractor import FrameExtractor
from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.io.serialize import load_map, load_map_extra_arrays, load_map_meta, save_map
from ucoslam_tpu_torch.mapping.frame import Frame
from ucoslam_tpu_torch.mapping.kfdatabase import KeyFrameDataBase
from ucoslam_tpu_torch.mapping.map import Map
from ucoslam_tpu_torch.markers.detector import ArucoDetector
from ucoslam_tpu_torch.optim.ba import global_bundle_adjustment
from ucoslam_tpu_torch.slam.system import System
from ucoslam_tpu_torch.utils.timers import timers


def build_marker_detector_from_params(params: Params, device="cuda") -> ArucoDetector | None:
    """The marker detector the `aruco_*` parameters describe, or None when
    `detectMarkers` is off; shared by setParams and readFromFile. Raises
    when the native detector cannot be built, and ValueError for a
    dictionary the reference cannot resolve either."""
    if not params.detectMarkers:
        return None
    return ArucoDetector(
        dictionary=params.aruco_Dictionary, marker_size=params.aruco_markerSize,
        detection_mode=params.aruco_DetectionMode,
        min_marker_size=params.aruco_minMarkerSize, device=device,
    )


class UcoSlam:
    def __init__(self, device="cuda"):
        self.device = device
        self._system: System | None = None
        self._extractor: FrameExtractor | None = None
        self._params = Params()
        self._map: Map | None = None
        self._session = timers.new_session()  # the first half of this instance's frame ids in spans

    def setParams(self, world_map: Map | None, params: Params, cam: CameraParams,
                  vocabulary: str | None = None, marker_detector=None) -> None:
        self._params = params
        self._map = world_map if world_map is not None else Map(params, device=self.device)
        self._system = System(params, cam, self._map, device=self.device)
        if marker_detector is None:
            marker_detector = build_marker_detector_from_params(params, self.device)
        self._extractor = FrameExtractor(params, cam, self.device, marker_detector)
        if vocabulary:
            self._system.manager.kfdb.load_vocabulary(vocabulary)

    def clear(self) -> None:
        """Stop the mapping worker, if any, and drop the system and the map."""
        if self._system is not None:
            self._system.shutdown()
        self._system = None
        self._map = None

    def prefetch(self, img: np.ndarray) -> None:
        """Hint that `img` is the next `process` argument: its copy to the
        card starts now and overlaps this frame's host work."""
        if self._extractor is not None:
            self._extractor.prefetch(img)

    def process(self, img: np.ndarray, fseq: int = 0) -> np.ndarray | None:
        """Monocular frame -> pose_f2g (4x4) or None when lost."""
        with timers.span("slam.process", self._session, fseq):
            return self._system.process_frame(self._extractor.process(img, fseq))

    def processStereo(self, left: np.ndarray, right: np.ndarray, fseq: int = 0) -> np.ndarray | None:
        """Rectified stereo pair (the camera's `bl` > 0) -> pose_f2g or None."""
        with timers.span("slam.process", self._session, fseq):
            return self._system.process_frame(self._extractor.process_stereo(left, right, fseq))

    def processRGBD(self, img: np.ndarray, depth: np.ndarray, fseq: int = 0) -> np.ndarray | None:
        """Image and its registered raw depth image (metres = raw x the
        camera's rgb_depthscale) -> pose_f2g or None."""
        with timers.span("slam.process", self._session, fseq):
            return self._system.process_frame(self._extractor.process_rgbd(img, depth, fseq))

    def process_frame(self, frame: Frame) -> np.ndarray | None:
        """Feed a pre-extracted Frame (the oracle path of the tests)."""
        with timers.span("slam.process", self._session, frame.fseq):
            return self._system.process_frame(frame)

    def setMode(self, mode: Mode) -> None:
        self._system.set_mode(mode)

    def updateParams(self, params: Params) -> None:
        """Change Params on a live system; reaches every component's copy."""
        self._params = params
        if self._system is not None:
            self._system.set_params(params)

    def resetTracker(self) -> None:
        self._system.reset_tracker()

    def waitForFinished(self) -> None:
        """Drain the mapping worker (async mode), raising the error a worker
        step raised; nothing is pending in sequential mode."""
        self._system.wait_for_finished()

    def globalOptimization(self, n_iters: int | None = None) -> None:
        """Full bundle adjustment over the map, after the worker drains."""
        self._system.wait_for_finished()
        global_bundle_adjustment(self._map, self._system.cam, n_iters=n_iters or self._params.baIters)

    def saveToFile(self, path: str) -> None:
        """Full session checkpoint: map, motion model, counters, keyframe
        database and extractor sensitivity, in the reference's layout (the
        mapping worker drained first)."""
        self._system.wait_for_finished()
        sysd = self._system
        meta = {
            "pose": None if sysd.pose is None else sysd.pose.tolist(),
            "prev_pose": None if sysd.prev_pose is None else sysd.prev_pose.tolist(),
            "velocity": sysd.velocity.tolist(),
            "state": int(sysd.state),
            "mode": int(sysd.mode),
            "frames_since_kf": sysd.frames_since_kf,
            "kf_counter": sysd.manager.kf_counter,
            "last_kf_inliers": sysd.last_kf_inliers,
            "metric_locked": sysd.manager.metric_locked,
            "last_kf_rot": None if sysd._last_kf_rot is None else sysd._last_kf_rot.tolist(),
            "init_failures": sysd._init_failures,
            "kfdb_dummy": sysd.manager.kfdb.dummy,
            "fast_threshold": self._fast_threshold(),
        }
        kfdb = sysd.manager.kfdb
        arrays = {
            "kfdb_word_ids": kfdb.word_ids.cpu().numpy(),
            "kfdb_word_w": kfdb.word_w.cpu().numpy(),
            "kfdb_vocab": kfdb.vocab.cpu().numpy().view(np.uint32),
        }
        if kfdb.weights is not None:
            arrays["kfdb_weights"] = kfdb.weights.cpu().numpy()
        save_map(self._map, path, extra_meta=meta, extra_arrays=arrays)

    def _fast_threshold(self) -> float | None:
        """The extractor's FAST threshold; None without an extractor or for
        the grid extractor (AKAZE, BRISK), which has none."""
        t = getattr(self._extractor and self._extractor.orb, "fast_threshold", None)
        return None if t is None else float(t)

    def readFromFile(self, path: str, cam: CameraParams) -> None:
        """Restore a session checkpoint: the map, the keyframe database and
        the tracker state (pose, velocity, state, mode, counters)."""
        self._map = load_map(path, self.device)
        params = self._params = self._map.params
        arrays = load_map_extra_arrays(path)
        meta = load_map_meta(path).get("extra", {})
        kfdb = None
        if "kfdb_vocab" in arrays:
            kfdb = KeyFrameDataBase(
                arrays["kfdb_word_ids"].shape[0] if "kfdb_word_ids" in arrays else max(self._map.keyframes.capacity, 1),
                vocab=arrays["kfdb_vocab"], weights=arrays.get("kfdb_weights"),
                dummy=bool(meta.get("kfdb_dummy", False)), device=self.device,
            )
            if "kfdb_word_ids" in arrays:  # the serialized postings
                kfdb.word_ids.copy_(kfdb.word_ids.new_tensor(arrays["kfdb_word_ids"]))
                kfdb.word_w.copy_(kfdb.word_w.new_tensor(arrays["kfdb_word_w"]))
            else:  # a legacy checkpoint: postings rebuilt from the keyframes
                st = self._map.state
                for s in self._map.keyframes.active_slots():
                    kfdb.add(int(s), st.kf_desc[int(s)], st.kf_kpt_valid[int(s)])
        sysd = self._system = System(params, cam, self._map, kfdb=kfdb, device=self.device)
        # the extractor as it was saved, the marker detector included
        self._extractor = FrameExtractor(params, cam, self.device, build_marker_detector_from_params(params, self.device))
        if meta.get("fast_threshold") is not None and hasattr(self._extractor.orb, "fast_threshold"):
            self._extractor.orb.fast_threshold = float(meta["fast_threshold"])
        if "metric_locked" in meta:
            sysd.manager.metric_locked = bool(meta["metric_locked"])
        else:
            mk_valid, kf_depth = self._map.h("mk_pose_valid", "kf_depth")
            sysd.manager.metric_locked = bool(mk_valid.any() or (kf_depth > 0).any())
        if meta.get("pose") is not None:
            sysd.pose = np.asarray(meta["pose"], np.float32)
            sysd.state = TrackingState(meta.get("state", 0))
        if meta.get("prev_pose") is not None:
            sysd.prev_pose = np.asarray(meta["prev_pose"], np.float32)
        if meta.get("velocity") is not None:
            sysd.velocity = np.asarray(meta["velocity"], np.float32)
        sysd.frames_since_kf = meta.get("frames_since_kf", 0)
        sysd.mode = Mode(meta.get("mode", 0))
        sysd.manager.kf_counter = meta.get("kf_counter", self._map.n_keyframes)
        sysd.last_kf_inliers = meta.get("last_kf_inliers", 0)
        if meta.get("last_kf_rot") is not None:
            sysd._last_kf_rot = np.asarray(meta["last_kf_rot"], np.float32)
        sysd._init_failures = meta.get("init_failures", 0)

    @property
    def map(self) -> Map:
        return self._map

    def getSignatureStr(self) -> str:
        return f"{self._system.global_signature():016x}"

    def getCurrentPose_f2g(self) -> np.ndarray | None:
        return self._system.pose
