"""ArUco marker detection producing FrameMarkers.

Port of `ucoslam_tpu/markers/detector.py` with the native backend only:
`ArucoDetector` finds the markers with the native C++ detector on the host
(`markers.native`, built by the port with g++), then undistorts their
corners and solves IPPE for all 16 slots at once on the device, and fetches
the corners, both poses and both errors in one device->host transfer. Every
dictionary the reference resolves runs on the native detector: the
reference's cv2-backed ones with cv2's codewords and cv2's bit-error
correction (`markers.dictionary`). The reference's keypoints-only fallback
is not ported: an unknown dictionary raises, and a detector that cannot be
built raises. `SyntheticMarkerDetector` is the
oracle of the tests and the synthetic sequences: it projects known marker
poses to corners.
"""

from __future__ import annotations

import numpy as np
import torch

from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.mapping.frame import MAX_MARKERS_PER_FRAME, FrameMarkers, empty_markers, fetch_to_host
from ucoslam_tpu_torch.markers.dictionary import resolve
from ucoslam_tpu_torch.markers.ippe import ippe_square_poses, marker_object_points
from ucoslam_tpu_torch.markers.native import detect_markers_native, load_library


def _markers_from(ids, corners: np.ndarray, und: torch.Tensor, size: float, cam: CameraParams) -> FrameMarkers:
    """FrameMarkers of the first MAX_MARKERS_PER_FRAME detections: IPPE on
    the undistorted corners `und` (M, 4, 2) on their device, then one fetch."""
    M = MAX_MARKERS_PER_FRAME
    n = min(len(ids), M)
    id_arr = np.full(M, -1, np.int32)
    id_arr[:n] = ids[:n]
    valid = np.arange(M) < n
    sizes = torch.full((M,), size, dtype=torch.float32, device=und.device)
    p1, p2, e1, e2 = ippe_square_poses(und, sizes, cam)
    und, p1, p2, e1, e2 = fetch_to_host(und, p1, p2, e1, e2)
    err_ratio = np.where(valid, e2 / np.clip(e1, 1e-9, None), 0.0).astype(np.float32)
    return FrameMarkers(id=id_arr, corners=corners, und_corners=und, pose1=p1, pose2=p2, err_ratio=err_ratio,
                        valid=valid)


class ArucoDetector:
    """The reference's marker detector on the native backend, for every
    dictionary the reference resolves (`markers.dictionary.resolve`; an
    unknown name raises ValueError).

    A code within the dictionary's correction of a codeword decodes to it:
    one bit for the native tables, as the reference's native backend;
    floor(0.6 x maxCorrectionBits) for a cv2 table, as the reference's cv2
    backend (0 for ARUCO_ORIGINAL and every 4X4 table, 3 for 6X6_250 and
    TAG36h11). detection_mode DM_FAST / DM_VIDEO_FAST admits only larger
    quads, thresholds at one window and skips the correction;
    min_marker_size (aruco_minMarkerSize) is a fraction of the larger image
    side below which candidates are dropped.

    The native detector refines corners one way only, to the crossing of
    the edge lines: aruco_CornerRefimentMethod selects nothing in the port.
    Where the reference detects with cv2 (CORNER_REFINE_SUBPIX by default,
    CONTOUR for CORNER_LINES), the port's corners lie within 1.04 px of
    cv2's and within 0.19 px of the projected marker on rendered frames of
    every table (tests/test_torch_dictionaries.py holds 1.5 and 0.25 px).
    A cv2 table is decoded in the native detector's cv2 mode
    (csrc/host/aruco_detector.cpp: cv2's corner order, and two repairs of
    quads the native code drops); the native tables as the reference's
    native backend does, bit for bit.
    """

    def __init__(self, dictionary: str = "ARUCO_MIP_36h12", marker_size: float = 1.0,
                 detection_mode: str = "DM_NORMAL", min_marker_size: float = 0.0, device="cuda"):
        self.spec = resolve(dictionary)
        self.dictionary = dictionary
        self.marker_size = float(marker_size)
        self.detection_mode = detection_mode
        self.min_marker_size = float(min_marker_size)
        self.device = torch.device(device)
        load_library()  # build now: a detector that cannot be built is an error at set-up

    def _detect_raw(self, gray: np.ndarray):
        """-> (ids (n,), corners (n, 4, 2)) from the native detector."""
        min_perim = 40
        if self.min_marker_size > 0:
            min_perim = max(min_perim, int(4.0 * self.min_marker_size * max(gray.shape)))
        if self.detection_mode in ("DM_FAST", "DM_VIDEO_FAST"):
            # one threshold window (a negative max_correction), larger quads,
            # no bit-error correction
            min_perim, max_corr = max(min_perim, 60), -1
        else:
            max_corr = self.spec.max_correction
        return detect_markers_native(gray, dictionary=self.dictionary, min_perimeter=min_perim,
                                     max_correction=max_corr)

    def detect(self, img: np.ndarray, cam: CameraParams) -> FrameMarkers:
        """Detect markers; fill corners, undistorted corners, IPPE poses."""
        gray = np.asarray(img)
        if gray.ndim == 3:
            gray = 0.114 * gray[..., 0] + 0.587 * gray[..., 1] + 0.299 * gray[..., 2]
        gray = np.clip(gray, 0, 255).astype(np.uint8)
        ids, corners = self._detect_raw(gray)
        if len(ids) == 0:
            return empty_markers()
        M = MAX_MARKERS_PER_FRAME
        n = min(len(ids), M)
        corner_arr = np.zeros((M, 4, 2), np.float32)
        corner_arr[:n] = corners[:n]
        und = torch.from_numpy(corner_arr).to(self.device)
        if cam.has_distortion():
            und = cam.undistort_points(und)
        return _markers_from(ids, corner_arr, und, self.marker_size, cam)


class SyntheticMarkerDetector:
    """Oracle detector: projects known marker poses to corners."""

    def __init__(self, marker_poses_g2m: dict[int, np.ndarray], marker_size: float):
        self.poses = marker_poses_g2m  # id -> (4, 4) marker -> global
        self.size = marker_size

    def detect_at_pose(self, pose_f2g: np.ndarray, cam: CameraParams, noise: float = 0.0, rng=None,
                       device="cpu") -> FrameMarkers:
        """The markers in view of a camera at pose_f2g (IPPE on `device`)."""
        M = MAX_MARKERS_PER_FRAME
        corner_arr = np.zeros((M, 4, 2), np.float32)
        ids = []
        obj = marker_object_points(np.float32(self.size)).numpy()
        for mid, g2m in sorted(self.poses.items()):
            if len(ids) >= M:
                break
            T = pose_f2g @ g2m  # marker -> camera
            pts_c = obj @ T[:3, :3].T + T[:3, 3]
            if (pts_c[:, 2] <= 0.1).any():
                continue
            uv = cam.project(torch.from_numpy(np.asarray(pts_c, np.float32))).numpy()
            if (uv[:, 0] < 0).any() or (uv[:, 0] >= cam.width).any() or (uv[:, 1] < 0).any() \
                    or (uv[:, 1] >= cam.height).any():
                continue
            if noise > 0 and rng is not None:
                uv = uv + rng.normal(0, noise, uv.shape)
            corner_arr[len(ids)] = uv
            ids.append(mid)
        if not ids:
            return empty_markers()
        return _markers_from(np.asarray(ids, np.int32), corner_arr, torch.from_numpy(corner_arr).to(device), self.size,
                             cam)
