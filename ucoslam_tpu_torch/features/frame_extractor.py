"""Frame ingestion: one image -> Frame (monocular).

Port of the monocular ingest of `ucoslam_tpu/features/frame_extractor.py`:
gray conversion, ORB detect + describe, keypoint undistortion, padding to
the frame capacity, then the markers (`markers.detector.ArucoDetector`) and,
with `removeKeyPointsIntoMarkers`, the keypoints inside a detected marker
dropped. The cv2 grid extractor, the detector-resolution scaling, the
sensitivity adaptation and stereo/RGB-D input are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ucoslam_tpu_torch.config import DescriptorType, Params
from ucoslam_tpu_torch.features.orb import ORBExtractor
from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.mapping.frame import Frame, empty_frame
from ucoslam_tpu_torch.ops.image import rgb_to_gray


def points_in_quads(xy: torch.Tensor, quads: torch.Tensor, quad_valid: torch.Tensor) -> torch.Tensor:
    """(N, 2) points x (M, 4, 2) convex quads -> (N,) bool inside any valid
    quad: on the same side of all four edges, either winding."""
    e = torch.roll(quads, -1, dims=1) - quads  # (M, 4, 2) edge vectors
    r = xy[:, None, None, :] - quads[None]  # (N, M, 4, 2)
    cross = e[None, ..., 0] * r[..., 1] - e[None, ..., 1] * r[..., 0]  # (N, M, 4)
    inside = (cross >= 0).all(-1) | (cross <= 0).all(-1)
    return (inside & quad_valid[None, :]).any(-1)


class FrameExtractor:
    def __init__(self, params: Params, cam: CameraParams, device="cuda", marker_detector=None):
        unported = []
        if params.kpDescriptorType != DescriptorType.ORB:
            unported.append(f"descriptor {params.kpDescriptorType.name}")
        if params.kptImageScaleFactor != 1.0 or params.targetFocus > 0:
            unported.append("detector-resolution scaling")
        if params.autoAdjustKpSensitivity:
            unported.append("autoAdjustKpSensitivity")
        if unported:
            raise NotImplementedError(
                f"not ported yet: {', '.join(unported)} (ROADMAP.md, Queue 1 item 7: frontend options)"
            )
        self.params = params
        self.cam = cam
        self.device = torch.device(device)
        self.marker_detector = marker_detector
        self.orb = ORBExtractor(
            max_features=min(params.maxFeatures, params.maxKeyPointsPerFrame),
            n_levels=params.nOctaveLevels,
            scale_factor=params.scaleFactor,
            cell=64 if params.KPNonMaximaSuppresion else 32,
            k_per_cell=1 if params.KPNonMaximaSuppresion else 4,
        )

    def process(self, img: np.ndarray, fseq: int = 0) -> Frame:
        """(H, W) gray or (H, W, 3) BGR image -> Frame on the device."""
        cap = self.params.maxKeyPointsPerFrame
        gray = rgb_to_gray(torch.from_numpy(np.ascontiguousarray(img)).to(self.device))
        kps = self.orb.detect_and_compute(gray)
        und = self.cam.undistort_points(kps.xy) if self.cam.has_distortion() else kps.xy

        def fit(a, fill=0):
            """Pad the detector's rows to the frame capacity."""
            pad = cap - a.shape[0]
            return torch.cat([a, a.new_full((pad, *a.shape[1:]), fill)]) if pad else a

        f = empty_frame(cap, self.device).replace(
            fseq=int(fseq),
            xy=fit(kps.xy),
            und_xy=fit(und),
            octave=fit(kps.octave),
            angle=fit(kps.angle),
            response=fit(kps.response),
            desc=fit(kps.desc),
            valid=fit(kps.valid, fill=False),
        )
        if self.params.detectMarkers and self.marker_detector is not None:
            f = f.replace(markers=self.marker_detector.detect(img, self.cam))
            if self.params.removeKeyPointsIntoMarkers and f.markers.valid.any():
                # marker interiors are texture the map must not depend on
                quads = torch.from_numpy(f.markers.corners).to(self.device)
                valid = torch.from_numpy(f.markers.valid).to(self.device)
                f = f.replace(valid=f.valid & ~points_in_quads(f.xy, quads, valid))
        return f
