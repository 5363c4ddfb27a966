"""Frame ingestion: one image -> Frame (monocular).

Port of the monocular ingest of `ucoslam_tpu/features/frame_extractor.py`:
gray conversion, ORB detect + describe, keypoint undistortion, padding to
the frame capacity. The cv2 grid extractor, the detector-resolution scaling,
the sensitivity adaptation, markers and stereo/RGB-D input are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ucoslam_tpu_torch.config import DescriptorType, Params
from ucoslam_tpu_torch.features.orb import ORBExtractor
from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.mapping.frame import Frame, empty_frame
from ucoslam_tpu_torch.ops.image import rgb_to_gray


class FrameExtractor:
    def __init__(self, params: Params, cam: CameraParams, device="cuda"):
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

        f = empty_frame(cap, self.device)
        return f.replace(
            fseq=int(fseq),
            xy=fit(kps.xy),
            und_xy=fit(und),
            octave=fit(kps.octave),
            angle=fit(kps.angle),
            response=fit(kps.response),
            desc=fit(kps.desc),
            valid=fit(kps.valid, fill=False),
        )
