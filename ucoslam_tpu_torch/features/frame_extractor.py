"""Frame ingestion: raw image(s) -> Frame (monocular, RGB-D, stereo).

Port of `ucoslam_tpu/features/frame_extractor.py`. Every entry point starts
from the same base frame of the (left) image: gray conversion, ORB detect +
describe, keypoint undistortion, padding to the frame capacity, then the
markers (`markers.detector.ArucoDetector`) and, with
`removeKeyPointsIntoMarkers`, the keypoints inside a detected marker
dropped. RGB-D samples the raw depth image at each keypoint; stereo runs a
second ORB pass on the rectified right image, matches along rows and refines
each match to subpixel disparity (`stereo_depth`).

Two options of the reference's frontend: detector-resolution scaling
(`kptImageScaleFactor`, times min(1, `targetFocus` / fx) when `targetFocus`
is set) detects on the gray image resized by the reference's
anti-aliased triangle filter (`jax.image.resize(..., "linear")`, its weight
matrices built in its own float32 arithmetic and applied as two matmuls by
`ops.image.resize_linear`) and scales the keypoints back to
full-resolution pixels; `autoAdjustKpSensitivity` moves the FAST threshold
between 3 and 7 by the previous frame's fill of the detector's budget, read
one frame late from a non-blocking copy to pinned memory, so that no frame
waits for its own detection.

The descriptor families route as the reference's do: ORB, FREAK and SURF
through `ORBExtractor(descriptor=...)` on the device; AKAZE and BRISK
through the cv2 `GridExtractor` on the host (it needs cv2; no sensitivity
adaptation there, as in the reference).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ucoslam_tpu_torch.config import DescriptorType, Params
from ucoslam_tpu_torch.features.orb import ORBExtractor
from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.mapping.frame import Frame, empty_frame
from ucoslam_tpu_torch.ops.hamming import INVALID_DIST, hamming_matrix, match_best2, mutual_best
from ucoslam_tpu_torch.ops.image import bilinear_sample, resize_linear, rgb_to_gray
from ucoslam_tpu_torch.utils.timers import timers


def points_in_quads(xy: torch.Tensor, quads: torch.Tensor, quad_valid: torch.Tensor) -> torch.Tensor:
    """(N, 2) points x (M, 4, 2) convex quads -> (N,) bool inside any valid
    quad: on the same side of all four edges, either winding."""
    e = torch.roll(quads, -1, dims=1) - quads  # (M, 4, 2) edge vectors
    r = xy[:, None, None, :] - quads[None]  # (N, M, 4, 2)
    cross = e[None, ..., 0] * r[..., 1] - e[None, ..., 1] * r[..., 0]  # (N, M, 4)
    inside = (cross >= 0).all(-1) | (cross <= 0).all(-1)
    return (inside & quad_valid[None, :]).any(-1)


#: the families the device extractor describes, by ORBExtractor's name
DEVICE_FAMILIES = {DescriptorType.ORB: "orb", DescriptorType.FREAK: "freak", DescriptorType.SURF: "surf"}


class FrameExtractor:
    def __init__(self, params: Params, cam: CameraParams, device="cuda", marker_detector=None):
        self.params = params
        self.cam = cam
        self.device = torch.device(device)
        self.marker_detector = marker_detector
        self._prefetched = None  # (image, pinned host copy, device copy) of the next frame
        self._pending_fill = None  # (host copy, copy event) of the last frame's budget fill
        # the detector's resolution: kptImageScaleFactor, and targetFocus
        # normalizing it across cameras (the focus the keypoint parameters
        # were tuned for)
        ksf = float(params.kptImageScaleFactor)
        if params.targetFocus > 0:
            ksf *= min(1.0, float(params.targetFocus) / float(cam.fx))
        self.ksf = ksf
        if params.kpDescriptorType in DEVICE_FAMILIES:
            self.orb = ORBExtractor(
                max_features=min(params.maxFeatures, params.maxKeyPointsPerFrame),
                n_levels=params.nOctaveLevels,
                scale_factor=params.scaleFactor,
                cell=64 if params.KPNonMaximaSuppresion else 32,
                k_per_cell=1 if params.KPNonMaximaSuppresion else 4,
                descriptor=DEVICE_FAMILIES[params.kpDescriptorType],
            )
        else:  # AKAZE, BRISK: the reference's cv2 plug point (gridextractor.cpp:36-39)
            from ucoslam_tpu_torch.features.grid_extractor import GridExtractor

            self.orb = GridExtractor(params, device=self.device)

    def prefetch(self, img: np.ndarray) -> None:
        """Start the copy of the next frame's image to the device now, from
        pinned host memory without blocking, so that it overlaps this
        frame's host work; the next call on this very array uses it."""
        host = torch.from_numpy(np.ascontiguousarray(img))
        if self.device.type == "cuda":
            host = host.pin_memory()
        self._prefetched = (img, host, host.to(self.device, non_blocking=True))

    def _take_prefetched(self, img: np.ndarray) -> torch.Tensor:
        """The image on the device: its prefetched copy, or a copy now. The
        pinned buffer stays referenced until then, so the copy completes
        from live memory (the stream orders it before any use)."""
        if self._prefetched is not None and self._prefetched[0] is img:
            buf, self._prefetched = self._prefetched[2], None
            return buf
        return torch.from_numpy(np.ascontiguousarray(img)).to(self.device)

    def _gray(self, img: np.ndarray) -> torch.Tensor:
        return rgb_to_gray(self._take_prefetched(img))

    def _adjust_sensitivity(self) -> None:
        """The low-texture adaptation (ORBextractor::setSensitivity): when
        the previous frame's detector filled less than half its budget,
        lower the FAST threshold by 1 (down to 3); above 90%, raise it back
        (up to 7). The fill's copy was started a frame ago, so its event
        has long completed."""
        if self._pending_fill is None:
            return
        host, done = self._pending_fill
        if done is not None:
            done.synchronize()
        fill = float(host[0])
        if fill < 0.5 and self.orb.fast_threshold:
            self.orb.fast_threshold = max(3.0, self.orb.fast_threshold - 1.0)
        elif fill > 0.9 and self.orb.fast_threshold < 7.0:
            self.orb.fast_threshold = min(7.0, self.orb.fast_threshold + 1.0)

    def _keep_fill(self, valid: torch.Tensor) -> None:
        """Start the copy of this frame's budget fill to the host."""
        fill = valid.to(torch.float32).mean().reshape(1)
        if fill.device.type == "cuda":
            host = torch.empty(1, dtype=torch.float32, pin_memory=True)
            host.copy_(fill, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            self._pending_fill = (host, done)
        else:
            self._pending_fill = (fill, None)

    def detect(self, gray: torch.Tensor):
        """Keypoints of a gray image at the detector's resolution, in
        full-resolution pixels."""
        if self.ksf == 1.0:
            return self.orb.detect_and_compute(gray)
        H, W = gray.shape
        small = (max(8, int(round(H * self.ksf))), max(8, int(round(W * self.ksf))))
        kps = self.orb.detect_and_compute(resize_linear(gray, small))
        return dataclasses.replace(kps, xy=kps.xy / torch.tensor(np.float32(self.ksf), device=gray.device))

    def _base_frame(self, img: np.ndarray, fseq: int) -> tuple[Frame, torch.Tensor]:
        """(H, W) gray or (H, W, 3) BGR image -> (Frame, gray image), both on
        the device."""
        return self._base_frame_impl(img, fseq)

    def _base_frame_impl(self, img: np.ndarray, fseq: int) -> tuple[Frame, torch.Tensor]:
        adjust = self.params.autoAdjustKpSensitivity and isinstance(self.orb, ORBExtractor)
        if adjust:
            self._adjust_sensitivity()
        with timers.span("frontend.upload"):
            gray = self._gray(img)
        kps = self.detect(gray)
        with timers.span("frontend.pack"):
            return self._pack(img, fseq, kps, adjust), gray

    def _pack(self, img: np.ndarray, fseq: int, kps, adjust: bool) -> Frame:
        """The detector's keypoints padded into a Frame, undistorted, with
        the image's markers."""
        cap = self.params.maxKeyPointsPerFrame
        if adjust:
            self._keep_fill(kps.valid)
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

    def process(self, img: np.ndarray, fseq: int = 0) -> Frame:
        """(H, W) gray or (H, W, 3) BGR image -> Frame on the device."""
        with timers.span("frontend.extract"):
            return self._base_frame(img, fseq)[0]

    def process_rgbd(self, img: np.ndarray, depth: np.ndarray, fseq: int = 0) -> Frame:
        """Image and its registered (H, W) raw depth image (metres = raw x
        rgb_depthscale) -> Frame with each keypoint's depth, sampled at its
        distorted pixel; 0 where the keypoint is invalid or the depth is not
        positive."""
        with timers.span("frontend.extract"):
            f, _ = self._base_frame(img, fseq)
            with timers.span("frontend.pack"):
                raw = torch.from_numpy(np.ascontiguousarray(depth, np.float32)).to(self.device)
                d = bilinear_sample(raw, f.xy, mode="nearest") * float(np.float32(self.cam.rgb_depthscale))
                return f.replace(depth=torch.where(f.valid & (d > 0), d, 0.0))

    def process_stereo(self, left: np.ndarray, right: np.ndarray, fseq: int = 0) -> Frame:
        """Rectified pair -> Frame of the left image with each keypoint's
        depth from its row match in the right image (`stereo_depth`)."""
        with timers.span("frontend.extract"):
            f, gray_l = self._base_frame(left, fseq)
            with timers.span("frontend.upload"):
                gray_r = self._gray(right)
            kr = self.orb.detect_and_compute(gray_r)  # full resolution, as the reference
            cam = self.cam
            # z >= baseline <=> disparity <= bf / bl (= fx); fx when bl == 0,
            # where bf == 0 gives every keypoint depth 0, as in the reference
            max_disp = float(np.float32(cam.bf) / np.float32(cam.bl)) if cam.bl > 0 else cam.fx
            with timers.span("frontend.stereo"):
                depth = stereo_depth(f, gray_l, gray_r, kr.xy, kr.desc, kr.octave, kr.valid, cam.bf, max_disp,
                                     float(np.float32(self.params.maxDescDistance)))
            return f.replace(depth=depth)


#: stereo_depth's SAD patch half-width and its search half-range along the row (px)
SAD_HALF, SAD_RANGE = 5, 4


def stereo_depth(f: Frame, gray_l, gray_r, xy_r, desc_r, octave_r, valid_r, bf: float, max_disp: float,
                 max_desc_dist: float) -> torch.Tensor:
    """(N,) depth of the left frame's keypoints, 0 where none.

    A left keypoint matches the right keypoint of least Hamming distance
    among those within 2 rows, at a disparity in (0, max_disp) and within
    one octave, when the two are each other's best and the distance is at
    most max_desc_dist (repetitive texture along a row aliases badly, so a
    one-way best is not enough). The match is refined to subpixel: the SAD
    of an 11x11 bilinear patch at 9 offsets along the row (+-4 px), then the
    equiangular (V-shaped) vertex fit of the minimum and its neighbours; a
    minimum at the search border is rejected. depth = bf / disparity.
    Ties go to the lowest index in every argmin, as in the reference.
    """
    dev = gray_l.device
    d = hamming_matrix(f.desc, desc_r)
    row_ok = (f.xy[:, None, 1] - xy_r[None, :, 1]).abs() <= 2.0
    disp = f.xy[:, None, 0] - xy_r[None, :, 0]
    disp_ok = (disp > 0.0) & (disp < max_disp)
    oct_ok = (f.octave[:, None] - octave_r[None, :]).abs() <= 1
    mask = row_ok & disp_ok & oct_ok & valid_r[None, :] & f.valid[:, None]
    idx, best, _ = match_best2(d, valid_rows=f.valid, extra_mask=mask)
    mut = mutual_best(torch.where(mask, d, INVALID_DIST))
    ok = (best <= max_desc_dist) & (mut == idx)

    W, R = SAD_HALF, SAD_RANGE
    du = torch.arange(-W, W + 1, dtype=torch.float32, device=dev)
    gx, gy = torch.meshgrid(du, du, indexing="xy")
    grid = torch.stack([gx, gy], -1).reshape(-1, 2)  # (121, 2) patch offsets, x fastest
    patch_l = bilinear_sample(gray_l, f.xy[:, None, :] + grid[None], mode="bilinear")  # (N, 121)
    x_r0, y_r = xy_r[idx, 0], xy_r[idx, 1]
    offs = torch.arange(-R, R + 1, dtype=torch.float32, device=dev)
    shift = torch.stack([offs, torch.zeros_like(offs)], -1)  # (9, 2): the offset moves x only
    pts_r = torch.stack([x_r0, y_r], -1)[:, None, None, :] + grid[None, None] + shift[None, :, None, :]
    patch_r = bilinear_sample(gray_r, pts_r, mode="bilinear")  # (N, 9, 121)
    sad = (patch_r - patch_l[:, None, :]).abs().sum(-1)  # (N, 9)
    j = torch.argmin(sad, -1)
    jc = j.clamp(1, 2 * R - 1)  # interior for the vertex fit
    s0, s1, s2 = (sad.gather(1, (jc + k)[:, None])[:, 0] for k in (-1, 0, 1))
    # SAD of a step edge is piecewise linear in the offset: the two-slope
    # fit recovers its fractional vertex, where a parabola would be biased
    hi = torch.maximum(s0, s2)
    delta = torch.where(hi > s1 + 1e-6, 0.5 * (s0 - s2) / (hi - s1), 0.0).clamp(-1.0, 1.0)
    x_r = x_r0 + (jc.to(torch.float32) - R) + delta
    refine_ok = (j >= 1) & (j <= 2 * R - 1)
    disparity = f.xy[:, 0] - x_r
    depth = bf / disparity.clamp(min=1e-3)
    good = ok & f.valid & refine_ok & (disparity > 0.0) & (disparity < max_disp)
    return torch.where(good, depth, 0.0)
