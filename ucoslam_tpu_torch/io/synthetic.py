"""Synthetic sequences with ground truth: rendered images and oracle frames.

Port of `ucoslam_tpu/io/synthetic.py` (`SyntheticSequence.__init__`,
`render`, `render_stereo`, `render_with_depth`, `frame`, `gt_pose`,
`gt_positions`). It draws the same random
streams in the same order, so the images are byte-identical to the
reference's for the same arguments (up to the marker poses' float32
exponential), and the oracle frames hold the same keypoints, descriptors
and marker detections. With `n_markers`, tilted square ARUCO_MIP_36h12
markers stand among the quads (the quads around them cleared), the oracle
frames carry their projected corners, and the rendered images their real
bitmaps.
"""

from __future__ import annotations

import numpy as np
import torch

from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.geometry.se3 import se3_exp
from ucoslam_tpu_torch.mapping.frame import Frame, empty_frame, tensor_from_numpy
from ucoslam_tpu_torch.markers.detector import SyntheticMarkerDetector
from ucoslam_tpu_torch.markers.dictionary import marker_texture


def _lookat(eye: np.ndarray, target: np.ndarray, up=np.array([0.0, -1.0, 0.0])):
    """World->camera pose looking from eye at target (right-handed, z fwd)."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], 0)  # rows = camera axes in world
    t = -R @ eye
    return R.astype(np.float32), t.astype(np.float32)


class SyntheticSequence:
    """A deterministic scene of textured quads and a smooth trajectory."""

    def __init__(
        self,
        cam: CameraParams | None = None,
        n_points: int = 1200,
        n_frames: int = 60,
        n_kpt_slots: int = 512,  # oracle frames: keypoint capacity
        noise_px: float = 0.3,  # oracle frames: keypoint noise
        desc_bit_flips: int = 8,  # oracle frames: flipped descriptor bits
        trajectory: str = "arc",
        depth_mode: str = "mono",  # mono | stereo | rgbd (oracle depth)
        seed: int = 0,
        motion_scale: float = 1.0,
        n_markers: int = 0,
        marker_size: float = 0.5,  # side length (m)
        marker_noise: float = 0.2,  # oracle frames: corner noise (px)
        roll_deg: float = 0.0,  # sinusoidal camera roll over the sequence
        brightness_drift: float = 0.0,  # per-frame global gain amplitude
    ):
        self.cam = cam or CameraParams.create(
            500.0, 500.0, 320.0, 240.0, width=640, height=480, bl=0.1
        )
        self.n_frames = n_frames
        self.n_kpt_slots = n_kpt_slots
        self.noise_px = noise_px
        self.desc_bit_flips = desc_bit_flips
        self.depth_mode = depth_mode
        rng = np.random.default_rng(seed)
        if trajectory == "orbit_out":
            ang = rng.uniform(0, 2 * np.pi, n_points)
            r = rng.uniform(7, 9, n_points)
            self.points = np.stack(
                [r * np.sin(ang), rng.uniform(-2.5, 2.5, n_points), r * np.cos(ang)], -1
            ).astype(np.float32)
        else:
            self.points = np.stack(
                [
                    rng.uniform(-4, 4, n_points),
                    rng.uniform(-3, 3, n_points),
                    rng.uniform(4, 8, n_points),
                ],
                -1,
            ).astype(np.float32)
        self.descs = rng.integers(0, 2**32, (n_points, 8), dtype=np.uint32)
        self.brightness = rng.uniform(80, 255, n_points).astype(np.float32)
        self.roll_deg = roll_deg
        self.brightness_drift = brightness_drift
        # world-anchored quad half-sizes, in-plane rotations, 8x8 textures
        rngq = np.random.default_rng(12345)
        self.quad_half = rngq.uniform(0.12, 0.35, (n_points, 2)).astype(np.float32)
        self.quad_theta = rngq.uniform(-np.pi / 4, np.pi / 4, n_points).astype(np.float32)
        tex = rngq.uniform(0.45, 1.55, (n_points, 8, 8)).astype(np.float32)
        self.quad_tex = np.clip(tex * self.brightness[:, None, None], 25.0, 255.0).astype(np.float32)
        # oracle frames' size model: a blob is detected at octave
        # round(log(d0 / d) / log(1.2)) at distance d (its own random stream)
        rng_sz = np.random.default_rng(seed + 77003)
        self.point_d0 = rng_sz.uniform(10.0, 14.0, n_points).astype(np.float32)
        self.n_octaves = 8
        self.scale_factor = 1.2

        # markers: tilted squares scattered across the slab, drawn from the
        # scene's own stream after the points, facing the camera side (the
        # flip: the trajectory looks along +z)
        self.marker_size = marker_size
        self.marker_noise = marker_noise
        self._marker_detector = None
        if n_markers > 0:
            flip = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
            marker_poses = {}
            for mid in range(n_markers):
                xi = np.concatenate([
                    [rng.uniform(-2.5, 2.5), rng.uniform(-2, 2), rng.uniform(4.5, 6.5)],
                    rng.uniform(-0.5, 0.5, 3),
                ]).astype(np.float32)
                marker_poses[100 + mid] = se3_exp(torch.from_numpy(xi)).numpy() @ flip
            # clear the quads near the markers so that none occludes one
            centers = np.stack([T[:3, 3] for T in marker_poses.values()])
            r_excl = 0.5 * marker_size * 1.45 * np.sqrt(2.0) + 0.55
            keep = np.linalg.norm(self.points[:, None, :] - centers[None, :, :], axis=-1).min(1) > r_excl
            self.points = self.points[keep]
            self.descs = self.descs[keep]
            self.brightness = self.brightness[keep]
            self.quad_half = self.quad_half[keep]
            self.quad_theta = self.quad_theta[keep]
            self.quad_tex = self.quad_tex[keep]
            self.point_d0 = self.point_d0[keep]
            self._marker_detector = SyntheticMarkerDetector(marker_poses, marker_size)

        self.poses = []  # (4, 4) pose_f2g (world -> camera) per frame
        center = np.array([0.0, 0.0, 6.0])
        for i in range(n_frames):
            s = i / max(n_frames - 1, 1) * motion_scale
            if trajectory == "arc":
                ang = (s - 0.5) * 0.8
                eye = np.array([3.0 * np.sin(ang), 0.6 * np.sin(2 * ang), -0.5 + 0.3 * s])
            elif trajectory == "line":
                eye = np.array([-1.5 + 3.0 * s, 0.0, -0.5])
            elif trajectory == "loop":
                ang = 2 * np.pi * s
                eye = np.array([1.5 * np.sin(ang), 0.0, -0.5 + 1.0 * np.sin(ang / 2) ** 2])
            elif trajectory == "orbit_out":
                ang = 2 * np.pi * s
                eye = np.array([2.0 * np.sin(ang), 0.0, 2.0 * np.cos(ang)])
                center = eye + np.array([4.0 * np.sin(ang), 0.0, 4.0 * np.cos(ang)])
            elif trajectory == "sweep_back":
                ang = np.deg2rad(60.0) * np.sin(np.pi * s)
                eye = center + np.array([
                    5.0 * np.sin(ang), 0.4 * np.sin(2 * np.pi * s), -5.0 * np.cos(ang),
                ])
            else:
                raise ValueError(trajectory)
            R, t = _lookat(eye, center)
            if roll_deg != 0.0:
                phi = np.deg2rad(roll_deg) * np.sin(2 * np.pi * s)
                c, sn = np.cos(phi), np.sin(phi)
                Rz = np.array([[c, -sn, 0.0], [sn, c, 0.0], [0.0, 0.0, 1.0]], np.float32)
                R = Rz @ R
                t = Rz @ t
            self.poses.append(
                np.vstack([np.hstack([R, t[:, None]]), [0, 0, 0, 1]]).astype(np.float32)
            )

    def gt_pose(self, i: int) -> np.ndarray:
        return self.poses[i]

    def gt_positions(self) -> np.ndarray:
        """(F, 3) camera centres in world coordinates."""
        return np.stack([-T[:3, :3].T @ T[:3, 3] for T in self.poses])

    @property
    def marker_poses(self) -> dict[int, np.ndarray]:
        """marker id -> (4, 4) marker -> world pose (empty without markers)."""
        return {} if self._marker_detector is None else self._marker_detector.poses

    def frame(self, i: int, device="cuda") -> Frame:
        """Oracle Frame of index i: the visible blobs' projections with
        pixel noise and flipped descriptor bits, and the visible markers'
        corners with corner noise, deterministic per (seed, i); the same
        draws in the same order as the reference's."""
        rng = np.random.default_rng(7919 * i + 13)
        T = self.poses[i]
        R, t = T[:3, :3], T[:3, 3]
        cam_pts = self.points @ R.T + t
        z = cam_pts[:, 2]
        uv = self.cam.project(torch.from_numpy(cam_pts)).numpy()
        w, h = self.cam.width, self.cam.height
        vis = (z > 0.5) & (uv[:, 0] >= 5) & (uv[:, 0] < w - 5) & (uv[:, 1] >= 5) & (uv[:, 1] < h - 5)
        idx = np.nonzero(vis)[0]
        rng.shuffle(idx)
        idx = np.sort(idx[: self.n_kpt_slots])
        n, cap = len(idx), self.n_kpt_slots
        uv_obs = uv[idx] + rng.normal(0, self.noise_px, (n, 2))
        desc = self.descs[idx].copy()
        for _ in range(self.desc_bit_flips):
            word = rng.integers(0, 8, n)
            bit = rng.integers(0, 32, n).astype(np.uint32)
            desc[np.arange(n), word] ^= np.uint32(1) << bit
        depth = np.zeros(cap, np.float32)
        if self.depth_mode in ("stereo", "rgbd"):
            depth[:n] = z[idx] * (1.0 + rng.normal(0, 0.002, n))
        dist = np.linalg.norm(cam_pts[idx], axis=-1).clip(1e-6)
        octave = np.zeros(cap, np.int32)
        octave[:n] = np.clip(
            np.round(np.log(self.point_d0[idx] / dist) / np.log(self.scale_factor)), 0, self.n_octaves - 1
        ).astype(np.int32)
        xy = np.vstack([uv_obs, np.zeros((cap - n, 2))]).astype(np.float32)
        desc = np.vstack([desc, np.zeros((cap - n, 8), np.uint32)])

        def t_(a):
            return tensor_from_numpy(a, device)

        f = empty_frame(cap, device).replace(
            fseq=i, xy=t_(xy), und_xy=t_(xy), desc=t_(desc), valid=t_(np.arange(cap) < n),
            depth=t_(depth), octave=t_(octave),
        )
        if self._marker_detector is not None:
            f = f.replace(markers=self._marker_detector.detect_at_pose(
                T, self.cam, noise=self.marker_noise, rng=rng, device=device))
        return f

    def render(self, i: int) -> np.ndarray:
        """(H, W) float32 image of frame i: homography-rasterized textured
        quads, painted far to near."""
        return self._render(i)[0]

    def render_stereo(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """(left, right) rectified pair of frame i: the right camera sits
        the baseline `cam.bl` along the left camera's +x."""
        left = self.render(i)
        saved = self.poses[i]
        T_r = saved.copy()
        T_r[0, 3] -= self.cam.bl  # x_r = x_l - bl
        self.poses[i] = T_r
        try:
            right = self.render(i)
        finally:
            self.poses[i] = saved
        return left, right

    def render_with_depth(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """(image, depth) of frame i; depth is the renderer's exact z-buffer,
        the camera-frame z of the visible surface at each pixel (0 where no
        quad covers it)."""
        return self._render(i, with_depth=True)

    def _render(self, i: int, with_depth: bool = False):
        T = self.poses[i]
        R, t = T[:3, :3], T[:3, 3]
        fx, fy = float(self.cam.fx), float(self.cam.fy)
        cx, cy = float(self.cam.cx), float(self.cam.cy)
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
        h, w = self.cam.height, self.cam.width
        img = np.full((h, w), 40.0, np.float32)
        dep = np.zeros((h, w), np.float32) if with_depth else None

        cam_pts = self.points @ R.T + t
        z = cam_pts[:, 2]
        cth, sth = np.cos(self.quad_theta), np.sin(self.quad_theta)
        U = np.stack([cth, sth, np.zeros_like(cth)], -1) * self.quad_half[:, :1]
        V = np.stack([-sth, cth, np.zeros_like(cth)], -1) * self.quad_half[:, 1:2]
        items = [
            (z[j], R @ U[j], R @ V[j], cam_pts[j], self.quad_tex[j])
            for j in range(len(self.points))
        ]
        # the markers' real bitmaps as world-anchored planes: the quad spans
        # the quiet zone, the black border the physical marker size
        if self._marker_detector is not None:
            for mid, g2m in sorted(self.marker_poses.items()):
                tex, ratio = marker_texture(mid % 250, px_per_cell=8)
                Tm = T @ g2m  # marker -> camera
                hext = 0.5 * self.marker_size * ratio
                # row 0 of tex is the marker's top, +y
                items.append((float(Tm[2, 3]), Tm[:3, 0] * hext, Tm[:3, 1] * hext, Tm[:3, 3], np.flipud(tex).copy()))
        items.sort(key=lambda it: -it[0])  # painter's algorithm, far to near
        for zj, Uc, Vc, Cc, tex in items:
            if zj < 0.5:
                continue
            H = K @ np.stack([Uc, Vc, Cc], 1)
            corn = H @ np.array([[-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], np.float32).T
            if (corn[2] < 1e-3).any():
                continue  # quad crosses the image plane
            cu = corn[0] / corn[2]
            cv = corn[1] / corn[2]
            x0 = max(0, int(np.floor(cu.min())))
            x1 = min(w, int(np.ceil(cu.max())) + 1)
            y0 = max(0, int(np.floor(cv.min())))
            y1 = min(h, int(np.ceil(cv.max())) + 1)
            if x1 <= x0 or y1 <= y0:
                continue
            try:
                Hinv = np.linalg.inv(H)
            except np.linalg.LinAlgError:
                continue
            ys, xs = np.mgrid[y0:y1, x0:x1]
            q = np.einsum(
                "ab,byx->ayx",
                Hinv,
                np.stack([xs.astype(np.float32), ys.astype(np.float32), np.ones_like(xs, np.float32)]),
            )
            s = q[0] / q[2]
            tt = q[1] / q[2]
            inside = (np.abs(s) <= 1.0) & (np.abs(tt) <= 1.0) & (q[2] != 0)
            if not inside.any():
                continue
            th, tw = tex.shape
            ti = np.clip((((s + 1.0) * 0.5) * tw).astype(np.int32), 0, tw - 1)
            tj = np.clip((((tt + 1.0) * 0.5) * th).astype(np.int32), 0, th - 1)
            patch = img[y0:y1, x0:x1]
            patch[inside] = tex[tj[inside], ti[inside]]
            if with_depth:
                # Uc, Vc are the plane's camera-frame basis: z = Cc.z + s Uc.z + t Vc.z
                zpix = Cc[2] + s * Uc[2] + tt * Vc[2]
                dep[y0:y1, x0:x1][inside] = zpix[inside]
        if self.brightness_drift != 0.0:
            sfrac = i / max(self.n_frames - 1, 1)
            gain = 1.0 + self.brightness_drift * np.sin(2 * np.pi * sfrac)
            img = np.clip(img * gain, 0.0, 255.0)
        return img, dep
