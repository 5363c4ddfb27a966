"""Frozen copy of the port's synthetic scene and renderer.

Copied from `ucoslam_tpu_torch/io/synthetic.py` (`SyntheticSequence`:
`__init__` without markers, `_lookat`, `render`, `gt_pose`), in numpy
alone, so that the
benchmark's inputs do not move when the program's copy changes. The random
streams are drawn in the same order, so a scene of the same arguments renders
the same images as the original. Markers, oracle frames, the stereo pair
and the depth map are left out.

A scene module of the benchmark exposes `make(scene: dict, camera: dict,
seed: int)` -> an object with `n_frames`, `render(i)` and `gt_pose(i)`.
"""

from __future__ import annotations

import numpy as np


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


class QuadScene:
    """A deterministic scene of textured quads and a smooth trajectory."""

    def __init__(self, camera: dict, n_points: int = 1200, n_frames: int = 60, trajectory: str = "arc",
                 seed: int = 0, motion_scale: float = 1.0, roll_deg: float = 0.0,
                 brightness_drift: float = 0.0):
        self.fx, self.fy = float(np.float32(camera["fx"])), float(np.float32(camera["fy"]))
        self.cx, self.cy = float(np.float32(camera["cx"])), float(np.float32(camera["cy"]))
        self.width, self.height = int(camera["width"]), int(camera["height"])
        self.n_frames = n_frames
        rng = np.random.default_rng(seed)
        if trajectory == "orbit_out":
            ang = rng.uniform(0, 2 * np.pi, n_points)
            r = rng.uniform(7, 9, n_points)
            self.points = np.stack(
                [r * np.sin(ang), rng.uniform(-2.5, 2.5, n_points), r * np.cos(ang)], -1
            ).astype(np.float32)
        else:
            self.points = np.stack(
                [rng.uniform(-4, 4, n_points), rng.uniform(-3, 3, n_points), rng.uniform(4, 8, n_points)], -1
            ).astype(np.float32)
        self.descs = rng.integers(0, 2**32, (n_points, 8), dtype=np.uint32)  # kept: it advances the stream
        self.brightness = rng.uniform(80, 255, n_points).astype(np.float32)
        self.roll_deg = roll_deg
        self.brightness_drift = brightness_drift
        rngq = np.random.default_rng(12345)
        self.quad_half = rngq.uniform(0.12, 0.35, (n_points, 2)).astype(np.float32)
        self.quad_theta = rngq.uniform(-np.pi / 4, np.pi / 4, n_points).astype(np.float32)
        tex = rngq.uniform(0.45, 1.55, (n_points, 8, 8)).astype(np.float32)
        self.quad_tex = np.clip(tex * self.brightness[:, None, None], 25.0, 255.0).astype(np.float32)

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
                eye = center + np.array([5.0 * np.sin(ang), 0.4 * np.sin(2 * np.pi * s), -5.0 * np.cos(ang)])
            else:
                raise ValueError(trajectory)
            R, t = _lookat(eye, center)
            if roll_deg != 0.0:
                phi = np.deg2rad(roll_deg) * np.sin(2 * np.pi * s)
                c, sn = np.cos(phi), np.sin(phi)
                Rz = np.array([[c, -sn, 0.0], [sn, c, 0.0], [0.0, 0.0, 1.0]], np.float32)
                R = Rz @ R
                t = Rz @ t
            self.poses.append(np.vstack([np.hstack([R, t[:, None]]), [0, 0, 0, 1]]).astype(np.float32))

    def gt_pose(self, i: int) -> np.ndarray:
        return self.poses[i]

    def render(self, i: int) -> np.ndarray:
        """(H, W) float32 image of frame i: homography-rasterized textured
        quads, painted far to near."""
        T = self.poses[i]
        R, t = T[:3, :3], T[:3, 3]
        K = np.array([[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1]], np.float32)
        h, w = self.height, self.width
        img = np.full((h, w), 40.0, np.float32)

        cam_pts = self.points @ R.T + t
        z = cam_pts[:, 2]
        cth, sth = np.cos(self.quad_theta), np.sin(self.quad_theta)
        U = np.stack([cth, sth, np.zeros_like(cth)], -1) * self.quad_half[:, :1]
        V = np.stack([-sth, cth, np.zeros_like(cth)], -1) * self.quad_half[:, 1:2]
        items = [(z[j], R @ U[j], R @ V[j], cam_pts[j], self.quad_tex[j]) for j in range(len(self.points))]
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
                "ab,byx->ayx", Hinv,
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
        if self.brightness_drift != 0.0:
            sfrac = i / max(self.n_frames - 1, 1)
            gain = 1.0 + self.brightness_drift * np.sin(2 * np.pi * sfrac)
            img = np.clip(img * gain, 0.0, 255.0)
        return img


def make(scene: dict, camera: dict, seed: int) -> QuadScene:
    kw = {k: v for k, v in scene.items() if k != "renderer"}
    return QuadScene(camera, seed=seed, **kw)
