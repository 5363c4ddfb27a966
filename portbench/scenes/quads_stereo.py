"""Frozen copy of the port's rectified stereo pair, on the frozen quad scene.

Copied from `ucoslam_tpu_torch/io/synthetic.py` (`SyntheticSequence.render_stereo`:
the right camera sits the baseline `bl` along the left camera's +x), in numpy
alone, over `portbench/scenes/quads.py`'s scene and renderer, so that the
benchmark's pairs do not move when the program's copy changes.

`world_scale` scales the scene about the world's origin: its points, its quads'
half-sizes, and the eye and centre of the trajectory, which scales each pose's
translation and leaves its rotation. Scaled by a power of two, the left image
is the unscaled scene's bit for bit (every projection is a ratio of two numbers
scaled alike); the right image sees the same world from `bl` metres away, so
the disparities are those of the scaled depths.

`make(scene: dict, camera: dict, seed: int)` -> an object with `n_frames`,
`render_stereo(i)` -> (left, right) float32 images and `gt_pose(i)`, the
metric world->left-camera pose.
"""

from __future__ import annotations

import os

import numpy as np

from portbench.core import manifest

#: the frozen renderer's own module (its source is part of a clip's cache key)
QUADS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "quads.py")


class StereoQuadScene:
    """`quads.QuadScene` at `world_scale`, seen by a rectified pair `bl`
    metres apart."""

    def __init__(self, camera: dict, seed: int = 0, world_scale: float = 1.0, **scene):
        self.mono = manifest.scene_module("quads").QuadScene(camera, seed=seed, **scene)
        self.bl = float(camera["bl"])
        self.n_frames = self.mono.n_frames
        s = np.float32(world_scale)
        self.mono.points = (self.mono.points * s).astype(np.float32)
        self.mono.quad_half = (self.mono.quad_half * s).astype(np.float32)
        for T in self.mono.poses:
            T[:3, 3] *= s  # t = -R @ eye: the eye and the centre scaled, R unchanged

    def gt_pose(self, i: int) -> np.ndarray:
        return self.mono.gt_pose(i)

    def render(self, i: int) -> np.ndarray:
        return self.mono.render(i)

    def render_stereo(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """(left, right) rectified pair of frame i: the right camera sits the
        baseline along the left camera's +x (x_r = x_l - bl)."""
        left = self.mono.render(i)
        saved = self.mono.poses[i]
        T_r = saved.copy()
        T_r[0, 3] -= self.bl
        self.mono.poses[i] = T_r
        try:
            right = self.mono.render(i)
        finally:
            self.mono.poses[i] = saved
        return left, right


def make(scene: dict, camera: dict, seed: int) -> StereoQuadScene:
    kw = {k: v for k, v in scene.items() if k != "renderer"}
    return StereoQuadScene(camera, seed=seed, **kw)
