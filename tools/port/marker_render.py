"""Rendered frames with markers of any dictionary, for tests and chip_smoke.

Both packages' synthetic renderers draw ARUCO_MIP_36h12 markers only, and
neither has an option for another dictionary. `rendered_dictionary` replaces
the port's renderer's `marker_texture` for the run only, so that the
scene's marker k is drawn as codeword `ids[k]` of `name`; the frames it
renders go to both packages' detectors as the same pixels. Imports nothing
of the JAX package.
"""

from __future__ import annotations

import contextlib

import numpy as np


def spread_ids(name: str, scene_ids) -> dict:
    """{scene marker id: codeword id}, the codewords spread over the
    dictionary, its first and last among them."""
    from ucoslam_tpu_torch.markers.dictionary import resolve

    scene_ids = sorted(scene_ids)
    size = resolve(name).size
    words = np.round(np.linspace(0, size - 1, len(scene_ids))).astype(int)
    return {int(s): int(w) for s, w in zip(scene_ids, words)}


@contextlib.contextmanager
def rendered_dictionary(name: str, ids, flip: tuple | None = None):
    """Inside, ucoslam_tpu_torch.io.synthetic draws the scene's marker k as
    codeword `ids[k]` of dictionary `name` ({scene id: codeword id}, as
    `spread_ids` gives; the renderer passes scene ids below 250 as they
    are); flip = (codeword id, row, col) draws that codeword with one code
    cell inverted. The renderer's own texture is restored on exit."""
    from ucoslam_tpu_torch.io import synthetic
    from ucoslam_tpu_torch.markers import dictionary

    orig = synthetic.marker_texture

    def texture(mid, px_per_cell=8, quiet_cells=1, name_=None):
        word = int(ids[mid])
        if flip is None or flip[0] != word:
            return dictionary.marker_texture(word, px_per_cell, quiet_cells, name=name)
        cells = dictionary.marker_bitmap(word, name)
        cells[1 + flip[1], 1 + flip[2]] ^= 1
        cells = np.pad(cells, quiet_cells, constant_values=1)
        tex = (np.kron(cells, np.ones((px_per_cell, px_per_cell), np.uint8)) * 255).astype(np.float32)
        n = cells.shape[0] - 2 * quiet_cells
        return tex, (n + 2 * quiet_cells) / n

    synthetic.marker_texture = texture
    try:
        yield
    finally:
        synthetic.marker_texture = orig


#: the marker views of `dictionary_frames`: per view, each marker's centre in
#: the camera (x right, y down, z forward, metres) and its turn about the
#: camera's x and y axes and about its own normal (degrees). The normal turns
#: of 0, 90, 180 and 270 make the decoder find every rotation of a code.
VIEWS = (
    ((-0.55, -0.45, 3.0, 20, -15, 0), (0.55, -0.45, 3.2, -15, 25, 90),
     (0.55, 0.45, 3.0, 10, 20, 180), (-0.55, 0.45, 3.4, -20, -10, 270)),
    ((-0.8, -0.1, 4.2, 35, 0, 30), (0.1, 0.0, 4.6, 0, -40, 120), (0.9, 0.1, 4.0, -30, 30, 225)),
)


def _rot(axis: int, deg: float) -> np.ndarray:
    c, s = np.cos(np.radians(deg)), np.sin(np.radians(deg))
    i, j = [(1, 2), (2, 0), (0, 1)][axis]
    R = np.eye(3)
    R[i, i], R[i, j], R[j, i], R[j, j] = c, -s, s, c
    return R


def dictionary_frames(name: str, marker_size: float = 0.6, seed: int = 5, flip: tuple | None = None) -> list:
    """Frames at the library's widths (640x480) with markers of dictionary
    `name` in view -> [(gray uint8 (480, 640), {codeword id: (4, 2) corners
    projected from the marker's pose})]: the port's renderer on the markers
    scene's background (`SyntheticSequence`, 1600 points), its markers moved
    to the poses of VIEWS in front of frame 0's camera and drawn as codewords
    spread over the dictionary (`spread_ids`; the views take different
    ones); `flip` as rendered_dictionary's."""
    from ucoslam_tpu_torch.geometry.camera import CameraParams
    from ucoslam_tpu_torch.io.synthetic import SyntheticSequence

    cam = CameraParams.create(500.0, 500.0, 320.0, 240.0)
    seq = SyntheticSequence(n_frames=1, n_points=1600, n_markers=sum(map(len, VIEWS)), marker_size=marker_size,
                            seed=seed)
    every = spread_ids(name, seq.marker_poses)
    cam_to_world = np.linalg.inv(seq.gt_pose(0).astype(np.float64))
    face = np.diag([1.0, -1.0, -1.0])  # the marker's normal towards the camera
    out, scene_ids = [], iter(sorted(every))
    for view in VIEWS:
        poses = {}
        for x, y, z, ax, ay, roll in view:
            T = np.eye(4)
            T[:3, :3] = _rot(0, ax) @ _rot(1, ay) @ face @ _rot(2, roll)
            T[:3, 3] = (x, y, z)
            poses[next(scene_ids)] = (cam_to_world @ T).astype(np.float32)
        seq._marker_detector.poses = poses
        with rendered_dictionary(name, every, flip):
            gray = np.clip(seq.render(0), 0, 255).astype(np.uint8)
        oracle = seq._marker_detector.detect_at_pose(seq.gt_pose(0), cam)
        corners = {every[int(i)]: np.asarray(c, np.float32) for i, c, v in zip(oracle.id, oracle.corners, oracle.valid)
                   if v}
        if len(corners) != len(view):
            raise RuntimeError(f"a marker of the view left the image: {sorted(corners)}")
        out.append((gray, corners))
    return out


def dictionary_scene(name: str, sequence: dict, cam=None):
    """The port's SyntheticSequence(**sequence) with its markers drawn as
    codewords of dictionary `name` -> (seq, ids {scene id: codeword id},
    renders of every frame, truth {codeword id: marker -> world pose}). The
    same pixels go to both packages (the renders are float32 0..255)."""
    from ucoslam_tpu_torch.io.synthetic import SyntheticSequence

    seq = SyntheticSequence(cam=cam, **sequence)
    ids = spread_ids(name, seq.marker_poses)
    with rendered_dictionary(name, ids):
        images = [seq.render(i) for i in range(seq.n_frames)]
    truth = {ids[s]: pose for s, pose in seq.marker_poses.items()}
    return seq, ids, images, truth
