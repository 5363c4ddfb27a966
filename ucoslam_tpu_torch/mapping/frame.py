"""Per-frame record: fixed-capacity keypoint tensors (monocular fields).

Port of `ucoslam_tpu/mapping/frame.py` without the marker observations
(markers are not ported yet), plus the keyframe-slot view of
`slam/mapmanager.py` (`frame_from_kf`) and the bundled device->host copy
(`fetch_to_host`). Descriptors are (N, 8) int32 tensors holding the
reference's uint32 bits.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

#: marker observation slots per frame (the reference's MAX_MARKERS_PER_FRAME)
MAX_MARKERS_PER_FRAME = 16


@dataclass
class Frame:
    """One processed input frame (arrays fixed-capacity, masked by `valid`)."""

    fseq: int  # frame sequence index
    xy: torch.Tensor  # (N, 2) float32 raw keypoint pixels (level 0)
    und_xy: torch.Tensor  # (N, 2) float32 undistorted pixels
    octave: torch.Tensor  # (N,) int32
    angle: torch.Tensor  # (N,) float32
    response: torch.Tensor  # (N,) float32
    desc: torch.Tensor  # (N, 8) int32 (uint32 bits)
    depth: torch.Tensor  # (N,) float32; 0 = no depth (mono)
    valid: torch.Tensor  # (N,) bool
    ids: torch.Tensor  # (N,) int32 map-point slot or -1
    pose_f2g: torch.Tensor  # (4, 4) float32 global -> camera

    @property
    def n(self) -> int:
        return self.xy.shape[0]

    def replace(self, **kw) -> "Frame":
        return dataclasses.replace(self, **kw)


def empty_frame(n: int, device) -> Frame:
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return Frame(
        fseq=-1,
        xy=torch.zeros(n, 2, **f32),
        und_xy=torch.zeros(n, 2, **f32),
        octave=torch.zeros(n, **i32),
        angle=torch.zeros(n, **f32),
        response=torch.zeros(n, **f32),
        desc=torch.zeros(n, 8, **i32),
        depth=torch.zeros(n, **f32),
        valid=torch.zeros(n, dtype=torch.bool, device=device),
        ids=torch.full((n,), -1, **i32),
        pose_f2g=torch.eye(4, **f32),
    )


def frame_from_kf(state, slot: int) -> Frame:
    """Keyframe slot `slot` of a MapState as a Frame view (no copies): the
    stored keypoints are undistorted, and keyframes keep no angle or
    response, so those are zero, as in the reference's mapmanager."""
    n = state.N
    zeros = torch.zeros(n, dtype=torch.float32, device=state.kf_xy.device)
    return Frame(
        fseq=int(state.kf_fseq[slot]),
        xy=state.kf_xy[slot],
        und_xy=state.kf_xy[slot],
        octave=state.kf_octave[slot],
        angle=zeros,
        response=zeros,
        desc=state.kf_desc[slot],
        depth=state.kf_depth[slot],
        valid=state.kf_kpt_valid[slot],
        ids=state.kf_ids[slot],
        pose_f2g=state.kf_pose[slot],
    )


def fetch_to_host(*tensors: torch.Tensor) -> list[np.ndarray]:
    """Copy several tensors to the host in ONE device->host transfer: each is
    bit-cast (float32) or converted (bool, integers) to int32, concatenated,
    copied once, and split again."""
    flat = torch.cat([
        t.reshape(-1).view(torch.int32) if t.dtype == torch.float32
        else t.reshape(-1).to(torch.int32)
        for t in tensors
    ]).cpu().numpy()
    out, start = [], 0
    for t in tensors:
        a = flat[start : start + t.numel()].reshape(tuple(t.shape))
        start += t.numel()
        if t.dtype == torch.float32:
            a = a.view(np.float32)
        elif t.dtype == torch.bool:
            a = a != 0
        out.append(a)
    return out


def tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """numpy -> tensor on `device` (a copy: the port updates some state in
    place); uint32 arrays keep their bits as int32."""
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def frame_from_numpy(arrays: dict, device) -> Frame:
    """Frame from numpy arrays keyed by field name (e.g. a reference Frame's
    `_asdict()` converted leaf by leaf); marker fields are ignored."""
    kw = {
        f.name: tensor_from_numpy(arrays[f.name], device)
        for f in dataclasses.fields(Frame)
        if f.name != "fseq"
    }
    return Frame(fseq=int(np.asarray(arrays["fseq"])), **kw)
