"""Per-frame record: fixed-capacity keypoint tensors and marker observations.

Port of `ucoslam_tpu/mapping/frame.py`, plus the keyframe-slot view of
`slam/mapmanager.py` (`frame_from_kf`) and the bundled device->host copy
(`fetch_to_host`). Descriptors are (N, 8) int32 tensors holding the
reference's uint32 bits. A frame's markers are host numpy arrays, as the
reference's detector leaves them: every consumer (the tracker's marker rows,
the marker map, the keyframe policy) reads them on the host, and the
detector fetches them from the device in one transfer.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

#: marker observation slots per frame (the reference's MAX_MARKERS_PER_FRAME)
MAX_MARKERS_PER_FRAME = 16


@dataclass
class FrameMarkers:
    """ArUco observations of one frame, padded to MAX_MARKERS_PER_FRAME
    slots (host numpy): two IPPE poses per marker and the ratio of their
    reprojection errors."""

    id: np.ndarray  # (M,) int32 aruco id, -1 = empty slot
    corners: np.ndarray  # (M, 4, 2) float32 raw pixel corners
    und_corners: np.ndarray  # (M, 4, 2) float32 undistorted corners
    pose1: np.ndarray  # (M, 4, 4) float32 best IPPE pose (marker -> camera)
    pose2: np.ndarray  # (M, 4, 4) float32 second IPPE pose
    err_ratio: np.ndarray  # (M,) float32 err2 / err1 (>= 1; large = unambiguous)
    valid: np.ndarray  # (M,) bool


def empty_markers(m: int = MAX_MARKERS_PER_FRAME) -> FrameMarkers:
    eye = np.broadcast_to(np.eye(4, dtype=np.float32), (m, 4, 4)).copy()
    return FrameMarkers(
        id=np.full(m, -1, np.int32),
        corners=np.zeros((m, 4, 2), np.float32),
        und_corners=np.zeros((m, 4, 2), np.float32),
        pose1=eye,
        pose2=eye.copy(),
        err_ratio=np.zeros(m, np.float32),
        valid=np.zeros(m, bool),
    )


def markers_from_numpy(leaves) -> FrameMarkers:
    """FrameMarkers from a mapping or an object with the fields (e.g. the
    reference's FrameMarkers), each leaf copied to numpy."""
    get = leaves.get if isinstance(leaves, dict) else lambda k: getattr(leaves, k)
    dtypes = dict(id=np.int32, valid=bool)
    return FrameMarkers(**{
        f.name: np.array(get(f.name), dtypes.get(f.name, np.float32)) for f in dataclasses.fields(FrameMarkers)
    })


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
    markers: FrameMarkers = field(default_factory=empty_markers)

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
    `_asdict()` converted leaf by leaf); `markers`, when given, is a mapping
    or an object holding the marker fields (empty markers otherwise)."""
    kw = {
        f.name: tensor_from_numpy(arrays[f.name], device)
        for f in dataclasses.fields(Frame)
        if f.name not in ("fseq", "markers")
    }
    markers = arrays.get("markers")
    return Frame(fseq=int(np.asarray(arrays["fseq"])), markers=empty_markers() if markers is None
                 else markers_from_numpy(markers), **kw)
