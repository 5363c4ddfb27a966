"""Per-frame record: fixed-capacity keypoint tensors (monocular fields).

Port of `ucoslam_tpu/mapping/frame.py` without the marker observations
(markers are not ported yet). Descriptors are (N, 8) int32 tensors holding
the reference's uint32 bits.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch


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
