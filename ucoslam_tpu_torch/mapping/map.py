"""The world state: fixed-capacity tensors of points, keyframes and markers.

Port of part of `ucoslam_tpu/mapping/map.py`: the `MapState` arenas, the
host `Map` wrapper with its slot arenas, the per-frame point statistics and
the map signature (bit-identical to the reference's for the same content).
Insertion, culling and the covisibility queries are not ported yet.
"""

from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from ucoslam_tpu_torch.config import Params
from ucoslam_tpu_torch.mapping.arena import Arena
from ucoslam_tpu_torch.mapping.frame import tensor_from_numpy


@dataclass
class MapState:
    """All device-resident world state (same fields as the reference)."""

    # ---- map points (P slots) ----
    pt_pos: torch.Tensor  # (P, 3) float32 world position
    pt_normal: torch.Tensor  # (P, 3) float32 mean viewing direction
    pt_desc: torch.Tensor  # (P, 8) int32 (uint32 bits) representative descriptor
    pt_min_dist: torch.Tensor  # (P,) float32 scale-invariance near bound
    pt_max_dist: torch.Tensor  # (P,) float32 far bound
    pt_flags: torch.Tensor  # (P,) int32
    pt_n_seen: torch.Tensor  # (P,) int32 frames where matched
    pt_n_visible: torch.Tensor  # (P,) int32 frames where in frustum
    pt_creation_kf: torch.Tensor  # (P,) int32
    pt_active: torch.Tensor  # (P,) bool
    # ---- keyframes (K slots, N keypoint slots each) ----
    kf_pose: torch.Tensor  # (K, 4, 4) float32 pose_f2g
    kf_fseq: torch.Tensor  # (K,) int32
    kf_active: torch.Tensor  # (K,) bool
    kf_xy: torch.Tensor  # (K, N, 2) float32
    kf_octave: torch.Tensor  # (K, N) int32
    kf_desc: torch.Tensor  # (K, N, 8) int32 (uint32 bits)
    kf_depth: torch.Tensor  # (K, N) float32
    kf_kpt_valid: torch.Tensor  # (K, N) bool
    kf_ids: torch.Tensor  # (K, N) int32 point slot or -1
    # ---- markers (M slots) ----
    mk_id: torch.Tensor  # (M,) int32
    mk_pose: torch.Tensor  # (M, 4, 4) float32 pose_g2m
    mk_pose_valid: torch.Tensor  # (M,) bool
    mk_size: torch.Tensor  # (M,) float32
    mk_active: torch.Tensor  # (M,) bool
    kf_mk_slot: torch.Tensor  # (K, Mf) int32
    kf_mk_corners: torch.Tensor  # (K, Mf, 4, 2) float32

    @property
    def P(self) -> int:
        return self.pt_pos.shape[0]

    @property
    def K(self) -> int:
        return self.kf_pose.shape[0]

    @property
    def N(self) -> int:
        return self.kf_xy.shape[1]


def map_state_from_numpy(arrays: dict[str, np.ndarray], device) -> MapState:
    """MapState from numpy arrays keyed by field name: a checkpoint's
    `state/*` entries, or a reference MapState's fields as numpy."""
    names = [f.name for f in dataclasses.fields(MapState)]
    missing = set(names) - set(arrays)
    if missing:
        raise KeyError(f"MapState fields missing: {sorted(missing)}")
    return MapState(**{k: tensor_from_numpy(arrays[k], device) for k in names})


class Map:
    """Host-side owner of a MapState plus the slot arenas."""

    def __init__(self, params: Params, state: MapState):
        self.params = params
        self.state = state
        self.points = Arena(state.P)
        self.keyframes = Arena(state.K)
        self.markers = Arena(state.mk_id.shape[0])

    @property
    def n_points(self) -> int:
        return self.points.n_active

    @property
    def n_keyframes(self) -> int:
        return self.keyframes.n_active

    def bump_point_stats(self, vis_mask: torch.Tensor, seen_mask: torch.Tensor) -> None:
        """Increment the per-point visible/seen counters (in place)."""
        self.state.pt_n_visible += vis_mask.to(torch.int32)
        self.state.pt_n_seen += seen_mask.to(torch.int32)

    def signature(self) -> int:
        """Deterministic content hash; equal to the reference's signature of
        the same map (same fields, dtypes, quantization and order)."""
        h = hashlib.blake2b(digest_size=8)
        st = self.state
        fields = (st.pt_pos, st.pt_active, st.kf_pose, st.kf_active, st.kf_ids, st.mk_id, st.mk_pose)
        for t, quant in zip(fields, (1e4, None, 1e4, None, None, None, 1e4)):
            a = t.cpu().numpy()
            if quant is not None:
                a = np.round(a.astype(np.float64) * quant).astype(np.int64)
            h.update(a.tobytes())
        return int.from_bytes(h.digest(), "little")
