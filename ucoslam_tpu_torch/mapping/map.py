"""The world state: fixed-capacity tensors of points, keyframes and markers.

Port of `ucoslam_tpu/mapping/map.py`: the `MapState` arenas; the batch ops
that mutate and query them (`op_*`, each returning a new MapState, as the
reference's jitted ops do); and the host `Map` wrapper with its slot arenas,
capacity growth, cached host mirror and signature (bit-identical to the
reference's for the same content).

Two reductions differ in method from the reference and not in result:
`op_covis_matrix` multiplies the {0,1} incidence in float32 with TF32 off
(exact below 2^24; the reference uses bf16 operands), and
`op_update_point_stats` sums viewing directions per point in a fixed order
(a sorted table, not a scatter-add, whose atomic order on the card is not
fixed) and takes the descriptor maximum as unsigned on the int32 bits.
"""

from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from ucoslam_tpu_torch.config import Params
from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.mapping.arena import Arena
from ucoslam_tpu_torch.mapping.frame import MAX_MARKERS_PER_FRAME, Frame, fetch_to_host, tensor_from_numpy

# point status flags (reference mappoint.h flags BAD/STABLE/STEREO)
FLAG_BAD = 1
FLAG_STABLE = 2
FLAG_STEREO = 4

_INT32_MIN = -(2**31)  # xor with it maps unsigned order onto signed order


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

    def replace(self, **kw) -> "MapState":
        return dataclasses.replace(self, **kw)


def empty_map_state(params: Params, device) -> MapState:
    P, K, N, M = params.maxMapPoints, params.maxKeyFrames, params.maxKeyPointsPerFrame, params.maxMarkers
    Mf = MAX_MARKERS_PER_FRAME
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    b = dict(dtype=torch.bool, device=device)
    return MapState(
        pt_pos=torch.zeros(P, 3, **f32),
        pt_normal=torch.zeros(P, 3, **f32),
        pt_desc=torch.zeros(P, 8, **i32),
        pt_min_dist=torch.zeros(P, **f32),
        pt_max_dist=torch.full((P,), 1e9, **f32),
        pt_flags=torch.zeros(P, **i32),
        pt_n_seen=torch.zeros(P, **i32),
        pt_n_visible=torch.zeros(P, **i32),
        pt_creation_kf=torch.zeros(P, **i32),
        pt_active=torch.zeros(P, **b),
        kf_pose=torch.eye(4, **f32).repeat(K, 1, 1),
        kf_fseq=torch.full((K,), -1, **i32),
        kf_active=torch.zeros(K, **b),
        kf_xy=torch.zeros(K, N, 2, **f32),
        kf_octave=torch.zeros(K, N, **i32),
        kf_desc=torch.zeros(K, N, 8, **i32),
        kf_depth=torch.zeros(K, N, **f32),
        kf_kpt_valid=torch.zeros(K, N, **b),
        kf_ids=torch.full((K, N), -1, **i32),
        mk_id=torch.full((M,), -1, **i32),
        mk_pose=torch.eye(4, **f32).repeat(M, 1, 1),
        mk_pose_valid=torch.zeros(M, **b),
        mk_size=torch.zeros(M, **f32),
        mk_active=torch.zeros(M, **b),
        kf_mk_slot=torch.full((K, Mf), -1, **i32),
        kf_mk_corners=torch.zeros(K, Mf, 4, 2, **f32),
    )


def map_state_from_numpy(arrays: dict[str, np.ndarray], device) -> MapState:
    """MapState from numpy arrays keyed by field name: a checkpoint's
    `state/*` entries, or a reference MapState's fields as numpy."""
    names = [f.name for f in dataclasses.fields(MapState)]
    missing = set(names) - set(arrays)
    if missing:
        raise KeyError(f"MapState fields missing: {sorted(missing)}")
    return MapState(**{k: tensor_from_numpy(arrays[k], device) for k in names})


def map_state_to_numpy(state: MapState) -> dict[str, np.ndarray]:
    """MapState -> numpy arrays keyed by field name, descriptors as uint32
    (the reference's dtype), so the reference reads what the port wrote."""
    out = {}
    for f in dataclasses.fields(MapState):
        a = getattr(state, f.name).cpu().numpy()
        out[f.name] = a.view(np.uint32) if f.name in ("pt_desc", "kf_desc") else a
    return out


# ----------------------------------------------------------------------
# Batch ops over MapState (each returns a new MapState)
# ----------------------------------------------------------------------


def _set_rows(t: torch.Tensor, index, values) -> torch.Tensor:
    out = t.clone()
    out[index] = values
    return out


def op_add_keyframe(state: MapState, slot: int, frame: Frame) -> MapState:
    """Write a frame into keyframe slot `slot`."""
    return state.replace(
        kf_pose=_set_rows(state.kf_pose, slot, frame.pose_f2g),
        kf_fseq=_set_rows(state.kf_fseq, slot, int(frame.fseq)),
        kf_active=_set_rows(state.kf_active, slot, True),
        kf_xy=_set_rows(state.kf_xy, slot, frame.und_xy),
        kf_octave=_set_rows(state.kf_octave, slot, frame.octave),
        kf_desc=_set_rows(state.kf_desc, slot, frame.desc),
        kf_depth=_set_rows(state.kf_depth, slot, frame.depth),
        kf_kpt_valid=_set_rows(state.kf_kpt_valid, slot, frame.valid),
        kf_ids=_set_rows(state.kf_ids, slot, frame.ids),
    )


def op_add_points(
    state: MapState,
    slots: torch.Tensor,  # (B,) int32 target slots (from the arena)
    use: torch.Tensor,  # (B,) bool which rows are real
    pos: torch.Tensor,  # (B, 3)
    normal: torch.Tensor,  # (B, 3)
    desc: torch.Tensor,  # (B, 8) int32 bits
    min_dist: torch.Tensor,  # (B,)
    max_dist: torch.Tensor,  # (B,)
    flags: torch.Tensor,  # (B,) int32
    creation_kf: int,
) -> MapState:
    """Batched point creation: the rows with use=True go to their slots
    with seen/visible counts 1; the other rows write nothing."""
    s = slots[use].long()
    n = s.shape[0]
    i32 = dict(dtype=torch.int32, device=s.device)
    return state.replace(
        pt_pos=_set_rows(state.pt_pos, s, pos[use]),
        pt_normal=_set_rows(state.pt_normal, s, normal[use]),
        pt_desc=_set_rows(state.pt_desc, s, desc[use]),
        pt_min_dist=_set_rows(state.pt_min_dist, s, min_dist[use]),
        pt_max_dist=_set_rows(state.pt_max_dist, s, max_dist[use]),
        pt_flags=_set_rows(state.pt_flags, s, flags[use]),
        pt_n_seen=_set_rows(state.pt_n_seen, s, torch.ones(n, **i32)),
        pt_n_visible=_set_rows(state.pt_n_visible, s, torch.ones(n, **i32)),
        pt_creation_kf=_set_rows(state.pt_creation_kf, s, torch.full((n,), creation_kf, **i32)),
        pt_active=_set_rows(state.pt_active, s, True),
    )


def op_set_observations(state: MapState, kf_slot: int, kpt_idx: torch.Tensor, point_ids: torch.Tensor) -> MapState:
    """Assign keyframe keypoints -> map points; kpt_idx -1 rows are ignored."""
    use = kpt_idx >= 0
    row = state.kf_ids[kf_slot].clone()
    row[kpt_idx[use].long()] = point_ids[use].to(torch.int32)
    return state.replace(kf_ids=_set_rows(state.kf_ids, kf_slot, row))


def op_remove_points(state: MapState, remove_mask: torch.Tensor) -> MapState:
    """Deactivate points and clear their observations everywhere."""
    ids = state.kf_ids
    dead = remove_mask[ids.clamp(min=0).long()] & (ids >= 0)
    return state.replace(pt_active=state.pt_active & ~remove_mask, kf_ids=torch.where(dead, -1, ids))


def op_remove_keyframes(state: MapState, remove_mask: torch.Tensor) -> MapState:
    """Deactivate keyframes and drop their observations."""
    return state.replace(
        kf_active=state.kf_active & ~remove_mask,
        kf_ids=torch.where(remove_mask[:, None], -1, state.kf_ids),
        kf_kpt_valid=state.kf_kpt_valid & ~remove_mask[:, None],
        kf_mk_slot=torch.where(remove_mask[:, None], -1, state.kf_mk_slot),
    )


def op_point_observation_counts(state: MapState) -> torch.Tensor:
    """(P,) int32: observations of each point by active keyframes (a
    keyframe observing a point twice counts twice)."""
    ids = torch.where(state.kf_active[:, None] & (state.kf_ids >= 0), state.kf_ids, state.P)
    counts = torch.bincount(ids.reshape(-1).long(), minlength=state.P + 1)
    return counts[: state.P].to(torch.int32)


def _incidence(state: MapState) -> torch.Tensor:
    """(K, P) float32 {0, 1} observation incidence matrix."""
    ids = torch.where(state.kf_active[:, None] & (state.kf_ids >= 0), state.kf_ids, state.P)
    onehot = torch.zeros(state.K, state.P + 1, dtype=torch.float32, device=ids.device)
    onehot.scatter_(1, ids.long(), 1.0)
    return onehot[:, : state.P]


def op_covis_matrix(state: MapState) -> torch.Tensor:
    """(K, K) int32 covisibility weights = #points co-observed, zero on the
    diagonal. A float32 incidence product (exact below 2^24; TF32 is off,
    see slam/system.disable_tf32)."""
    onehot = _incidence(state)
    covis = (onehot @ onehot.T).to(torch.int32)
    return covis * (1 - torch.eye(state.K, dtype=torch.int32, device=covis.device))


def ordered_segment_sum(values: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """Sum the rows of values (L, C) into n segments (seg (L,) in [0, n)) in
    a fixed order: rows are laid out per segment in their input order and
    each segment is reduced along one axis. The result is the same on every
    run, where an atomic scatter-add's order is not fixed."""
    dev = values.device
    order = torch.argsort(seg, stable=True)
    seg_sorted = seg[order]
    counts = torch.bincount(seg, minlength=n)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(seg.shape[0], device=dev) - starts[seg_sorted]
    width = int(counts.max()) if seg.shape[0] else 0
    table = torch.zeros(n, max(width, 1), values.shape[1], dtype=values.dtype, device=dev)
    table[seg_sorted, rank] = values[order]
    return table.sum(1)


def op_update_point_stats(state: MapState, scale_factor: float, n_levels: int) -> MapState:
    """Refresh per-point viewing normals, scale-invariance bounds and the
    representative descriptor (the observation from the most recent
    observing keyframe) from the current observation set."""
    K, N, P = state.K, state.N, state.P
    dev = state.pt_pos.device
    ids = torch.where(
        state.kf_active[:, None] & state.kf_kpt_valid & (state.kf_ids >= 0), state.kf_ids, P
    )
    flat_ids = ids.reshape(-1).long()
    R = state.kf_pose[:, :3, :3]
    t = state.kf_pose[:, :3, 3]
    centers = -(R.transpose(-1, -2) @ t[..., None])[..., 0]  # (K, 3)
    X = state.pt_pos[torch.where(flat_ids < P, flat_ids, 0)]  # (K*N, 3)
    ray = X - centers.repeat_interleave(N, 0)
    dist = torch.linalg.norm(ray, dim=-1).clamp(min=1e-9)
    dirn = ray / dist[:, None]

    obs = torch.nonzero(flat_ids < P)[:, 0]
    sum_dir = ordered_segment_sum(dirn[obs], flat_ids[obs], P)
    cnt = torch.bincount(flat_ids[obs], minlength=P).to(torch.float32)
    normal = sum_dir / cnt[:, None].clamp(min=1.0)
    nrm = torch.linalg.norm(normal, dim=-1, keepdim=True)
    normal = torch.where(nrm > 1e-6, normal / nrm.clamp(min=1e-9), state.pt_normal)

    log_sf = torch.log(torch.tensor(scale_factor, dtype=torch.float32, device=dev))
    oct_flat = state.kf_octave.reshape(-1).to(torch.float32)
    max_cand = dist * torch.exp(oct_flat * log_sf)
    max_d = torch.full((P + 1,), -1e9, dtype=torch.float32, device=dev)
    max_d = max_d.scatter_reduce(0, flat_ids, max_cand, reduce="amax")
    levels_span = torch.exp((torch.tensor(float(n_levels), device=dev) - 1.0) * log_sf)
    has_obs = cnt > 0
    new_max = torch.where(has_obs, max_d[:P], state.pt_max_dist)
    new_min = torch.where(has_obs, new_max / levels_span, state.pt_min_dist)

    # representative descriptor: the observation from the most recent keyframe
    fseq_flat = state.kf_fseq.repeat_interleave(N)
    best_seq = torch.full((P + 1,), -1, dtype=torch.int32, device=dev)
    best_seq = best_seq.scatter_reduce(0, flat_ids, fseq_flat, reduce="amax")
    is_best = (fseq_flat == best_seq[flat_ids]) & (flat_ids < P)
    tgt = torch.where(is_best, flat_ids, P)
    # an unsigned maximum of the uint32 bits (one keyframe may hold a point
    # twice after fusion): flip the sign bit, take the signed maximum, flip back
    flipped = state.kf_desc.reshape(-1, 8) ^ _INT32_MIN
    new_desc = torch.full((P + 1, 8), _INT32_MIN, dtype=torch.int32, device=dev)
    new_desc = new_desc.scatter_reduce(0, tgt[:, None].expand(-1, 8), flipped, reduce="amax") ^ _INT32_MIN
    new_desc = torch.where(has_obs[:, None], new_desc[:P], state.pt_desc)

    act = state.pt_active
    return state.replace(
        pt_normal=torch.where(act[:, None], normal, state.pt_normal),
        pt_max_dist=torch.where(act, new_max, state.pt_max_dist),
        pt_min_dist=torch.where(act, new_min, state.pt_min_dist),
        pt_desc=torch.where(act[:, None], new_desc, state.pt_desc),
    )


def op_scale_map(state: MapState, s: float) -> MapState:
    """Scale the world (positions, translations, depths) by s."""
    s = torch.tensor(s, dtype=torch.float32, device=state.pt_pos.device)
    kf_pose = state.kf_pose.clone()
    kf_pose[:, :3, 3] *= s
    mk_pose = state.mk_pose.clone()
    mk_pose[:, :3, 3] *= s
    return state.replace(
        pt_pos=state.pt_pos * s,
        pt_min_dist=state.pt_min_dist * s,
        pt_max_dist=state.pt_max_dist * s,
        kf_pose=kf_pose,
        kf_depth=state.kf_depth * s,
        mk_pose=mk_pose,
    )


def op_apply_transform(state: MapState, T: torch.Tensor) -> MapState:
    """Rigidly transform the whole map by T (global' = T @ global)."""
    R, t = T[:3, :3], T[:3, 3]
    return state.replace(
        pt_pos=state.pt_pos @ R.T + t,
        pt_normal=state.pt_normal @ R.T,
        kf_pose=state.kf_pose @ torch.linalg.inv(T),
        mk_pose=T @ state.mk_pose,
    )


# ----------------------------------------------------------------------
# Host wrapper
# ----------------------------------------------------------------------


class Map:
    """Host-side owner of a MapState plus the slot arenas.

    The state and its host mirror are swapped together, as one tuple, so a
    reader on another thread (the tracker while the mapping worker writes)
    never caches one state's values under another. The slot arenas move
    before the state that records them is written; in async mode only the
    worker allocates and frees slots, and the tracker reads a `snapshot()`.
    """

    def __init__(self, params: Params, state: MapState | None = None, device="cuda"):
        self.params = params
        self.state = state if state is not None else empty_map_state(params, device)
        self.points = Arena(self.state.P)
        self.keyframes = Arena(self.state.K)
        self.markers = Arena(self.state.mk_id.shape[0])

    # -- host mirror: fetched fields are cached until the next state write
    @property
    def state(self) -> MapState:
        return self._snap[0]

    @state.setter
    def state(self, v: MapState) -> None:
        self._snap = (v, {})

    @property
    def device(self) -> torch.device:
        return self.state.pt_pos.device

    def h(self, *names: str):
        """Cached host-numpy copies of state fields, the missing ones fetched
        in one bundled transfer: `map.h('pt_active')` or
        `a, b = map.h('pt_active', 'kf_pose')`."""
        st, cache = self._snap
        missing = [n for n in names if n not in cache]
        if missing:
            cache.update(zip(missing, fetch_to_host(*(getattr(st, n) for n in missing))))
        if len(names) == 1:
            return cache[names[0]]
        return tuple(cache[n] for n in names)

    def _cached(self, key: str, op):
        """op(state) fetched once per state, in its host mirror."""
        st, cache = self._snap
        if key not in cache:
            cache[key] = op(st).cpu().numpy()
        return cache[key]

    def snapshot(self) -> "Map":
        """A read-only Map over the state as it is now, with its own host
        mirror and slot arenas rebuilt from that state's liveness masks: what
        the tracker reads for one frame while the mapping worker writes."""
        view = Map.__new__(Map)
        view.params = self.params
        view.state = self.state
        view.points, view.keyframes, view.markers = [
            Arena.of_mask(m) for m in view.h("pt_active", "kf_active", "mk_active")]
        return view

    # -- capacity growth ------------------------------------------------
    def grow_points(self, new_P: int | None = None) -> int:
        P = self.state.P
        new_P = new_P or 2 * P
        if new_P <= P:
            return P
        st = self.state

        def pad(a, fill=0):
            return torch.cat([a, a.new_full((new_P - P,) + a.shape[1:], fill)])

        self.state = st.replace(
            pt_pos=pad(st.pt_pos),
            pt_normal=pad(st.pt_normal),
            pt_desc=pad(st.pt_desc),
            pt_min_dist=pad(st.pt_min_dist),
            pt_max_dist=pad(st.pt_max_dist, fill=1e9),
            pt_flags=pad(st.pt_flags),
            pt_n_seen=pad(st.pt_n_seen),
            pt_n_visible=pad(st.pt_n_visible),
            pt_creation_kf=pad(st.pt_creation_kf),
            pt_active=pad(st.pt_active, fill=False),
        )
        self.points.grow(new_P)
        self.params = self.params.replace(maxMapPoints=new_P)
        return new_P

    def grow_keyframes(self, new_K: int | None = None) -> int:
        K = self.state.K
        new_K = new_K or 2 * K
        if new_K <= K:
            return K
        st = self.state

        def pad(a, fill=0):
            return torch.cat([a, a.new_full((new_K - K,) + a.shape[1:], fill)])

        eye_tail = torch.eye(4, dtype=torch.float32, device=self.device).repeat(new_K - K, 1, 1)
        self.state = st.replace(
            kf_pose=torch.cat([st.kf_pose, eye_tail]),
            kf_fseq=pad(st.kf_fseq, fill=-1),
            kf_active=pad(st.kf_active, fill=False),
            kf_xy=pad(st.kf_xy),
            kf_octave=pad(st.kf_octave),
            kf_desc=pad(st.kf_desc),
            kf_depth=pad(st.kf_depth),
            kf_kpt_valid=pad(st.kf_kpt_valid, fill=False),
            kf_ids=pad(st.kf_ids, fill=-1),
            kf_mk_slot=pad(st.kf_mk_slot, fill=-1),
            kf_mk_corners=pad(st.kf_mk_corners),
        )
        self.keyframes.grow(new_K)
        self.params = self.params.replace(maxKeyFrames=new_K)
        return new_K

    # -- keyframes ------------------------------------------------------
    def add_keyframe(self, frame: Frame) -> int:
        slot = self.keyframes.alloc()
        self.state = op_add_keyframe(self.state, slot, frame)
        return slot

    def remove_keyframes(self, slots) -> None:
        mask = np.zeros(self.state.K, bool)
        mask[np.asarray(slots, int)] = True
        self.state = op_remove_keyframes(self.state, torch.from_numpy(mask).to(self.device))
        self.keyframes.free(slots)

    # -- points ---------------------------------------------------------
    def add_points(self, pos, normal, desc, min_dist, max_dist, flags, creation_kf: int, use=None) -> np.ndarray:
        """Allocate + write up to B points (numpy or tensors); returns slot
        ids (-1 for unused rows)."""
        b = len(pos)
        use = np.ones(b, bool) if use is None else np.asarray(use, bool)
        slots = np.full(b, -1, np.int32)
        slots[use] = self.points.alloc_many(int(use.sum()))
        dev = self.device

        def t(a, dtype):
            if isinstance(a, torch.Tensor):
                return a.to(dev, dtype)
            a = np.asarray(a)
            if a.dtype == np.uint32:
                a = a.view(np.int32)
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

        self.state = op_add_points(
            self.state,
            t(np.where(use, slots, 0).astype(np.int32), torch.int32),
            t(use, torch.bool),
            t(pos, torch.float32),
            t(normal, torch.float32),
            t(desc, torch.int32),
            t(min_dist, torch.float32),
            t(max_dist, torch.float32),
            t(flags, torch.int32),
            int(creation_kf),
        )
        return slots

    def remove_points(self, slots_or_mask) -> None:
        arr = np.asarray(slots_or_mask)
        if arr.dtype == bool:
            mask = arr
        else:
            mask = np.zeros(self.state.P, bool)
            mask[arr.astype(int)] = True
        self.state = op_remove_points(self.state, torch.from_numpy(np.ascontiguousarray(mask)).to(self.device))
        self.points.free(np.nonzero(mask)[0])

    def set_observations(self, kf_slot: int, kpt_idx, point_ids) -> None:
        dev = self.device
        self.state = op_set_observations(
            self.state, kf_slot,
            torch.as_tensor(np.asarray(kpt_idx, np.int32), device=dev),
            torch.as_tensor(np.asarray(point_ids, np.int32), device=dev),
        )

    # -- queries --------------------------------------------------------
    @property
    def n_points(self) -> int:
        return self.points.n_active

    @property
    def n_keyframes(self) -> int:
        return self.keyframes.n_active

    def covis_matrix(self) -> np.ndarray:
        return self._cached("covis_matrix", op_covis_matrix)

    def essential_graph(self, min_weight: int = 15) -> list[tuple[int, int, float]]:
        """Essential graph over the active keyframes: the maximum spanning
        tree of the covisibility graph (Kruskal; equal weights keep the
        candidates' order: covisible pairs in row-major order, then the
        temporal bridges) plus every edge of weight >= min_weight.
        Disconnected covisibility components are bridged by weight-1 edges
        between keyframes adjacent in time, so the result always spans.
        -> (slot_a, slot_b, weight) with slot_a < slot_b."""
        slots = self.keyframes.active_slots()
        if len(slots) < 2:
            return []
        covis = self.covis_matrix()
        order = np.argsort(self.h("kf_fseq")[slots])
        sub = covis[np.ix_(slots, slots)]
        ia, ib = np.nonzero(np.triu(sub, 1) > 0)
        cand = {(int(slots[x]), int(slots[y])): float(sub[x, y]) for x, y in zip(ia, ib)}
        for x, y in zip(order[:-1], order[1:]):
            a, b = sorted((int(slots[x]), int(slots[y])))
            cand.setdefault((a, b), 1.0)
        parent = {int(s): int(s) for s in slots}

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        edges = []
        for (a, b), w in sorted(cand.items(), key=lambda kv: -kv[1]):
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[rb] = ra
                edges.append((a, b, w))
        tree = {(a, b) for a, b, _ in edges}
        edges += [(a, b, w) for (a, b), w in cand.items() if w >= min_weight and (a, b) not in tree]
        return edges

    def global_reproj_chi2(self, cam: CameraParams) -> float:
        """Mean reprojection chi2 over every observation of an active
        keyframe with a valid keypoint and positive depth."""
        st = self.state
        ids = st.kf_ids
        pt = st.pt_pos[ids.clamp(min=0).long()]  # (K, N, 3)
        cam_pts = torch.einsum("kij,knj->kni", st.kf_pose[:, :3, :3], pt) + st.kf_pose[:, None, :3, 3]
        r = cam.project(cam_pts) - st.kf_xy
        log_sf = torch.log(torch.tensor(1.2, dtype=torch.float32, device=ids.device))
        chi2 = (r * r).sum(-1) / torch.exp(2.0 * st.kf_octave.to(torch.float32) * log_sf)
        ok = (ids >= 0) & st.kf_active[:, None] & st.kf_kpt_valid & (cam_pts[..., 2] > 0)
        total = torch.where(ok, chi2, 0.0).sum()
        return float(total / ok.sum().clamp(min=1))

    def point_observation_counts(self) -> np.ndarray:
        return self._cached("point_obs_counts", op_point_observation_counts)

    def bump_point_stats(self, vis_mask: torch.Tensor, seen_mask: torch.Tensor) -> None:
        """Increment the per-point visible/seen counters. Runs every tracked
        frame and touches only the two counters, so only they leave the
        host mirror."""
        st, cache = self._snap
        st = st.replace(
            pt_n_visible=st.pt_n_visible + vis_mask.to(torch.int32),
            pt_n_seen=st.pt_n_seen + seen_mask.to(torch.int32),
        )
        self._snap = (st, {k: v for k, v in cache.items() if k not in ("pt_n_seen", "pt_n_visible")})

    def scale(self, s: float) -> None:
        self.state = op_scale_map(self.state, s)

    def apply_transform(self, T) -> None:
        self.state = op_apply_transform(self.state, torch.as_tensor(np.asarray(T, np.float32), device=self.device))

    def center_ref_system_in_marker(self, marker_id: int) -> bool:
        """Re-anchor the map's reference system at a marker (its pose
        becomes the identity). -> whether the marker has a map pose."""
        mk_id, mk_valid = self.h("mk_id", "mk_pose_valid")
        hits = np.nonzero((mk_id == marker_id) & mk_valid)[0]
        if len(hits) == 0:
            return False
        self.apply_transform(np.linalg.inv(self.h("mk_pose")[hits[0]]).astype(np.float32))
        return True

    def set_markers(self, slots, **fields) -> None:
        """Write the rows `slots` of marker fields (`mk_id=[...]`,
        `mk_pose=(n, 4, 4)`, ...) given as host arrays."""
        idx = torch.as_tensor(np.asarray(slots, np.int64), device=self.device)
        updates = {}
        for name, values in fields.items():
            t = getattr(self.state, name).clone()
            t[idx] = torch.as_tensor(np.asarray(values), device=self.device).to(t.dtype)
            updates[name] = t
        self.state = self.state.replace(**updates)

    def frame_median_depth(self, kf_slot: int) -> float:
        """Median depth of the points a keyframe observes."""
        kf_ids, kf_pose, pt_pos = self.h("kf_ids", "kf_pose", "pt_pos")
        ids = kf_ids[kf_slot]
        obs = ids[ids >= 0]
        if len(obs) == 0:
            return 1.0
        T = kf_pose[kf_slot]
        z = (pt_pos[obs] @ T[:3, :3].T + T[:3, 3])[:, 2]
        return float(np.median(z))

    def remove_unused_keypoints(self) -> int:
        """Invalidate keyframe keypoints with no map-point assignment
        (counterpart utils/ucoslam_map_removeunusedkeypoint, map.h:61).
        Shrinks matching work and serialized size. Returns #removed."""
        st = self.state
        used = st.kf_kpt_valid & (st.kf_ids >= 0)
        removed = int(st.kf_kpt_valid.sum()) - int(used.sum())
        self.state = st.replace(kf_kpt_valid=used)
        return removed

    # -- export (map.h:65 pcd/ply) --------------------------------------
    def export_pointcloud(self, path: str, with_keyframes: bool = True) -> None:
        """Write active points (+ keyframe centers) as ascii PLY, or PCD when
        the path ends in .pcd; the same text as the reference's for the same
        map."""
        pt_pos, pt_active, kf_active, kf_pose = self.h("pt_pos", "pt_active", "kf_active", "kf_pose")
        pts = pt_pos[pt_active]
        colors = np.tile(np.asarray([[90, 200, 90]], np.uint8), (len(pts), 1))
        if with_keyframes:
            poses = kf_pose[kf_active]
            centers = np.stack([-P[:3, :3].T @ P[:3, 3] for P in poses]) if len(poses) else np.zeros((0, 3))
            pts = np.concatenate([pts, centers])
            colors = np.concatenate([colors, np.tile(np.asarray([[240, 120, 80]], np.uint8), (len(centers), 1))])
        with open(path, "w") as f:
            if path.endswith(".pcd"):
                f.write(
                    "# .PCD v0.7 - Point Cloud Data\nVERSION 0.7\n"
                    "FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
                    f"WIDTH {len(pts)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
                    f"POINTS {len(pts)}\nDATA ascii\n"
                )
                for p in pts:
                    f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
            else:
                f.write(
                    "ply\nformat ascii 1.0\n"
                    f"element vertex {len(pts)}\n"
                    "property float x\nproperty float y\nproperty float z\n"
                    "property uchar red\nproperty uchar green\nproperty uchar blue\n"
                    "end_header\n"
                )
                for p, c in zip(pts, colors):
                    f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c[0]} {c[1]} {c[2]}\n")

    # -- integrity ------------------------------------------------------
    def check_consistency(self) -> None:
        """Invariant sweep: arenas agree with the state, and no active
        keyframe observes an inactive point."""
        ids, kf_active, pt_active = self.h("kf_ids", "kf_active", "pt_active")
        assert (kf_active == self.keyframes.active).all(), "kf arena desync"
        assert (pt_active == self.points.active).all(), "pt arena desync"
        obs = ids[kf_active]
        obs = obs[obs >= 0]
        if len(obs):
            assert pt_active[obs].all(), "observation of inactive point"

    def signature(self) -> int:
        """Deterministic content hash; equal to the reference's signature of
        the same map (same fields, dtypes, quantization and order)."""
        h = hashlib.blake2b(digest_size=8)
        fields = self.h("pt_pos", "pt_active", "kf_pose", "kf_active", "kf_ids", "mk_id", "mk_pose")
        for a, quant in zip(fields, (1e4, None, 1e4, None, None, None, 1e4)):
            if quant is not None:
                a = np.round(a.astype(np.float64) * quant).astype(np.int64)
            h.update(a.tobytes())
        return int.from_bytes(h.digest(), "little")
