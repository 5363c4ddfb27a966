"""Local mapping: keyframe insertion, new-point creation, fusion, culling.

Port of the sequential path of `ucoslam_tpu/slam/mapmanager.py`: per new
keyframe, capacity growth, the stale-id drop, insertion, the keyframe's
marker observations (with the one-time marker rescale of a map that is not
metric yet, and the poses of markers that have none), stereo points
(nothing for mono depth), epipolar matching and triangulation against up to
six covisible neighbours (one batch over a leading axis; the most recent
keyframe after a marker-only init, which shares no points), duplicate fusion
(kernel B1 at a 3 px radius over the whole point arena), recent-point
culling, local BA (marker vertices included), the point statistics,
keyframe culling, the keyframe database and loop closure (markers first,
then keypoints; a Sim3 correction with seam fusion, then a global BA).

Two dispatch modes, as the reference's `runSequential` switch: sequential
(deterministic), where the System calls `new_keyframe` inline between frames,
and async, where a mapping worker thread consumes a bounded queue of keyframe
candidates and the tracker's point-counter bumps while tracking goes on over
map snapshots (`Map.snapshot`). The worker is the map's single writer; the
pose corrections its keyframes bring (local BA, loop closure, a marker
rescale) are published as an update the tracker consumes at its next frame.
As in the reference: counter bumps are dropped under backpressure, at most
two keyframe candidates are queued or in flight, a running BA is never
interrupted, and a worker exception is kept and raised by `wait_idle`.
Unlike the reference, a tracker that needs a keyframe while the worker
still maps one waits for it (`wait_for_worker`), then hands over the frame
it tracks now: the two threads share the GIL, so beside the tracker the
worker maps at about 40% of its sequential speed, and a tracker that
tracked on (dropping candidates, or queueing ones that went stale) left it
a map sparser and later than the sequential one (tools/port/async_pace.py).
Frames that need no keyframe still track while the worker maps. Both
threads launch on the one default CUDA stream, so their device work is
ordered and the caching allocator needs no stream bookkeeping.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from ucoslam_tpu_torch.config import Params
from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.geometry.epipolar import fundamental_from_poses
from ucoslam_tpu_torch.geometry.triangulate import triangulate_checked
from ucoslam_tpu_torch.mapping.frame import Frame, fetch_to_host, frame_from_kf
from ucoslam_tpu_torch.mapping.kfdatabase import KeyFrameDataBase
from ucoslam_tpu_torch.mapping.map import FLAG_STEREO, Map, MapState, op_update_point_stats
from ucoslam_tpu_torch.matching.matcher import match_frames_epipolar
from ucoslam_tpu_torch.matching.projection import match_points_to_frame
from ucoslam_tpu_torch.optim import ba
from ucoslam_tpu_torch.slam.loopclosure import LoopDetector
from ucoslam_tpu_torch.slam.markermap import (
    estimate_scale_from_pending_markers,
    record_marker_observations,
    resolve_marker_slots,
    update_marker_poses,
)
from ucoslam_tpu_torch.utils.timers import timers

#: covisible neighbours triangulated against per keyframe
EPI_MAX_NB = 6


def _epipolar_pairs(st: MapState, cur_slot: int, nb_slots: list[int], cam: CameraParams,
                    max_desc_dist: float, scale_factor: float):
    """Epipolar match + triangulation of keyframe cur_slot against each of
    nb_slots, all pairs in one batch. -> (ok (B, N), train_idx (B, N),
    X (B, N, 3)): per current keypoint, the new-point candidates."""
    cur = frame_from_kf(st, cur_slot)
    dev = cur.und_xy.device
    nb = torch.tensor(nb_slots, dtype=torch.int64, device=dev)
    other = Frame(
        fseq=-1, xy=st.kf_xy[nb], und_xy=st.kf_xy[nb], octave=st.kf_octave[nb],
        angle=torch.zeros(st.kf_octave[nb].shape, dtype=torch.float32, device=dev),
        response=torch.zeros(st.kf_octave[nb].shape, dtype=torch.float32, device=dev),
        desc=st.kf_desc[nb], depth=st.kf_depth[nb], valid=st.kf_kpt_valid[nb],
        ids=st.kf_ids[nb], pose_f2g=st.kf_pose[nb],
    )
    F12 = fundamental_from_poses(cur.pose_f2g, other.pose_f2g, cam, cam)
    log_sf = torch.log(torch.tensor(scale_factor, dtype=torch.float32, device=dev))
    sigma2_other = torch.exp(2.0 * other.octave.to(torch.float32) * log_sf)
    matches = match_frames_epipolar(cur, other, F12, sigma2_other, max_desc_dist, only_unassigned=True)
    t_idx = torch.where(matches.valid, matches.train_idx, 0).long()
    sigma2_1 = torch.exp(2.0 * cur.octave.to(torch.float32) * log_sf)
    uv2 = torch.gather(other.und_xy, 1, t_idx[..., None].expand(-1, -1, 2))
    X, ok = triangulate_checked(
        cur.und_xy, uv2, cur.pose_f2g, other.pose_f2g, cam, cam,
        sigma2_1, torch.gather(sigma2_other, 1, t_idx),
    )
    return ok & matches.valid, matches.train_idx, X


def fuse_duplicates_into_kf(world_map: Map, kf_slot: int, cam: CameraParams, params: Params) -> int:
    """Merge duplicate map points seen by keyframe kf_slot: a map point
    projected within 3 px onto a keypoint that already holds a different
    point, with a matching descriptor, is the same point; the better
    observed one stays, and every reference to the other is rewritten.
    One launch of kernel B1 over the whole point arena. Returns the number
    of points fused away."""
    st = world_map.state
    cur = frame_from_kf(st, kf_slot)
    m = match_points_to_frame(
        st.pt_pos, st.pt_desc, st.pt_normal, st.pt_min_dist, st.pt_max_dist,
        st.pt_active, cur, cam, cur.pose_f2g,
        torch.tensor(3.0, dtype=torch.float32, device=world_map.device),  # near-coincident only
        float(np.float32(params.maxDescDistance * 0.6)),
        float(params.scaleFactor),
    )
    kpt_idx, mvalid, ids = fetch_to_host(m.kpt_idx, m.point_valid, st.kf_ids[kf_slot])
    obs_counts = world_map.point_observation_counts()
    # each projected point p landing on a keypoint claimed by another point
    # q is a duplicate pair; keep the better-observed one (ties: lower slot)
    p_all = np.nonzero(mvalid)[0]
    q_all = ids[kpt_idx[p_all]]
    sel = (q_all >= 0) & (q_all != p_all)
    p_all, q_all = p_all[sel], q_all[sel]
    if len(p_all) == 0:
        return 0
    cp, cq = obs_counts[p_all], obs_counts[q_all]
    lo, hi = np.minimum(p_all, q_all), np.maximum(p_all, q_all)
    keep = np.where(cp > cq, p_all, np.where(cq > cp, q_all, lo))
    lose = np.where(cp > cq, q_all, np.where(cq > cp, p_all, hi))
    remap = np.arange(st.P, dtype=np.int32)
    remap[lose] = keep.astype(np.int32)
    # path-compress chains (a->b, b->c) to their final survivor
    for _ in range(2 + int(np.log2(max(len(p_all), 2)))):
        nxt = remap[remap]
        if (nxt == remap).all():
            break
        remap = nxt
    fused = np.nonzero(remap != np.arange(st.P))[0]
    world_map.points.free(fused)
    dev = world_map.device
    world_map.state = _op_apply_remap(
        world_map.state, torch.from_numpy(remap).to(dev), torch.from_numpy(world_map.points.active.copy()).to(dev)
    )
    return len(fused)


def _op_apply_remap(st: MapState, remap: torch.Tensor, pt_active: torch.Tensor) -> MapState:
    kf_ids = st.kf_ids
    remapped = remap[kf_ids.clamp(min=0).long()]
    return st.replace(kf_ids=torch.where(kf_ids >= 0, remapped, kf_ids), pt_active=pt_active)


class MapManager:
    """Sequential local mapping driven by the System."""

    def __init__(self, params: Params, cam: CameraParams, kfdb: KeyFrameDataBase | None = None, device="cuda"):
        self.params = params
        self.cam = cam
        self.kf_counter = 0
        # True once the map is known metric (marker/depth init, or the one
        # marker rescale applied): metric maps are never rescaled again
        self.metric_locked = False
        self.last_scale_correction = 1.0  # set when a marker rescale moved the map
        self.kfdb = kfdb if kfdb is not None else KeyFrameDataBase(params.maxKeyFrames, device=device)
        self.loop_detector = LoopDetector(params, cam, self.kfdb)
        self.n_insertions = 0  # new_keyframe calls (each launches B1 once, to fuse)
        self.loop_closures = 0  # loops accepted (the tracker adopts the corrected pose)
        # async dispatch (start_async)
        self._queue: queue.Queue | None = None
        self._thread: threading.Thread | None = None
        self._idle = threading.Event()
        self._idle.set()
        self._lock = threading.Lock()  # the pending update and the candidate count
        self._mapped = threading.Condition(self._lock)  # notified when a candidate leaves the worker
        self._pending_update: dict | None = None
        self._worker_error: BaseException | None = None
        self._pending_kf = 0  # keyframe candidates queued or in flight

    _THREAD_STATE = ("_queue", "_thread", "_idle", "_lock", "_mapped")

    def __getstate__(self) -> dict:
        """A copy (or pickle) of a sequential manager; a running worker
        cannot be copied."""
        if self._thread is not None:
            raise TypeError("an async MapManager cannot be copied while its worker runs")
        return {k: v for k, v in self.__dict__.items() if k not in self._THREAD_STATE}

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state, _queue=None, _thread=None, _idle=threading.Event(), _lock=threading.Lock())
        self._mapped = threading.Condition(self._lock)
        self._idle.set()

    # -- async dispatch (the reference's mapping thread) ----------------
    def start_async(self, world_map: Map) -> None:
        """Start the mapping worker (runSequential=False)."""
        if self._thread is not None:
            return
        self._queue = queue.Queue(maxsize=4)  # the reference's bounded TSQueue
        self._thread = threading.Thread(target=self._worker_loop, args=(world_map,), daemon=True,
                                        name="ucoslam-mapper")
        self._thread.start()

    def stop_async(self) -> None:
        """Stop the worker once it has run what was queued before the stop.
        The join has no timeout (the reference's has 60 s): a long loop
        correction or global BA in flight still writes the map, so no caller
        returns while it runs."""
        if self._thread is None:
            return
        self._queue.put(("stop", None))
        self._thread.join()
        self._thread = None
        self._queue = None

    @property
    def is_async(self) -> bool:
        return self._thread is not None

    def busy(self) -> bool:
        """True when two keyframe candidates are queued or in flight: the
        tracker then keeps tracking and asks again later (counter bumps do
        not count)."""
        return self._pending_kf >= 2

    def wait_for_worker(self) -> None:
        """Block until no keyframe candidate is queued or in flight (the
        tracker's backpressure; module docstring). Every candidate leaves the
        worker, mapped or failed, so the wait ends."""
        with self._mapped:
            self._mapped.wait_for(lambda: self._pending_kf == 0)

    def wait_idle(self) -> None:
        """Block until the worker has drained its queue; raise the exception
        a worker step raised, if any."""
        if self._queue is None:
            return
        self._queue.join()
        self._idle.wait()
        if self._worker_error is not None:
            err, self._worker_error = self._worker_error, None
            raise err

    def enqueue_keyframe(self, frame: Frame, trace_frame=None, **host) -> bool:
        """Hand a keyframe candidate (and the tracker's host copies of its
        ids/depth/valid, `new_keyframe`'s host_*) to the worker; False when
        the queue is full. trace_frame: the (session, fseq) the worker's
        spans of this keyframe carry."""
        with self._lock:
            self._pending_kf += 1
        try:
            self._queue.put_nowait(("kf", (frame, trace_frame, host)))
            return True
        except queue.Full:
            with self._lock:
                self._pending_kf -= 1
            return False

    def enqueue_stats(self, vis_mask, seen_mask) -> None:
        """Route the tracker's point-counter bumps through the single writer;
        dropped when the queue is full, or when the point arena grew since
        the tracker's snapshot (they only tune point culling)."""
        try:
            self._queue.put_nowait(("stats", (vis_mask, seen_mask)))
        except queue.Full:
            pass

    def consume_update(self) -> dict | None:
        """Pop the pending pose correction: {'dT': the keyframe's pose before
        its mapping^-1 @ after (4x4), 'scale': float, 'big_change': bool},
        or None."""
        with self._lock:
            upd, self._pending_update = self._pending_update, None
        return upd

    def _publish_update(self, pose_before: np.ndarray, pose_after: np.ndarray, scale: float,
                        big_change: bool) -> None:
        dT = np.linalg.inv(pose_before) @ pose_after
        with self._lock:
            prev = self._pending_update
            if prev is not None:  # compose: corrections apply oldest first
                dT = prev["dT"] @ dT
                scale = prev["scale"] * scale
                big_change = big_change or prev["big_change"]
            self._pending_update = {"dT": dT.astype(np.float32), "scale": scale, "big_change": big_change}

    def _worker_loop(self, world_map: Map) -> None:
        while True:
            kind, payload = self._queue.get()
            self._idle.clear()
            try:
                if kind == "stop":
                    return
                if kind == "stats":
                    if payload[0].shape[0] == world_map.state.P:  # not from before a growth of the arena
                        world_map.bump_point_stats(*payload)
                elif kind == "kf":
                    frame, trace_frame, host = payload
                    session, fseq = trace_frame or (None, None)
                    with timers.span("mapping.new_keyframe", session, fseq):
                        pose_before = frame.pose_f2g.cpu().numpy()
                        self.last_scale_correction = 1.0
                        loops_before = self.loop_closures
                        kf_slot = self.new_keyframe(world_map, frame, **host)
                        self._publish_update(pose_before, world_map.h("kf_pose")[kf_slot],
                                             self.last_scale_correction, self.loop_closures != loops_before)
            except BaseException as e:  # raised by wait_idle
                self._worker_error = e
            finally:
                if kind == "kf":
                    with self._mapped:
                        self._pending_kf -= 1
                        self._mapped.notify_all()
                self._idle.set()
                self._queue.task_done()

    def new_keyframe(self, world_map: Map, frame: Frame, host_ids=None, host_depth=None, host_valid=None) -> int:
        """Insert `frame` as a keyframe and grow the map around it. host_*:
        host copies of the frame's ids/depth/valid the tracker fetched."""
        p = self.params
        self.n_insertions += 1
        with timers.span("mapping.insert"):
            if world_map.keyframes.n_active >= world_map.state.K - 1:
                self.kfdb.grow(world_map.grow_keyframes())
            if world_map.points.n_active >= int(0.95 * world_map.state.P):
                world_map.grow_points()
            # drop ids whose slots were freed since the frame was tracked
            ids = host_ids if host_ids is not None else frame.ids.cpu().numpy()
            if (ids >= 0).any():
                alive = world_map.h("pt_active")
                stale = (ids >= 0) & ~alive[np.clip(ids, 0, len(alive) - 1)]
                if stale.any():
                    ids = np.where(stale, -1, ids).astype(np.int32)
                    frame = frame.replace(ids=torch.from_numpy(ids).to(world_map.device))
            kf_slot = world_map.add_keyframe(frame)
            self.kf_counter += 1
            if p.detectMarkers and frame.markers.valid.any():
                self._add_marker_observations(world_map, kf_slot, frame)
        with timers.span("mapping.new_points"):
            with timers.span("mapping.stereo_points"):
                self._create_stereo_points(world_map, kf_slot, frame, host_depth=host_depth, host_valid=host_valid,
                                           host_ids=ids)
            self._create_epipolar_points(world_map, kf_slot)
        with timers.span("mapping.fuse"):
            self._fuse_duplicates(world_map, kf_slot)
        with timers.span("mapping.cull"):
            self._cull_recent_points(world_map)
        if world_map.n_keyframes >= 3:
            ba.local_bundle_adjustment(world_map, self.cam, kf_slot, n_iters=10, max_window=p.maxLocalKeyFrames or None)
        with timers.span("mapping.cull"):
            world_map.state = op_update_point_stats(world_map.state, float(p.scaleFactor), int(p.nOctaveLevels))
            self._cull_keyframes(world_map, kf_slot)
        with timers.span("mapping.kfdb"):
            self.kfdb.add(kf_slot, frame.desc, frame.valid)
        with timers.span("mapping.loop"):
            self._detect_and_close_loop(world_map, kf_slot, frame)
        return kf_slot

    def _add_marker_observations(self, world_map: Map, kf_slot: int, frame: Frame) -> None:
        """Record the keyframe's markers. A keypoint-initialized map (scale
        unknown) keeps its markers pose-less until one marker-based rescale
        makes it metric: a metric marker pose in a map of another scale would
        pull every BA edge it touches."""
        p = self.params
        slots = resolve_marker_slots(world_map, frame.markers)
        record_marker_observations(world_map, kf_slot, frame.markers, slots)
        if not self.metric_locked:
            s = estimate_scale_from_pending_markers(world_map, self.cam, p)
            if s is not None and 0.05 < s < 20.0:
                if abs(s - 1.0) > 0.02:
                    world_map.scale(s)
                    self.last_scale_correction = s
                self.metric_locked = True
        if self.metric_locked:
            update_marker_poses(world_map, self.cam, p)

    def _detect_and_close_loop(self, world_map: Map, kf_slot: int, frame: Frame) -> None:
        """Loop detection, from markers first, then from keypoints; an
        accepted correction is followed by a global BA."""
        p = self.params
        info = None
        if p.detectMarkers:
            info = self.loop_detector.detect_from_markers(world_map, kf_slot, frame)
        if (info is None or not info.found) and p.detectKeyPoints:
            info = self.loop_detector.detect_from_keypoints(world_map, kf_slot, frame)
        if info is None or not info.found:
            return
        fix_scale = bool((world_map.state.kf_depth > 0).any())
        if self.loop_detector.correct_map(world_map, info, fix_scale=fix_scale):
            self.loop_closures += 1
            ba.global_bundle_adjustment(world_map, self.cam, n_iters=10)

    def _create_stereo_points(self, world_map: Map, kf_slot: int, frame: Frame,
                              host_depth=None, host_valid=None, host_ids=None) -> None:
        """Direct points from per-keypoint depth (stereo/RGB-D), for
        unassigned keypoints with valid close depth; none for mono."""
        depth = host_depth if host_depth is not None else frame.depth.cpu().numpy()
        kvalid = host_valid if host_valid is not None else frame.valid.cpu().numpy()
        kids = host_ids if host_ids is not None else frame.ids.cpu().numpy()
        valid = kvalid & (depth > 0) & (kids < 0)
        if self.cam.bl > 0:
            valid &= depth < 40.0 * self.cam.bl
        idx = np.nonzero(valid)[0]
        if len(idx) == 0:
            return
        cap = self.params.maxNewPoints
        response, desc, octave_all, cam_pts, T = fetch_to_host(
            frame.response, frame.desc, frame.octave, self.cam.unproject(frame.und_xy, frame.depth), frame.pose_f2g
        )
        if len(idx) > cap:
            idx = idx[np.argsort(-response[idx])[:cap]]
        cam_pts = cam_pts[idx]
        R, t = T[:3, :3], T[:3, 3]
        world_pts = (cam_pts - t) @ R
        rays = world_pts - (-R.T @ t)
        dist = np.linalg.norm(rays, axis=1).clip(1e-9)
        sf = self.params.scaleFactor
        max_d = dist * sf ** octave_all[idx]
        min_d = max_d / sf ** (self.params.nOctaveLevels - 1)
        avail = world_map.state.P - world_map.n_points
        if avail <= 0:
            return
        idx = idx[:avail]
        k = len(idx)
        slots = world_map.add_points(
            pos=world_pts[:k], normal=(rays / dist[:, None])[:k], desc=desc[idx],
            min_dist=min_d[:k], max_dist=max_d[:k], flags=np.full(k, FLAG_STEREO, np.int32),
            creation_kf=self.kf_counter,
        )
        world_map.set_observations(kf_slot, idx.astype(np.int32), slots)

    def _create_epipolar_points(self, world_map: Map, kf_slot: int) -> None:
        """Triangulate new points against the best covisible neighbours."""
        p = self.params
        covis = world_map.covis_matrix()
        weights = covis[kf_slot].copy()
        weights[kf_slot] = 0
        order = np.argsort(-weights)
        neighbours = [int(s) for s in order[:EPI_MAX_NB] if weights[s] >= 10]
        if not neighbours:
            others = [s for s in world_map.keyframes.active_slots() if s != kf_slot]
            if others:
                neighbours = [int(others[-1])]
        budget = p.maxNewPoints
        # mono conditioning gate: skip neighbours whose baseline is tiny
        # against the scene depth
        median_depth = world_map.frame_median_depth(kf_slot)
        min_baseline = p.baseline_medianDepth_ratio_min * max(median_depth, 1e-6)
        kf_pose = world_map.h("kf_pose")
        T1 = kf_pose[kf_slot]
        c1 = -T1[:3, :3].T @ T1[:3, 3]
        good = []
        for nb in neighbours:
            T2 = kf_pose[nb]
            c2 = -T2[:3, :3].T @ T2[:3, 3]
            if float(np.linalg.norm(c1 - c2)) >= max(1e-4, min_baseline):
                good.append(nb)
        if not good:
            return
        st = world_map.state
        ok_v, tidx_v, X_v = _epipolar_pairs(
            st, kf_slot, good, self.cam, float(np.float32(p.maxDescDistance)), float(p.scaleFactor)
        )
        ok_v, tidx_v, X_v, cur_desc, cur_oct = fetch_to_host(
            ok_v, tidx_v, X_v, st.kf_desc[kf_slot], st.kf_octave[kf_slot]
        )
        taken = np.zeros(st.N, bool)  # keypoints of cur that already got a point
        for i, nb in enumerate(good):
            if budget <= 0:
                break
            idx1 = np.nonzero(ok_v[i] & ~taken)[0]
            if len(idx1) == 0:
                continue
            if len(idx1) > budget:
                idx1 = idx1[:budget]
            avail = world_map.state.P - world_map.n_points
            if avail <= 0:
                break
            idx1 = idx1[:avail]
            taken[idx1] = True
            idx2 = tidx_v[i][idx1]
            Xn = X_v[i][idx1]
            rays = Xn - c1
            dist = np.linalg.norm(rays, axis=1).clip(1e-9)
            max_d = dist * p.scaleFactor ** cur_oct[idx1]
            min_d = max_d / p.scaleFactor ** (p.nOctaveLevels - 1)
            slots = world_map.add_points(
                pos=Xn, normal=rays / dist[:, None], desc=cur_desc[idx1],
                min_dist=min_d, max_dist=max_d, flags=np.zeros(len(idx1), np.int32),
                creation_kf=self.kf_counter,
            )
            world_map.set_observations(kf_slot, idx1.astype(np.int32), slots)
            world_map.set_observations(nb, idx2.astype(np.int32), slots)
            budget -= len(idx1)

    def _fuse_duplicates(self, world_map: Map, kf_slot: int) -> None:
        fuse_duplicates_into_kf(world_map, kf_slot, self.cam, self.params)

    def _cull_keyframes(self, world_map: Map, kf_slot: int) -> None:
        """Remove redundant keyframes: a covisible neighbour whose points are
        > KFCulling-fraction observed by >= 4 keyframes; never the two
        oldest, at most two per insertion."""
        p = self.params
        if p.KFCulling >= 1.0 or world_map.n_keyframes <= 3:
            return
        covis = world_map.covis_matrix()
        obs_counts = world_map.point_observation_counts().copy()
        candidates = [int(s) for s in np.nonzero(covis[kf_slot] > 0)[0] if s != kf_slot]
        cand_rows = {}
        if candidates:
            idx = torch.tensor(candidates, dtype=torch.int64, device=world_map.device)
            rows = world_map.state.kf_ids[idx].cpu().numpy()
            cand_rows = {c: rows[i] for i, c in enumerate(candidates)}
        anchors = set(world_map.keyframes.active_slots()[:2].tolist())
        to_remove = []
        for s in candidates:
            if s in anchors:
                continue
            ids = cand_rows[s]
            obs = ids[ids >= 0]
            if len(obs) < 10:
                continue
            if (obs_counts[obs] >= 4).mean() > p.KFCulling:
                to_remove.append(s)
                # a mutually redundant pair is never culled together
                obs_counts[obs] -= 1
                if len(to_remove) >= 2:
                    break
        if to_remove:
            world_map.remove_keyframes(to_remove)
            self.kfdb.remove(to_remove)

    def _cull_recent_points(self, world_map: Map) -> None:
        """Remove unreliable points: seen/visible < 0.25 once 2 keyframes
        old, or observed by fewer than minNumProjPoints keyframes once 3 old."""
        active, n_seen, n_vis, creation = world_map.h("pt_active", "pt_n_seen", "pt_n_visible", "pt_creation_kf")
        if not active.any():
            return
        n_seen = n_seen.astype(np.float32)
        n_vis = n_vis.astype(np.float32).clip(1)
        age = self.kf_counter - creation
        obs_counts = world_map.point_observation_counts()
        bad_ratio = (n_seen / n_vis < 0.25) & (age >= 2)
        bad_obs = (age >= 3) & (obs_counts < self.params.minNumProjPoints)
        cull = active & (bad_ratio | bad_obs)
        if cull.any():
            world_map.remove_points(cull)
