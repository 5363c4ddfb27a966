"""The port's async mapper at a set pace, with what each keyframe's mapping did.

On the card the port's mapping worker maps at about 40% of its sequential
speed beside the tracker (both threads launch kernels from Python and share
the GIL). Left to drop the candidates it cannot take, as the reference's
tracker does, it mapped 7 of the tracker's ~16 keyframe candidates, each
about 9 frames late; the JAX package's worker on the CPU keeps pace with
its slower tracker and maps 15. This runs the 60-frame `mono` scene of
chip_smoke.py's phase 12 through `UcoSlam(device="cuda")` in the passes
named by `--runs`, a comma-separated list of

- `free`: runSequential=False, the worker at its own pace;
- `lockstep:N`: each keyframe candidate is mapped, whole, while the tracker
  waits between frames e+N-1 and e+N (e: the frame that enqueued it), and
  every counter update is applied between frames too; the pass is as
  deterministic as a sequential one, with the worker N frames behind;
- `sequential`: runSequential=True;

each optionally with variants appended:

- `+skip`: a tracker that wants a keyframe while the worker maps one
  queues it, and while two are queued or in flight tracks on without one,
  as the reference's does, instead of waiting until the worker is idle
  (`MapManager.wait_for_worker`); `+queue2`: it queues one and waits only
  while two are queued or in flight;
- `+frozen`: the tracker reads the map as it was before the mapping in
  flight began (as the reference's mapUpdate merges a finished mapping at
  a frame's head), the mapped state and its correction together;
- `+fresh`: a new candidate takes the place of one still waiting in the
  queue (and the tracker never waits);
- `+fixpose`: a candidate is moved by the corrections published between
  its tracking and its mapping before it is mapped;
- `+retrack`: a candidate is tracked again against the map as the worker
  has it when its mapping begins, and mapped at that pose with those
  matches.

It prints one JSON line per pass: tracked frames, the init frame, ATE,
insertions, keyframes, points, the ms the tracker waited for the worker at
each candidate, per keyframe mapping the frames at which it was enqueued,
began, ended its local BA and published its correction, the size of that
correction (translation, rotation in degrees) and how many of the
keyframe's point ids had been handed to another point between its tracking
and its insertion, and per frame its error after the run's alignment, its
inliers and its process ms. Then the JAX package's passes of the scene.

    python3 tools/port/async_pace.py [--runs free,free+skip,lockstep:7]

Runs on the card unless `--device cpu` (slow: minutes a frame's mapping).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)


class Probe:
    """Hooks on the worker's steps: the tracker's frame count at each one,
    and the generation of every point slot (bumped at each allocation)."""

    def __init__(self):
        self.frame = 0
        self.hold, self.lockstep = None, False
        self.fifo = []  # (enqueue frame, ids, slot generations at the snapshot) per queued candidate
        self.waiting = None  # the enqueue frame of the candidate the worker waits at (lockstep)
        self.go = threading.Event()
        self.events = []
        self.snap_gen = None
        self.arena = None
        self.flags = set()  # the trial repairs (see main's --runs)
        self.frozen = None  # (state, slot generations) the tracker reads while a mapping runs (+frozen)
        self.frame_view = None  # what the tracker reads in this frame (+frozen)
        self.lock = threading.Lock()
        self.system = None
        self.fix = None
        self.replaced = 0
        self.waited = []  # ms the tracker waited for the worker at each keyframe candidate
        self.pub_log = []  # the corrections published so far, oldest first
        self.consumed = 0  # how many of them the tracker had adopted at its last frame head

    def reset(self, arena, hold=None, lockstep=False, flags=()):
        import numpy as np

        self.__init__()
        self.hold, self.lockstep, self.arena, self.flags = hold, lockstep, arena, set(flags)
        arena.gen = np.zeros(arena.capacity, np.int64)

    def install(self):
        import numpy as np
        import torch
        from ucoslam_tpu_torch.mapping import map as map_mod
        from ucoslam_tpu_torch.mapping.arena import Arena
        from ucoslam_tpu_torch.slam import mapmanager as mm

        probe = self
        alloc_many, snapshot = Arena.alloc_many, map_mod.Map.snapshot
        enqueue, new_keyframe, publish = (mm.MapManager.enqueue_keyframe, mm.MapManager.new_keyframe,
                                          mm.MapManager._publish_update)
        local_ba = mm.ba.local_bundle_adjustment
        wait_for_worker, consume = mm.MapManager.wait_for_worker, mm.MapManager.consume_update

        def gens(arena):
            if len(arena.gen) < arena.capacity:
                arena.gen = np.concatenate([arena.gen, np.zeros(arena.capacity - len(arena.gen), np.int64)])
            return arena.gen

        def p_alloc_many(self, n):
            slots = alloc_many(self, n)
            if getattr(self, "gen", None) is not None:
                gens(self)[slots] += 1
            return slots

        def p_snapshot(self):
            frozen = probe.frame_view if "frozen" in probe.flags else None
            if frozen is None:
                probe.snap_gen = gens(self.points).copy()
                return snapshot(self)
            probe.snap_gen = frozen[1]
            view = map_mod.Map.__new__(map_mod.Map)
            view.params, view.state = self.params, frozen[0]
            view.points, view.keyframes, view.markers = [
                Arena.of_mask(m) for m in view.h("pt_active", "kf_active", "mk_active")]
            return view

        def p_enqueue(self, frame, trace_frame=None, **host):
            ids = host.get("host_ids")
            entry = (probe.frame, None if ids is None else np.array(ids), probe.snap_gen, probe.consumed)
            if "skip" in probe.flags and self.busy():
                return False
            if "fresh" in probe.flags and self._pending_kf >= 2:
                # a candidate still waits in the queue: the fresh one takes its place
                with self._queue.mutex:
                    q = self._queue.queue
                    at = [i for i, (kind, _) in enumerate(q) if kind == "kf"]
                    if at:
                        q[at[-1]] = ("kf", (frame, trace_frame, host))
                        probe.fifo[-1] = entry
                        probe.replaced += 1
                        return True
            probe.fifo.append(entry)
            ok = enqueue(self, frame, trace_frame, **host)
            if not ok:
                probe.fifo.pop()
            return ok

        def p_wait_for_worker(self):
            if probe.flags & {"skip", "fresh"}:
                return
            t0 = time.perf_counter()
            if "queue2" in probe.flags:
                with self._mapped:
                    self._mapped.wait_for(lambda: self._pending_kf < 2)
            else:
                wait_for_worker(self)
            probe.waited.append(round(1e3 * (time.perf_counter() - t0), 1))

        def p_consume(self):
            n = len(probe.pub_log)
            with probe.lock:  # +frozen: the correction and the state it came with as one
                out = consume(self)
                live = probe.system.map
                probe.frame_view = probe.frozen or (live.state, gens(live.points).copy())
            probe.consumed = n
            return out

        def p_new_keyframe(self, world_map, frame, **host):
            if not self.is_async:
                return new_keyframe(self, world_map, frame, **host)
            e, ids, g, consumed = probe.fifo.pop(0)
            if probe.lockstep:
                probe.waiting = e
                probe.go.wait()
                probe.waiting = None
                probe.go.clear()
            ev = dict(enq=e, start=probe.frame)
            if ids is not None and g is not None:
                now = gens(world_map.points)
                live = (ids >= 0) & (ids < len(g))
                sl = ids[live]
                reused = world_map.points.active[sl] & (now[sl] != g[sl])
                ev["stale_reused"] = int(reused.sum())
            if "retrack" in probe.flags:
                # track the candidate again against the map as the worker has it now
                before = frame.pose_f2g.cpu().numpy()
                res = probe.system.tracker.track(world_map, frame, frame.pose_f2g)
                ev["retrack"] = bool(res.ok)
                if res.ok:
                    frame = res.frame
                    host = dict(host_ids=res.host_ids, host_depth=res.host_depth, host_valid=res.host_valid)
                    probe.fix = (np.linalg.inv(before) @ res.pose_f2g).astype(np.float32)
                    ev["rt_dt"] = float(np.linalg.norm(probe.fix[:3, 3]))
                else:
                    probe.fix = None
            elif "fixpose" in probe.flags and len(probe.pub_log) > consumed:
                # the corrections published since the candidate was tracked move it too
                fix = np.eye(4)
                for d in probe.pub_log[consumed:]:
                    fix = fix @ d
                ev["fix"] = len(probe.pub_log) - consumed
                probe.fix = fix.astype(np.float32)
                pose = frame.pose_f2g.cpu().numpy() @ probe.fix
                frame = frame.replace(pose_f2g=torch.from_numpy(pose).to(world_map.device))
            else:
                probe.fix = None
            probe.events.append(ev)
            if "frozen" in probe.flags:
                probe.frozen = (world_map.state, gens(world_map.points).copy())
            out = new_keyframe(self, world_map, frame, **host)
            return out

        def p_local_ba(*a, **k):
            out = local_ba(*a, **k)
            if probe.events:
                probe.events[-1]["ba_end"] = probe.frame
            return out

        def p_publish(self, before, after, scale, big):
            if probe.fix is not None:
                before = before @ probe.fix
            d = np.linalg.inv(before) @ after
            probe.pub_log.append(d)
            if probe.events:
                probe.events[-1].update(pub=probe.frame, dt=float(np.linalg.norm(d[:3, 3])), drot=float(
                    np.degrees(np.arccos(np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1)))))
            with probe.lock:  # the mapped state and its correction reach the tracker together
                publish(self, before, after, scale, big)
                probe.frozen = None

        Arena.alloc_many, map_mod.Map.snapshot = p_alloc_many, p_snapshot
        mm.MapManager.enqueue_keyframe, mm.MapManager.new_keyframe = p_enqueue, p_new_keyframe
        mm.MapManager._publish_update, mm.ba.local_bundle_adjustment = p_publish, p_local_ba
        mm.MapManager.wait_for_worker, mm.MapManager.consume_update = p_wait_for_worker, p_consume

    def between_frames(self, mgr):
        """Lockstep: let the worker run, whole, what is due, and return once it
        is idle or waits at a candidate that is not."""
        while self.lockstep:
            while self.waiting is None and mgr._queue.unfinished_tasks:
                time.sleep(0.0002)
            if self.waiting is not None and self.frame >= self.waiting + self.hold:
                self.go.set()
                while self.go.is_set():
                    time.sleep(0.0002)
                continue
            return

    def drain(self, mgr):
        self.hold = 0
        while self.lockstep and (self.waiting is not None or mgr._queue.unfinished_tasks):
            self.between_frames(mgr)


def per_frame(poses: dict, seq, slam, ms: list) -> list:
    """Per frame: its error after the run's similarity alignment (None when
    lost), its keypoint inliers and its process ms."""
    import numpy as np
    from ucoslam_tpu_torch.geometry.horn import horn_align

    idx = sorted(poses)
    est = np.stack([-poses[i][:3, :3].T @ poses[i][:3, 3] for i in idx])
    s, R, t = horn_align(est, seq.gt_positions()[idx])
    err = dict(zip(idx, np.linalg.norm((s * (R @ est.T)).T + t - seq.gt_positions()[idx], axis=1)))
    inl = {r["fseq"]: r["n_inliers"] for r in slam._system.stats_log}
    return [(round(float(err[i]), 4) if i in err else None, inl.get(i), ms[i]) for i in range(len(ms))]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", default="free,free+skip,free,free+skip,free,free+skip,free,free+skip")
    ap.add_argument("--frames", type=int, default=60, help="the scene's first frames to run")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import chip_smoke as cs
    from ucoslam_tpu_torch.api import UcoSlam
    from ucoslam_tpu_torch.config import Params
    from ucoslam_tpu_torch.io.serialize import load_map_meta

    with open(cs.ASYNC_REF_PATH) as f:
        ref = json.load(f)
    if args.device == "cuda":
        cs.phase_environment()
    _, cam, seq, images = cs.load_scene(cs.REF_PATH)
    images = images[:args.frames]
    params = Params.from_dict(load_map_meta(cs.MAP_PATH)["params"])
    probe = Probe()
    probe.install()
    for spec in args.runs.split(","):
        base, *flags = spec.split("+")
        kind, _, n = base.partition(":")
        slam = UcoSlam(device=args.device)
        slam.setParams(None, params.replace(runSequential=kind == "sequential"), cam)
        mgr = slam._system.manager
        probe.reset(slam.map.points, hold=int(n) if n else None, lockstep=kind == "lockstep", flags=flags)
        probe.system = slam._system
        poses, ms = {}, []
        t0 = time.perf_counter()
        for i, img in enumerate(images):
            t1 = time.perf_counter()
            pose = slam.process(img, fseq=i)
            ms.append(round(1e3 * (time.perf_counter() - t1), 1))
            probe.frame += 1
            if pose is not None:
                poses[i] = pose
            if mgr.is_async:
                probe.between_frames(mgr)
        if mgr.is_async:
            probe.drain(mgr)
        probe.hold = None
        slam.waitForFinished()
        print(json.dumps(dict(run=spec, tracked=len(poses), init_frame=min(poses), ate=cs.ate_of(poses, seq),
                              insertions=mgr.n_insertions, keyframes=slam.map.n_keyframes,
                              points=slam.map.n_points, seconds=round(time.perf_counter() - t0, 3),
                              replaced=probe.replaced, waited=probe.waited, mappings=probe.events, frames=per_frame(poses, seq, slam, ms))),
              flush=True)
        slam.clear()
    print(json.dumps({"jax_free": ref["trials"],
                      "jax_sequential": ref["sequential"], "jax_drained": ref["drained"]}))


if __name__ == "__main__":
    main()
