"""The fleet generator: camera streams, one `UcoSlam` each, in worker
processes that share one card.

A traffic mix of this generator (`"generator": "fleet"`) sets:

- `mode`: "slam" (each stream runs SLAM sessions from nothing over its clip;
  a new session starts when the clip ends) or "localization" (each stream
  loads the map file `map` and localizes against it, sweeping its clip
  forward and back so the motion never jumps);
- `streams`: worker processes, each closed-loop (the next frame is handed
  over when the previous pose returns), sequential, one CPU thread;
- `scene_seeds`: the pool of scenes; in "slam" mode the run's seed deals
  them to the streams in another order, in "localization" mode every stream
  takes the pool's scenes in turn and the seed sets each stream's start
  frame and direction;
- `warm_frames` and `stagger_frames`: before the window, stream i processes
  warm_frames + i * stagger_frames frames, so every code path has run once
  and the sessions are at different phases when a barrier opens the window;
- `relocalize_first`: `resetTracker()` when a session starts, so a camera
  that joins a saved map finds its own pose (the map file's tracker state is
  the camera that built it);
- `sample_every`: about one window frame in that many (drawn from the seed)
  has its keypoints kept for the frontend's comparison;
- `min_session_poses`: a session that reached its clip's end with fewer
  poses has failed its trajectory (a shorter one, cut by the window's end,
  is not judged);
- `trace_seconds`: the traced part of the window in a `--trace 1` run.

The configuration gives the camera, the sensor ("mono": the only one a
cell runs yet), the scene (`scenes/<renderer>.py` with its arguments) and the
program's `Params`. Frames are rendered once per checkout into
`build/portbench/scenes/` (uint8, as a camera delivers them) and loaded from
there by later runs.

An operation is one frame handed to `process`. It fails only when the call
raises, returns a malformed or non-finite pose, or its worker dies. Frames
before a session's first pose and frames the tracker loses are outcomes of
the protocol; the comparison judges them (`pre_init_max`, `lost_share`).
"""

from __future__ import annotations

import hashlib
import inspect
import json
import multiprocessing as mp
import os
import time
import traceback

import numpy as np

from portbench.core import guard, manifest, trace


#: the library's FAST threshold (ORBExtractor's default; nothing in Params sets it)
FAST_THRESHOLD = 7.0


def rng_for(seed: int, *salt: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**63, *salt])


# ---------------------------------------------------------------- frames


def clip_path(root: str, config: dict, scene_seed: int) -> str:
    """The render cache's file of one clip: a hash of everything that
    decides its pixels, the renderer's source included."""
    scene = config["scene"]
    src = inspect.getsource(manifest.scene_module(scene["renderer"]))
    key = json.dumps([scene, config["camera"], config["sensor"], scene_seed], sort_keys=True) + src
    digest = hashlib.sha256(key.encode()).hexdigest()[:20]
    return os.path.join(root, "build", "portbench", "scenes", f"{scene['renderer']}_{digest}.npz")


def _render_frames(job) -> list:
    """Pool task: (scene, camera, seed, frame indices) -> (index, uint8
    image) of each frame."""
    scene, camera, seed, idx = job
    sc = manifest.scene_module(scene["renderer"]).make(scene, camera, seed)
    return [(i, _u8(sc.render(i))) for i in idx]


def _u8(img: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def ensure_clips(root: str, config: dict, scene_seeds, processes: int) -> dict:
    """scene seed -> clip file, rendering the missing ones in a pool of
    `processes` spawned workers."""
    paths = {s: clip_path(root, config, s) for s in dict.fromkeys(scene_seeds)}
    missing = [s for s, p in paths.items() if not os.path.exists(p)]
    if not missing:
        return paths
    if config["sensor"] != "mono":
        raise ValueError(f"sensor {config['sensor']!r}: the fleet generator renders monocular clips only")
    scene, camera = config["scene"], config["camera"]
    n = scene["n_frames"]
    chunks = [list(range(k, n, 10)) for k in range(10)]
    jobs = [(scene, camera, s, c) for s in missing for c in chunks]
    with mp.get_context("spawn").Pool(processes) as pool:
        parts = pool.map(_render_frames, jobs)
    for s in missing:
        frames = sorted((f for (job, part) in zip(jobs, parts) if job[2] == s for f in part), key=lambda f: f[0])
        sc = manifest.scene_module(scene["renderer"]).make(scene, camera, s)
        arrays = {"image": np.stack([f[1] for f in frames]), "poses": np.stack([sc.gt_pose(i) for i in range(n)])}
        os.makedirs(os.path.dirname(paths[s]), exist_ok=True)
        tmp = paths[s] + f".{os.getpid()}.tmp.npz"
        np.savez(tmp, **arrays)
        os.replace(tmp, paths[s])
    return paths


def plan(traffic: dict, seed: int, n_streams: int, n_frames: int) -> list[dict]:
    """Each stream's scene, first frame, direction and warm-up frames."""
    rng = rng_for(seed, 0x51EE7)
    pool = traffic["scene_seeds"]
    out = []
    if traffic["mode"] == "slam":
        order = rng.permutation(len(pool))
        for i in range(n_streams):
            out.append(dict(scene_seed=pool[order[i % len(pool)]], start=0, direction=1,
                            warm=traffic["warm_frames"] + i * traffic["stagger_frames"]))
    else:
        for i in range(n_streams):
            out.append(dict(scene_seed=pool[i % len(pool)], start=int(rng.integers(n_frames)),
                            direction=int(rng.choice([-1, 1])),
                            warm=traffic["warm_frames"] + i * traffic["stagger_frames"]))
    return out


def n_streams_for(traffic: dict, cores: int) -> int:
    """The mix's streams, or cores - 2 where the machine has fewer than
    streams + 2 cores (the parent and the renderer's pool need room)."""
    n = traffic["streams"]
    return n if cores >= n + 2 else max(1, cores - 2)


# ---------------------------------------------------------------- worker


class Stream:
    """One camera: its UcoSlam sessions over its clip, and what the
    comparison needs of them."""

    def __init__(self, spec: dict, clip: dict, rec: trace.Recorder):
        from ucoslam_tpu_torch.config import Mode, Params
        from ucoslam_tpu_torch.geometry.camera import CameraParams

        self.Mode = Mode
        cfg, trf = spec["config"], spec["traffic"]
        c = cfg["camera"]
        self.cam = CameraParams.create(c["fx"], c["fy"], c["cx"], c["cy"], width=c["width"], height=c["height"])
        self.params = Params.from_dict(cfg["params"])
        self.mode, self.device = trf["mode"], spec["device"]
        self.map_path = os.path.join(spec["root"], trf["map"]) if trf["mode"] == "localization" else None
        self.relocalize_first = bool(trf.get("relocalize_first", False))
        self.image = clip["image"]
        self.n = self.image.shape[0]
        self.rec = rec
        self.pos, self.direction = spec["plan"]["start"], spec["plan"]["direction"]
        self.count = 0  # frames handed over by this stream
        self.slam = None
        self.sessions: list[dict] = []
        self.capture_next = False
        self.captured: list[tuple] = []
        self.new_session()

    def new_session(self) -> None:
        from ucoslam_tpu_torch.api import UcoSlam

        if self.slam is not None:
            self.slam.clear()
        slam = UcoSlam(device=self.device)
        if self.mode == "slam":
            slam.setParams(None, self.params, self.cam)
        else:
            slam.readFromFile(self.map_path, self.cam)
            slam.setMode(self.Mode.LOCALIZATION)
        if self.relocalize_first:
            slam.resetTracker()
        ext, sysd = slam._extractor, slam._system
        ext.process = self.rec.wrap("frontend.extract", self._capturing(ext.process))
        sysd.tracker.track = self.rec.wrap("tracking.track", sysd.tracker.track)
        sysd.tracker.relocalize = self.rec.wrap("tracking.track", sysd.tracker.relocalize)
        sysd.manager.new_keyframe = self.rec.wrap("mapping.new_keyframe", sysd.manager.new_keyframe)
        self.slam = slam
        self.sessions.append({"poses": [], "pre_init": 0, "lost": 0, "ended": False})

    def _capturing(self, fn):
        def wrapper(*args, **kwargs):
            f = fn(*args, **kwargs)
            if self.capture_next:
                self.captured.append((self.pos, *(t.clone() for t in (f.xy, f.octave, f.angle, f.desc, f.valid))))
            return f
        return wrapper

    def step(self) -> tuple[bool, str | None]:
        """Hand the next frame over. -> (failed, error text)."""
        k, fseq = self.pos, self.count
        self.count += 1
        failed, err = False, None
        try:
            pose = self.slam.process(self.image[k], fseq)
        except Exception:  # a fault of the program: counted, the session restarted
            failed, err, pose = True, traceback.format_exc(), None
        s = self.sessions[-1]
        if not failed:
            if pose is None:
                s["lost" if s["poses"] else "pre_init"] += 1
            elif np.shape(pose) != (4, 4) or not np.isfinite(pose).all():
                failed, err = True, f"malformed pose {np.asarray(pose)!r}"
            else:
                s["poses"].append((k, np.array(pose, np.float64)))
        self._advance(restart=failed)
        return failed, err

    def _advance(self, restart: bool) -> None:
        if self.mode == "slam":
            self.pos += 1
            if self.pos >= self.n or restart:
                self.sessions[-1]["ended"] = self.pos >= self.n
                self.pos = 0
                self.new_session()
            return
        if restart:
            self.new_session()
        nxt = self.pos + self.direction
        if not 0 <= nxt < self.n:
            self.direction = -self.direction
            nxt = self.pos + self.direction
        self.pos = nxt


def _install_launch_records(rec: trace.Recorder) -> None:
    """Spans around local BA, and records of B1 and B2 launches, at the
    module attributes the program calls them through."""
    from ucoslam_tpu_torch.matching import projection
    from ucoslam_tpu_torch.optim import ba, pnp

    from portbench.rooflines import b1, b2

    ba.local_bundle_adjustment = rec.wrap("ba.local_ba", ba.local_bundle_adjustment)
    projection.project_match = rec.record_launch("B1", projection.project_match, b1.capture)
    pnp.motion_only_lm_fused = rec.record_launch("B2", pnp.motion_only_lm_fused, b2.capture)
    pnp.motion_only_lm_fused_batched = rec.record_launch("B2", pnp.motion_only_lm_fused_batched, b2.capture)


def window_loop(stream, t_close: float, rng, sample_every: int, after_frame=None):
    """Hand frames over, closed-loop, until t_close. -> ((start, end) of
    every frame, frames handed over, frames failed, the first errors).
    About one frame in `sample_every` (drawn from rng) keeps its keypoints."""
    records, attempted, failed, errors = [], 0, 0, []
    while True:
        t_s = time.perf_counter()
        if t_s >= t_close:
            break
        attempted += 1
        stream.capture_next = rng.random() < 1.0 / sample_every
        bad, err = stream.step()
        t_e = time.perf_counter()
        stream.capture_next = False
        records.append((t_s, t_e))
        if bad:
            failed += 1
            if len(errors) < 3:
                errors.append(err)
        if after_frame is not None:
            after_frame(t_e)
    return records, attempted, failed, errors


def worker_main(conn, spec: dict) -> None:
    try:
        conn.send(("result", _worker(conn, spec)))
    except Exception:
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


def _worker(conn, spec: dict) -> dict:
    import torch

    from portbench.core import controls

    torch.set_num_threads(1)
    controls.apply(spec["control"])
    cuda = spec["device"].startswith("cuda")
    tracing = spec["trace"] and cuda
    rec = trace.Recorder(sync=torch.cuda.synchronize if tracing else None)
    if tracing:
        _install_launch_records(rec)
    with np.load(spec["clip_path"]) as z:
        clip = {k: z[k] for k in z.files}
    stream = Stream(spec, clip, rec)
    for _ in range(spec["plan"]["warm"]):
        failed, err = stream.step()
        if failed:
            raise RuntimeError(f"warm-up frame failed:\n{err}")
    if tracing:
        trace.warm_profiler()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    conn.send(("ready", time.perf_counter()))
    t_open, t_close = conn.recv()
    t_trace_end = t_open + spec["traffic"]["trace_seconds"]
    while time.perf_counter() < t_open:
        time.sleep(0.0005)
    rng = rng_for(spec["seed"], 0xCA97, spec["index"])
    dev_trace, stopped = None, []

    def after_frame(t_e: float) -> None:
        if dev_trace is not None and not stopped and t_e >= t_trace_end:
            rec.active = False
            stopped.append(time.perf_counter())  # the window ends before the tracer's teardown
            dev_trace.stop()

    if tracing:
        dev_trace = trace.DeviceTrace()
        dev_trace.start()
        rec.active = True
    records, attempted, failed, errors = window_loop(stream, t_close, rng, spec["traffic"]["sample_every"],
                                                     after_frame)
    after_frame(float("inf"))
    trace_stop = stopped[0] if stopped else None
    out = dict(records=records, attempted=attempted, failed=failed, errors=errors,
               forbidden=guard.forbidden_loaded(), index=spec["index"])
    if cuda:
        torch.cuda.synchronize()
        out["memory_peak_bytes"] = torch.cuda.max_memory_reserved()
    if tracing:
        out["trace"] = _trace_record(rec, dev_trace.events, t_open, trace_stop)
    stream.slam.clear()
    stream.slam = None
    if cuda:
        torch.cuda.empty_cache()
    out["judged"] = judge_stream(stream, clip["poses"], spec)
    return out


def _trace_record(rec: trace.Recorder, events, t_open: float, t_stop: float) -> dict:
    """What the parent merges: device events, spans, frames, and each
    kernel launch's counted work."""
    from portbench.rooflines import b1, b2

    works = {"B1": [b1.least_seconds(b1.work(a)) for a in rec.launches.get("B1", [])],
             "B2": [b2.least_seconds(b2.work(a)) for a in rec.launches.get("B2", [])]}
    rec.launches.clear()
    return dict(events=events, spans=rec.spans, t_open=t_open, t_stop=t_stop, works=works)


def judge_stream(stream: Stream, gt_poses, spec: dict) -> dict:
    """The reference's readings of one stream: each session's trajectory
    error, its frames before the first pose and lost after it, and the
    sampled frames' keypoints."""
    from portbench.reference import ate, orb

    params = spec["config"]["params"]
    sessions = [{"ate": ate.session_ate(s["poses"], gt_poses), "poses": len(s["poses"]), "lost": s["lost"],
                 "pre_init": s["pre_init"], "ended": s["ended"]} for s in stream.sessions]
    detector = detector_settings(params)
    gaps, bits, kp_diff, kp_all = [], [], 0, 0
    dev = spec["device"]
    for k, xy, octave, angle, desc, valid in stream.captured:
        v = valid.cpu().numpy()
        xy_v, oct_v = xy.cpu().numpy()[v], octave.cpu().numpy()[v]
        got = orb.compare(stream.image[k], xy_v, oct_v, angle.cpu().numpy()[v], desc.cpu().numpy()[v].view(np.uint32),
                          params["nOctaveLevels"], params["scaleFactor"], device=dev)
        gaps.append(got["angle_gaps"])
        bits.append(got["bit_diffs"])
        diff, both = orb.keypoint_gap(stream.image[k], xy_v, oct_v, **detector, device=dev)
        kp_diff, kp_all = kp_diff + diff, kp_all + both
    return dict(sessions=sessions, angle_gaps=np.concatenate(gaps) if gaps else np.zeros(0),
                bit_diffs=np.concatenate(bits) if bits else np.zeros(0, np.int64), frames_compared=len(gaps),
                kp_diff=kp_diff, kp_all=kp_all)


def detector_settings(params: dict) -> dict:
    """The detector the configuration's Params state, as the reference's
    `detect` takes it: full resolution, a fixed FAST threshold."""
    if params["autoAdjustKpSensitivity"] or params["kptImageScaleFactor"] != 1.0 or params["targetFocus"] > 0:
        raise ValueError("the keypoint reference judges a fixed threshold at full resolution only")
    nms = params["KPNonMaximaSuppresion"]
    return dict(n_levels=params["nOctaveLevels"], scale_factor=params["scaleFactor"],
                max_features=min(params["maxFeatures"], params["maxKeyPointsPerFrame"]),
                cell=64 if nms else 32, k_per_cell=1 if nms else 4, threshold=FAST_THRESHOLD)


# ---------------------------------------------------------------- parent


def run(ctx) -> dict:
    """Run one fleet cell: set-up, the window, the comparison. -> the
    generator's readings (see `portbench/run.py`)."""
    cfg, trf = ctx.config, ctx.traffic
    cores = len(os.sched_getaffinity(0))
    n = n_streams_for(trf, cores)
    streams = plan(trf, ctx.seed, n, cfg["scene"]["n_frames"])
    clips = ensure_clips(ctx.root, cfg, [s["scene_seed"] for s in streams], processes=max(1, min(cores, 8)))
    mpc = mp.get_context("spawn")
    workers, smi = [], None
    for i, p in enumerate(streams):
        spec = dict(index=i, plan=p, config=cfg, traffic=trf, seed=ctx.seed, device=ctx.device, trace=ctx.trace,
                    root=ctx.root, clip_path=clips[p["scene_seed"]], control=ctx.control)
        parent_end, child_end = mpc.Pipe()
        proc = mpc.Process(target=worker_main, args=(child_end, spec), daemon=True)
        proc.start()
        child_end.close()
        workers.append((proc, parent_end))
    try:
        for proc, conn in workers:
            msg = _recv(conn, proc, ctx.setup_timeout)
            if msg[0] != "ready":
                raise RuntimeError(f"a stream failed in set-up:\n{msg[1]}")
        t_open = time.perf_counter() + 0.05
        t_close = t_open + ctx.seconds
        for _, conn in workers:
            conn.send((t_open, t_close))
        smi = trace.SmiSampler() if ctx.trace and ctx.device.startswith("cuda") else None
        results, died = [], 0
        for proc, conn in workers:
            try:
                msg = _recv(conn, proc, ctx.seconds + ctx.judge_timeout)
            except (EOFError, TimeoutError):
                died += 1
                continue
            if msg[0] != "result":
                died += 1
                ctx.log(f"stream error:\n{msg[1]}")
                continue
            results.append(msg[1])
        utilization = smi.stop(t_open, t_open + trf["trace_seconds"]) if smi else None
    finally:
        if smi is not None and smi.proc is not None and smi.proc.poll() is None:
            smi.proc.kill()
            smi.proc.wait()
        for proc, conn in workers:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
                proc.join()
            conn.close()
    out = summarize(results, died, n, cores, t_open, t_close, ctx)
    out["info"]["smi_utilization_pct"] = utilization
    return out


def _recv(conn, proc, timeout: float):
    """The next message from a worker; EOFError when it died, TimeoutError
    when it sent nothing in time."""
    deadline = time.monotonic() + timeout
    while not conn.poll(0.2):
        if not proc.is_alive() and not conn.poll(0):
            raise EOFError("worker died")
        if time.monotonic() > deadline:
            raise TimeoutError("worker sent nothing in time")
    return conn.recv()


def summarize(results: list[dict], died: int, n: int, cores: int, t_open: float, t_close: float, ctx) -> dict:
    from portbench.core import stats

    records = [r for res in results for r in res["records"]]
    for res in results:
        for err in res["errors"]:
            ctx.log(f"stream {res['index']} failed a frame:\n{err}")
    sessions = [s for res in results for s in res["judged"]["sessions"]]
    gaps = np.concatenate([res["judged"]["angle_gaps"] for res in results]) if results else np.zeros(0)
    bits = np.concatenate([res["judged"]["bit_diffs"] for res in results]) if results else np.zeros(0)
    ates = session_ates(sessions, ctx.traffic["min_session_poses"])
    after_init = sum(s["poses"] + s["lost"] for s in sessions)
    kp_all = sum(res["judged"]["kp_all"] for res in results)
    readings = {
        "ate_max": max(ates) if ates else float("inf"),
        "pre_init_max": max((s["pre_init"] for s in sessions), default=float("inf")),
        "lost_share": sum(s["lost"] for s in sessions) / after_init if after_init else 1.0,
        "angle_gap_p99": float(np.quantile(gaps, 0.99)) if len(gaps) else float("inf"),
        "desc_bit_share": float(bits.sum()) / (256.0 * len(bits)) if len(bits) else float("inf"),
        "keypoint_gap": sum(res["judged"]["kp_diff"] for res in results) / kp_all if kp_all else float("inf"),
    }
    info = dict(streams=n, cores=cores, sessions=len(sessions), sessions_judged=len(ates),
                session_ates=[round(a, 5) for a in ates],
                memory_peaks=[res.get("memory_peak_bytes", 0) for res in results],
                keypoints_compared=int(len(gaps)), bit_diff_max=int(bits.max()) if len(bits) else None, frames_compared=sum(r["judged"]["frames_compared"] for r in results),
                pre_init=[s["pre_init"] for s in sessions], angle_gap_p50=float(np.median(gaps)) if len(gaps) else None,
                angle_gap_max=float(gaps.max()) if len(gaps) else None, workers_died=died)
    out = dict(
        attempted=sum(res["attempted"] for res in results) + died,
        failed=sum(res["failed"] for res in results) + died,
        answered=died == 0,
        end_to_end={"fps": stats.fps(records, t_open, t_close),
                    "frame_ms_p95": stats.p95_ms(records, t_open, t_close)} if records else {},
        readings=readings, info=info,
        memory_peak_bytes=sum(res.get("memory_peak_bytes", 0) for res in results),
        forbidden=sorted({m for res in results for m in res["forbidden"]}),
        t_open=t_open,
    )
    if ctx.trace and results and all("trace" in res for res in results):
        out["trace"] = merge_traces([res["trace"] for res in results], records, t_open, ctx.traffic["trace_seconds"])
    return out


def session_ates(sessions: list[dict], min_poses: int) -> list[float]:
    """The trajectory error of each session judged: those with `min_poses`
    poses or more, and, as failed (inf), those that reached their clip's end
    with fewer."""
    out = []
    for s in sessions:
        if s["poses"] >= min_poses and s["ate"] is not None:
            out.append(s["ate"])
        elif s["ended"]:
            out.append(float("inf"))
    return out


def merge_traces(traces: list[dict], records, t_open: float, trace_seconds: float) -> dict:
    """One view of the streams' traces for the metric readers."""
    t1 = t_open + trace_seconds
    events = [e for tr in traces for e in tr["events"]]
    kernels = [e for e in events if trace.is_kernel(e[0])]
    frames = sum(1 for tr in traces for name, _, _, d in tr["spans"] if name == "frontend.extract" and d == 0)
    table = trace.kernel_table(events, t_open, max(tr["t_stop"] for tr in traces))
    return dict(
        spans=[tr["spans"] for tr in traces], frames=frames, events_kernels=len(kernels),
        kernels=table, works={k: [w for tr in traces for w in tr["works"][k]] for k in ("B1", "B2")},
        busy_s=trace.busy_seconds(events, t_open, t1), window_s=trace_seconds,
        breakdown={"device_ops": trace.top_ops(table),
                   "idle_gaps": trace.gaps_by_span(events, [tr["spans"] for tr in traces], t_open, t1)},
    )
