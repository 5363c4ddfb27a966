"""The stereo fleet generator: rectified stereo cameras, one `UcoSlam` each,
in worker processes that share one card.

A traffic mix of this generator (`"generator": "stereo_fleet"`) takes the
fleet generator's parameters (`portbench/core/fleet.py`; "slam" mode only)
and runs them on a configuration whose camera has a baseline `bl` and whose
`sensor` is "stereo": each stream hands every frame's rectified pair to
`UcoSlam.processStereo`. The streams' plan, window, end-to-end numbers,
traces and six readings are the fleet generator's, the angle, descriptor
and keypoint readings taken over the sampled frames' left and right images
together. A stereo session adds two readings:

- `ate_metric_max`: the largest judged session's RMS camera-centre error
  after the best rigid motion, no scale (`reference/stereo.py`): the map's
  scale is the rig's baseline;
- `depth_gap`: over the sampled frames' valid left keypoints, the share whose
  depth the program and the reference (`reference/stereo.py::stereo_depth`,
  from the uint8 pair and the program's left and right keypoints, each set
  judged against the reference detector above) disagree on: one has a depth
  and the other none, or the two differ by more than DEPTH_RTOL.

Traced runs add two bench spans, `frontend.stereo` (the row match and
subpixel refinement, `frame_extractor.stereo_depth`) and
`mapping.stereo_points` (`MapManager._create_stereo_points`), the least
time of each `frontend.stereo` call's work (`portbench/rooflines/stereo.py`)
and the device time of what those calls launched.
Controls and planted faults come from `portbench/core/stereo_controls.py`.
"""

from __future__ import annotations

import bisect
import hashlib
import inspect
import json
import multiprocessing as mp
import os
import time
import traceback

import numpy as np

from portbench.core import fleet, guard, manifest, trace

#: relative depth difference within which the program and the reference
#: agree: the disparity is float32 (pixel coordinates up to 752 carry 6.1e-5
#: px of rounding, the vertex fit's SAD sums a few ulps of 121 x 255), and
#: the least disparity of the scene is about 11 px, so rounding moves a depth
#: by 1e-6-1e-5 relative; 1e-4 is 0.0011 px at 11 px, ten times that
DEPTH_RTOL = 1e-4


# ---------------------------------------------------------------- frames


def clip_path(root: str, config: dict, scene_seed: int) -> str:
    """The render cache's file of one clip's pairs: a hash of everything
    that decides their pixels, the renderers' sources included."""
    scene = config["scene"]
    mod = manifest.scene_module(scene["renderer"])
    with open(mod.QUADS) as f:
        src = inspect.getsource(mod) + f.read()
    key = json.dumps([scene, config["camera"], config["sensor"], scene_seed], sort_keys=True) + src
    digest = hashlib.sha256(key.encode()).hexdigest()[:20]
    return os.path.join(root, "build", "portbench", "scenes", f"{scene['renderer']}_{digest}.npz")


def _render_pairs(job) -> list:
    """Pool task: (scene, camera, seed, frame indices) -> (index, uint8 left,
    uint8 right) of each frame."""
    scene, camera, seed, idx = job
    sc = manifest.scene_module(scene["renderer"]).make(scene, camera, seed)
    return [(i, *(fleet._u8(img) for img in sc.render_stereo(i))) for i in idx]


def ensure_clips(root: str, config: dict, scene_seeds, processes: int) -> dict:
    """scene seed -> clip file (`image`: the left images, `right`, `poses`),
    rendering the missing ones in a pool of `processes` spawned workers."""
    if config["sensor"] != "stereo":
        raise ValueError(f"sensor {config['sensor']!r}: the stereo fleet generator renders stereo pairs only")
    paths = {s: clip_path(root, config, s) for s in dict.fromkeys(scene_seeds)}
    missing = [s for s, p in paths.items() if not os.path.exists(p)]
    if not missing:
        return paths
    scene, camera = config["scene"], config["camera"]
    n = scene["n_frames"]
    chunks = [list(range(k, n, 10)) for k in range(10)]
    jobs = [(scene, camera, s, c) for s in missing for c in chunks]
    with mp.get_context("spawn").Pool(processes) as pool:
        parts = pool.map(_render_pairs, jobs)
    for s in missing:
        frames = sorted((f for (job, part) in zip(jobs, parts) if job[2] == s for f in part), key=lambda f: f[0])
        sc = manifest.scene_module(scene["renderer"]).make(scene, camera, s)
        arrays = {"image": np.stack([f[1] for f in frames]), "right": np.stack([f[2] for f in frames]),
                  "poses": np.stack([sc.gt_pose(i) for i in range(n)])}
        os.makedirs(os.path.dirname(paths[s]), exist_ok=True)
        tmp = paths[s] + f".{os.getpid()}.tmp.npz"
        np.savez(tmp, **arrays)
        os.replace(tmp, paths[s])
    return paths


# ---------------------------------------------------------------- worker


class Stream(fleet.Stream):
    """One stereo camera: fleet.Stream's sessions, each frame's pair handed
    to `processStereo`; the sampled frames keep, beside the left keypoints,
    their depths and the right keypoints they were matched against."""

    def __init__(self, spec: dict, clip: dict, rec: trace.Recorder):
        from ucoslam_tpu_torch.features import frame_extractor
        from ucoslam_tpu_torch.geometry.camera import CameraParams

        if spec["traffic"]["mode"] != "slam":
            raise ValueError("the stereo fleet generator runs SLAM sessions only")
        c = spec["config"]["camera"]
        self.stereo_cam = CameraParams.create(c["fx"], c["fy"], c["cx"], c["cy"], width=c["width"],
                                              height=c["height"], bl=c["bl"])
        self.right = clip["right"]
        self.captured_stereo: list[tuple] = []
        self._right_kps = None
        # the module attribute process_stereo calls
        frame_extractor.stereo_depth = rec.wrap("frontend.stereo", frame_extractor.stereo_depth)
        super().__init__(spec, clip, rec)

    def new_session(self) -> None:
        self.cam = self.stereo_cam
        super().new_session()
        slam = self.slam
        ext, manager = slam._extractor, slam._system.manager
        ext.process_stereo = self.rec.wrap("frontend.extract", self._capturing_pair(ext.process_stereo))
        manager._create_stereo_points = self.rec.wrap("mapping.stereo_points", manager._create_stereo_points)
        orb = ext.orb
        orb.detect_and_compute = self._keeping_last(getattr(orb.detect_and_compute, "__wrapped__",
                                                            orb.detect_and_compute))
        # fleet.Stream.step hands `process(left image, fseq)` over: a stereo
        # session answers it with the frame's pair
        slam.process = lambda img, fseq: slam.processStereo(img, self.right[self.pos], fseq)

    def _keeping_last(self, detect):
        """The detector, keeping a sampled frame's last keypoints: the right
        image's, which process_stereo detects after the left."""
        def wrapper(img):
            kps = detect(img)
            if self.capture_next:
                self._right_kps = tuple(t.clone() for t in (kps.xy, kps.octave, kps.angle, kps.desc, kps.valid))
            return kps

        wrapper.__wrapped__ = detect
        return wrapper

    def _capturing_pair(self, fn):
        def wrapper(*args, **kwargs):
            f = fn(*args, **kwargs)
            if self.capture_next:
                left = tuple(t.clone() for t in (f.xy, f.octave, f.angle, f.desc, f.valid))
                self.captured.append((self.pos, *left))
                self.captured_stereo.append((self.pos, f.depth.clone(), *left, *self._right_kps))
            return f
        return wrapper


def _install_stereo_records(rec: trace.Recorder) -> None:
    """Records of each traced `frontend.stereo` call's inputs, for its
    roofline (outside the span: the copies are not the step's time)."""
    from ucoslam_tpu_torch.features import frame_extractor

    from portbench.rooflines import stereo

    frame_extractor.stereo_depth = rec.record_launch("stereo", frame_extractor.stereo_depth, stereo.capture)


def worker_main(conn, spec: dict) -> None:
    try:
        conn.send(("result", _worker(conn, spec)))
    except Exception:
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


def _worker(conn, spec: dict) -> dict:
    import torch

    from portbench.core import stereo_controls

    torch.set_num_threads(1)
    stereo_controls.apply(spec["control"])
    cuda = spec["device"].startswith("cuda")
    tracing = spec["trace"] and cuda
    rec = trace.Recorder(sync=torch.cuda.synchronize if tracing else None)
    if tracing:
        fleet._install_launch_records(rec)
    with np.load(spec["clip_path"]) as z:
        clip = {k: z[k] for k in z.files}
    stream = Stream(spec, clip, rec)
    if tracing:
        _install_stereo_records(rec)
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
    rng = fleet.rng_for(spec["seed"], 0xCA97, spec["index"])
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
    records, attempted, failed, errors = fleet.window_loop(stream, t_close, rng, spec["traffic"]["sample_every"],
                                                           after_frame)
    after_frame(float("inf"))
    out = dict(records=records, attempted=attempted, failed=failed, errors=errors,
               forbidden=guard.forbidden_loaded(), index=spec["index"])
    if cuda:
        torch.cuda.synchronize()
        out["memory_peak_bytes"] = torch.cuda.max_memory_reserved()
    if tracing:
        out["trace"] = _trace_record(rec, dev_trace.events, t_open, stopped[0] if stopped else None)
    stream.slam.clear()
    stream.slam = None
    if cuda:
        torch.cuda.empty_cache()
    out["judged"] = judge_stream(stream, clip["poses"], spec)
    return out


def _trace_record(rec: trace.Recorder, events, t_open: float, t_stop: float) -> dict:
    """The fleet's trace record, with each `frontend.stereo` call's least
    time and the device time of the events the calls started."""
    from portbench.rooflines import stereo

    least = [stereo.least_seconds(stereo.work(a)) for a in rec.launches.pop("stereo", [])]
    out = fleet._trace_record(rec, events, t_open, t_stop)
    out["stereo_least"] = least
    out["stereo_device_s"] = span_device_seconds(events, rec.spans, "frontend.stereo")
    return out


def span_device_seconds(events, spans, name: str) -> float:
    """Device seconds of one process's events [(name, start, end)] that
    start inside its spans called `name`: a span synchronizes at both ends,
    so what runs inside it on this process's device queue is what its call
    launched."""
    iv = sorted((s, e) for n, s, e, _ in spans if n == name)
    starts = [s for s, _ in iv]
    total = 0.0
    for _, s, e in events:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s <= iv[i][1]:
            total += e - s
    return total


def judge_stream(stream: Stream, gt_poses, spec: dict) -> dict:
    """fleet.judge_stream's readings, with the sampled frames' right images
    judged beside their left ones, plus each session's metric trajectory
    error and the sampled frames' depth disagreements."""
    from portbench.reference import orb, stereo

    out = fleet.judge_stream(stream, gt_poses, spec)
    for s, judged in zip(stream.sessions, out["sessions"]):
        judged["ate_metric"] = stereo.session_metric_ate(s["poses"], gt_poses)
    cam, params = spec["config"]["camera"], spec["config"]["params"]
    bf, dev = cam["fx"] * cam["bl"], spec["device"]
    detector = fleet.detector_settings(params)
    gaps, bits = [out["angle_gaps"]], [out["bit_diffs"]]
    gap, with_depth, kps = 0, 0, 0
    for k, *tensors in stream.captured_stereo:
        depth, xy, octave, _, desc, v, xy_r, oct_r, ang_r, desc_r, valid_r = (t.cpu().numpy() for t in tensors)
        # the right image's keypoints and descriptors, judged as the left's
        right = orb.compare(stream.right[k], xy_r[valid_r], oct_r[valid_r], ang_r[valid_r],
                            desc_r[valid_r].view(np.uint32), params["nOctaveLevels"], params["scaleFactor"],
                            device=dev)
        gaps.append(right["angle_gaps"])
        bits.append(right["bit_diffs"])
        diff, both = orb.keypoint_gap(stream.right[k], xy_r[valid_r], oct_r[valid_r], **detector, device=dev)
        out["kp_diff"], out["kp_all"] = out["kp_diff"] + diff, out["kp_all"] + both
        ref = stereo.stereo_depth(stream.image[k], stream.right[k], xy, octave, desc.view(np.uint32), v, xy_r, oct_r,
                                  desc_r.view(np.uint32), valid_r, bf, cam["fx"], params["maxDescDistance"])[v]
        got = depth.astype(np.float64)[v]
        has, ref_has = got > 0, ref > 0
        both = has & ref_has
        far = np.abs(got[both] - ref[both]) > DEPTH_RTOL * ref[both]
        gap += int((has != ref_has).sum() + far.sum())
        with_depth += int(ref_has.sum())
        kps += int(v.sum())
    out.update(angle_gaps=np.concatenate(gaps), bit_diffs=np.concatenate(bits), depth_gap=gap, depth_kps=kps,
               depth_with=with_depth)
    return out


# ---------------------------------------------------------------- parent


def run(ctx) -> dict:
    """Run one stereo fleet cell: set-up, the window, the comparison. -> the
    generator's readings (see `portbench/run.py`)."""
    cfg, trf = ctx.config, ctx.traffic
    cores = len(os.sched_getaffinity(0))
    n = fleet.n_streams_for(trf, cores)
    streams = fleet.plan(trf, ctx.seed, n, cfg["scene"]["n_frames"])
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
            msg = fleet._recv(conn, proc, ctx.setup_timeout)
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
                msg = fleet._recv(conn, proc, ctx.seconds + ctx.judge_timeout)
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
    out = fleet.summarize(results, died, n, cores, t_open, t_close, ctx)
    out["info"]["smi_utilization_pct"] = utilization
    sessions = [s for res in results for s in res["judged"]["sessions"]]
    metric = fleet.session_ates([dict(s, ate=s["ate_metric"]) for s in sessions], trf["min_session_poses"])
    kps = sum(res["judged"]["depth_kps"] for res in results)
    out["readings"]["ate_metric_max"] = max(metric) if metric else float("inf")
    out["readings"]["depth_gap"] = sum(res["judged"]["depth_gap"] for res in results) / kps if kps else float("inf")
    out["info"].update(session_metric_ates=[round(a, 5) for a in metric],
                       depth_share=sum(res["judged"]["depth_with"] for res in results) / kps if kps else None)
    if "trace" in out:
        out["trace"]["works"]["stereo"] = [w for res in results for w in res["trace"]["stereo_least"]]
        out["trace"]["device_s"] = {"frontend.stereo": sum(res["trace"]["stereo_device_s"] for res in results)}
    return out
