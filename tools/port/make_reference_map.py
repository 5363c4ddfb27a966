"""Write the reference map and reverse-sweep trajectory the PyTorch port is held to.

Runs the JAX package (on any backend; the CPU is enough) through the two-pass
protocol on the rendered `mono` scenario:

- pass 1: SLAM over frames 0..F-1 from a fresh system, then `saveToFile`;
- pass 2: `readFromFile` -> `setMode(LOCALIZATION)` -> `process(render(i))`
  for i = F-1 .. 0 (the reverse sweep), starting from the pose the
  checkpoint restores.

The sequence is the `mono` parity scenario at the library's default widths
(the constants below), over `--frames` frames (default 60). Outputs, under
`--out-dir` (default `data/torch_port`): `mono_map.slm` (the checkpoint) and
`mono_reverse_jax.json` (pass-1/2 tracked counts, ATE, keyframe insertions,
the pass-2 poses, and the scene's depth extent used by the per-frame gate);
with another frame count F, `monoF_map.slm` and `monoF_reverse_jax.json`.

    JAX_PLATFORMS=cpu python -m tools.port.make_reference_map [--frames 150]

With `--init-seeds N`, runs only pass 1, once for each of N keys of the
two-view init's draws (0x1717, the package's own, then 1, 2, ...), and
writes `mono[F]_init_spread_jax.json` (per key: tracked frames, ATE,
keyframes, points), the JAX side of `tools/port/slam_spread.py`; with
`--markers` too, `markers[F]_init_spread_jax.json` (per key also the init's
kind and frame, the ATE metric, without scale alignment, and the mapped
markers' distance from the scene's).

The recovery scenarios (60 frames; any of the flags, run in turn), each
written to `mono_<name>_jax.json` with per-frame poses and counts:

- `--reloc` (`reloc`): `readFromFile(mono_map.slm)` -> `setMode(LOCALIZATION)`
  -> the reverse sweep with `resetTracker()` before each of RESET_FRAMES, so
  each of those frames goes through BoW relocalization;
- `--reloc-brute-force` (`reloc_bf`): the same with the keyframe database
  marked dummy, so relocalization matches against the whole point arena;
- `--gap` (`gap`): pass 1 with `resetTracker()` in place of GAP_FRAMES (they
  are not processed), so the frames after the gap relocalize;
- `--reseed` (`reseed`): pass 1 over SPLICE: frames 0..29 of the `mono`
  sequence, then frames 30..59 of another scene, which relocalization cannot
  match; after `reseedAfterLostFrames` lost frames the system two-view
  re-seeds a new map segment.

`--markers` runs the `markers` parity scenario instead (SEQUENCE with ten
0.6 m ARUCO_MIP_36h12 markers, the native detector, PARAMS with
`detectMarkers` and `aruco_markerSize=0.6`) and writes `markers[F]_map.slm`
and `markers[F]_jax.json`: pass 1 (tracked frames, metric ATE without scale
alignment, the Horn scale against the truth, markers with a map pose and
their position error, the init kind and frame), the reverse LOCALIZATION
sweep of the checkpoint, and the same sweep with `resetTracker()` at
MARKER_RESET_FRAME and the keypoints of MARKER_STRIP_FRAMES removed after
extraction, which only the marker fallback can pose.

`--marker-dictionary NAME` runs pass 1 of the `markers` scenario with its
markers drawn as codewords of dictionary NAME by the port's renderer
(`tools/port/marker_render.py`), the JAX package detecting them with
`aruco_Dictionary` = NAME (cv2 for a dictionary without a native table),
and writes `markers_<name>[F]_jax.json` (tracked frames, metric ATE, markers
with a map pose, the init, the poses) for chip_smoke.py phase 15:

    JAX_PLATFORMS=cpu python -m tools.port.make_reference_map --marker-dictionary TAG36h11

`--stereo` and `--rgbd` run the `stereo` and `rgbd` parity scenarios: SEQUENCE
seen by a rig with a 0.25 m baseline (DEPTH_CAMERA), through `processStereo`
on the rendered pair or `processRGBD` on the render and its z-buffer in the TUM
convention (`chip_smoke.depth_input`), with PARAMS. Each writes
`<kind>[F]_map.slm` and `<kind>[F]_jax.json`: pass 1 (tracked frames, metric
ATE without scale alignment, the init's frame and keyframes, keyframes,
points, the signature, the poses), the reverse LOCALIZATION sweep of the
checkpoint, and the share of frame FRONTEND_FRAME's keypoints that got a
depth. The JSON's camera carries `bl` and `rgb_depthscale`.

`--voc PATH` (`auto`: the repository's `data/vocab.fbow`) maps the `mono`
scenario with that `.fbow` vocabulary in the keyframe database
(`setParams(..., vocabulary=PATH)`) and writes `mono_voc_map.slm` and
`mono_voc_reverse_jax.json` (pass 1 and the reverse sweep, as above),
`mono_voc_reloc_jax.json` (the `--reloc` sweep of that map: BoW candidates
from the trained words), and `vocab_jax.npz`: the vocabulary's digest
(words, k, a SHA-256 of its centroids, weights and word ids), frame
FRONTEND_FRAME's descriptors from the JAX frontend and their word ids
(`quantize_words`).

`--async-trials N` runs pass 1 of the `mono` scenario once with PARAMS
(`runSequential=True`), once with `runSequential=False` and a
`waitForFinished()` after every frame (`drained`: the worker maps every
keyframe the tracker asks for before the next frame, so the run does not
depend on the host's speed), and N times with `runSequential=False` left
free, each drained at the end, and N times with `runSequential=False` and
the worker held back (`held`: each keyframe's mapping ends only once the
tracker has processed ASYNC_HOLD = 8 more frames, the pace of the port's
worker beside its tracker on an H100: 7-8 insertions in 57 tracked
frames), and writes `mono[F]_async_jax.json`: per run the init frame,
tracked frames, ATE, keyframe insertions, keyframes and points (the JAX
side of chip_smoke phase 12).

`--descriptor freak|surf` maps the `mono` scenario with that descriptor
family (`Params().setParams(True, FREAK or SURF)`, its own Hamming gate,
markers off) and writes `<family>_jax.json`: pass 1 (tracked frames, ATE,
keyframes, points, keyframe insertions, the signature) and the reverse
LOCALIZATION sweep of the reloaded checkpoint (tracked frames, ATE); the
checkpoint itself goes to a temporary directory. The JAX package's FREAK
and SURF tables have 64 rotation bins while its extractor quantizes angles
to `ucoslam_tpu.features.orb.DESC_BINS` = 32, so its first FREAK or SURF
frame raises (ROADMAP.md, Queue 3, known faults in the reference): for this
run only, that module constant is set to the tables' 64 at runtime; no file
of the package is changed.
"""

from __future__ import annotations

import argparse
import json
import os

import jax.numpy as jnp
import numpy as np

from chip_smoke import (
    FRONTEND_FRAME, depth_input, extract, feed, init_kind, marker_errors, metric_summary, reseed_frame,
)
from ucoslam_tpu.api import UcoSlam
from ucoslam_tpu.config import Mode, Params
from ucoslam_tpu.geometry.camera import CameraParams
from ucoslam_tpu.geometry.horn import ate_rmse
from ucoslam_tpu.io.synthetic import SyntheticSequence

SEQUENCE = dict(n_frames=60, n_points=1600, seed=5)  # tools/parity/run_parity.py `mono`
CAMERA = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480)
PARAMS = Params().replace(detectMarkers=False, maxDescDistance=60.0)
#: reverse-sweep frames preceded by resetTracker() in the relocalization scenarios
RESET_FRAMES = (59, 50, 40, 30, 20, 10)
#: frames skipped, each with a resetTracker(), in the gap scenario
GAP_FRAMES = tuple(range(30, 34))
#: the re-seed scenario's images: frame i < at of SEQUENCE, else frame i of `sequence`
SPLICE = dict(at=30, sequence=dict(n_frames=60, n_points=1600, seed=6))
#: tools/parity/run_parity.py `markers`: SEQUENCE with ten 0.6 m markers
MARKER_SEQUENCE = dict(SEQUENCE, n_markers=10, marker_size=0.6)
MARKER_PARAMS = PARAMS.replace(detectMarkers=True, aruco_markerSize=0.6)
#: the marker relocalization sweep: resetTracker() before this frame, and
#: these frames' keypoints removed after extraction
MARKER_RESET_FRAME = 20
MARKER_STRIP_FRAMES = tuple(range(20, 25))
#: tools/parity/run_parity.py `stereo` and `rgbd`: the camera with a 0.25 m
#: baseline, and the TUM depth scale (raw / 5000 = metres)
DEPTH_CAMERA = dict(CAMERA, bl=0.25, rgb_depthscale=1.0 / 5000.0)
DEPTH_SEQUENCE = {"stereo": dict(SEQUENCE, depth_mode="stereo"), "rgbd": dict(SEQUENCE)}
#: the async scenario's held-back passes: tracked frames each keyframe's mapping is held back
ASYNC_HOLD = 8


def camera_center(pose_f2g: np.ndarray) -> np.ndarray:
    pose = np.asarray(pose_f2g, np.float64)
    return -pose[:3, :3].T @ pose[:3, 3]


def ate_of(poses: dict[int, np.ndarray], seq: SyntheticSequence) -> float:
    idx = sorted(poses)
    if len(idx) < 3:
        return float("inf")
    est = np.stack([camera_center(poses[i]) for i in idx])
    return ate_rmse(est, seq.gt_positions()[idx], with_scale=True)


def map_depth_extent(slam: UcoSlam) -> float:
    """1st-99th percentile spread of the active map points' z (the map frame
    is the first keyframe's camera, so z is depth), in map units."""
    st = slam.map.state
    z = np.asarray(st.pt_pos)[np.asarray(st.pt_active), 2]
    lo, hi = np.percentile(z, [1.0, 99.0])
    return float(hi - lo)


def run(params: Params, cam: CameraParams, seq: SyntheticSequence, map_path: str, vocabulary: str | None = None):
    """-> (summary dict, reverse-sweep poses {frame: 4x4})."""
    frames = seq.n_frames
    slam = UcoSlam()
    slam.setParams(None, params, cam, vocabulary=vocabulary)
    fwd = {}
    for i in range(frames):
        pose = slam.process(seq.render(i), fseq=i)
        if pose is not None:
            fwd[i] = np.asarray(pose, np.float32)
    saved_signature = slam.map.signature()
    slam.saveToFile(map_path)
    extent = map_depth_extent(slam)

    loc = UcoSlam()
    loc.readFromFile(map_path, cam)
    loc.setMode(Mode.LOCALIZATION)
    rev = {}
    for i in reversed(range(frames)):
        pose = loc.process(seq.render(i), fseq=i)
        if pose is not None:
            rev[i] = np.asarray(pose, np.float32)
    summary = {
        "pass1_tracked": len(fwd),
        "pass1_ate": ate_of(fwd, seq),
        "pass2_tracked": len(rev),
        "pass2_ate": ate_of(rev, seq),
        "n_points": slam.map.n_points,
        "n_keyframes": slam.map.n_keyframes,
        "pass1_insertions": slam._system.manager.kf_counter - 2,  # after the two-view init
        "map_signature": saved_signature,
        "depth_extent": extent,
    }
    return summary, rev


def vocab_digest(path: str, cam: CameraParams, seq: SyntheticSequence) -> dict:
    """The .fbow vocabulary's digest, and frame FRONTEND_FRAME's descriptors
    (the JAX frontend's) with their word ids."""
    import hashlib

    from ucoslam_tpu.features.frame_extractor import FrameExtractor
    from ucoslam_tpu.io.fbow import load_fbow
    from ucoslam_tpu.mapping.kfdatabase import quantize_words

    v = load_fbow(path)
    h = hashlib.sha256()
    for a in (v.desc, v.weight, v.word_id):
        h.update(np.ascontiguousarray(a).tobytes())
    f = FrameExtractor(PARAMS, cam).process(seq.render(FRONTEND_FRAME), FRONTEND_FRAME)
    desc = np.asarray(f.desc)
    words = np.asarray(quantize_words(jnp.asarray(desc), jnp.asarray(v.desc)))
    return dict(n_words=np.int64(len(v.desc)), k=np.int64(v.k), desc_size=np.int64(v.desc_size),
                sha256=np.asarray(h.hexdigest()), frame=np.int64(FRONTEND_FRAME), desc=desc,
                valid=np.asarray(f.valid), words=words.astype(np.int32))


def init_spread(params: Params, cam: CameraParams, seq: SyntheticSequence, n_keys: int) -> list[dict]:
    """Pass 1 once per PRNG key of the initializer's draws."""
    import jax

    runs = []
    for key in [0x1717] + list(range(1, n_keys)):
        slam = UcoSlam()
        slam.setParams(None, params, cam)
        slam._system.initializer._key = jax.random.PRNGKey(key)
        fwd = {}
        for i in range(seq.n_frames):
            pose = slam.process(seq.render(i), fseq=i)
            if pose is not None:
                fwd[i] = np.asarray(pose, np.float32)
        runs.append(dict(key=key, init_frame=min(fwd) if fwd else None, tracked=len(fwd), ate=ate_of(fwd, seq),
                         keyframes=slam.map.n_keyframes, points=slam.map.n_points))
        print(json.dumps(runs[-1]), flush=True)
    return runs


def async_runs(cam: CameraParams, seq: SyntheticSequence, n_trials: int, hold: int) -> dict:
    """Pass 1 sequential once, async drained after every frame once, then
    async left free n_trials times and held back n_trials times."""
    import time

    from ucoslam_tpu.slam.mapmanager import MapManager

    tracker = {"frame": 0, "held": False}
    new_keyframe = MapManager.new_keyframe

    def held_new_keyframe(self, *a, **k):
        start = tracker["frame"]
        out = new_keyframe(self, *a, **k)
        while tracker["held"] and tracker["frame"] < start + hold:
            time.sleep(0.001)
        return out

    MapManager.new_keyframe = held_new_keyframe

    def one(params: Params, drained: bool = False, held: bool = False) -> dict:
        slam = UcoSlam()
        slam.setParams(None, params, cam)
        fwd = {}
        tracker.update(frame=0, held=held)
        for i in range(seq.n_frames):
            pose = slam.process(seq.render(i), fseq=i)
            tracker["frame"] += 1
            if pose is not None:
                fwd[i] = np.asarray(pose, np.float32)
            if drained:
                slam.waitForFinished()
        tracker["held"] = False
        slam.waitForFinished()
        out = dict(init_frame=min(fwd) if fwd else None, tracked=len(fwd), ate=ate_of(fwd, seq),
                   insertions=slam._system.manager.kf_counter - 2, keyframes=slam.map.n_keyframes,
                   points=slam.map.n_points)
        slam.clear()
        print(json.dumps(out), flush=True)
        return out

    free = PARAMS.replace(runSequential=False)
    return dict(sequential=one(PARAMS), drained=one(free, drained=True),
                trials=[one(free) for _ in range(n_trials)], hold=hold,
                held=[one(free, held=True) for _ in range(n_trials)])


def splice_images(cam: CameraParams, seq: SyntheticSequence) -> list:
    other = SyntheticSequence(cam=cam, **SPLICE["sequence"])
    return [seq.render(i) if i < SPLICE["at"] else other.render(i) for i in range(seq.n_frames)]


def poses_json(poses: dict) -> dict:
    return {str(i): np.asarray(poses[i]).tolist() for i in sorted(poses)}


def recovery(name: str, params: Params, cam: CameraParams, seq: SyntheticSequence, map_path: str) -> dict:
    """One recovery scenario of the module docstring -> its summary."""
    slam = UcoSlam()
    if name.startswith("reloc"):
        slam.readFromFile(map_path, cam)
        slam.setMode(Mode.LOCALIZATION)
        if name == "reloc_bf":
            slam._system.manager.kfdb.dummy = True
        frames, images = list(reversed(range(seq.n_frames))), None
    else:
        slam.setParams(None, params, cam)
        frames = list(range(seq.n_frames))
        images = splice_images(cam, seq) if name == "reseed" else None
    poses = {}
    for i in frames:
        if i in (RESET_FRAMES if name.startswith("reloc") else GAP_FRAMES if name == "gap" else ()):
            slam.resetTracker()
            if name == "gap":
                continue
        img = images[i] if images is not None else seq.render(i)
        pose = slam.process(img, fseq=i)
        if pose is not None:
            poses[i] = np.asarray(pose, np.float32)
    out = {"tracked": len(poses), "poses": poses_json(poses)}
    if name.startswith("reloc"):
        out.update(reset_frames=list(RESET_FRAMES), relocalized=sum(i in poses for i in RESET_FRAMES),
                   ate=ate_of(poses, seq))
    elif name == "gap":
        after = GAP_FRAMES[-1] + 1
        out.update(gap_frames=list(GAP_FRAMES), tracked_after_gap=sum(i >= after for i in poses),
                   ate=ate_of(poses, seq), map_signature=slam.map.signature())
    else:
        log = slam._system.stats_log
        at = reseed_frame(log, params.reseedAfterLostFrames)
        out.update(splice=SPLICE, reseed_frame=at, n_keyframes=slam.map.n_keyframes,
                   tracked_after_reseed=None if at is None else sum(i > at for i in poses),
                   stats_log=[{k: e[k] for k in ("fseq", "tracked", "n_kf")} for e in log])
    return out


def markers_pass1(cam: CameraParams, seq: SyntheticSequence, key: int | None = None):
    """Pass 1 of the markers scenario, the init's draws keyed `key` (the
    package's own by default) -> (UcoSlam, poses, the init's kind and frame)."""
    import jax

    slam = UcoSlam()
    slam.setParams(None, MARKER_PARAMS, cam)
    if key is not None:
        slam._system.initializer._key = jax.random.PRNGKey(key)
    fwd, kind = {}, None
    for i in range(seq.n_frames):
        before = slam.map.n_keyframes
        pose = slam.process(seq.render(i), fseq=i)
        k = init_kind(slam, before)
        if k is not None:
            kind = dict(kind=k, frame=i)
        if pose is not None:
            fwd[i] = np.asarray(pose, np.float32)
    return slam, fwd, kind


def marker_map_errors(slam: UcoSlam, fwd: dict, seq: SyntheticSequence) -> dict:
    st = slam.map.state
    return marker_errors(np.asarray(st.mk_id), np.asarray(st.mk_pose), np.asarray(st.mk_pose_valid), fwd, seq,
                         seq._marker_detector.poses)


def marker_init_spread(cam: CameraParams, seq: SyntheticSequence, n_keys: int) -> list[dict]:
    """Markers pass 1 once per PRNG key of the initializer's draws; "ate" is
    the metric ATE."""
    runs = []
    for key in [0x1717] + list(range(1, n_keys)):
        slam, fwd, kind = markers_pass1(cam, seq, key)
        ms = metric_summary(fwd, seq)
        runs.append(dict(key=key, init=kind, tracked=len(fwd), ate=ms["metric_ate"], scale_aligned_ate=ms["ate"],
                         **marker_map_errors(slam, fwd, seq), keyframes=slam.map.n_keyframes,
                         points=slam.map.n_points))
        print(json.dumps(runs[-1]), flush=True)
    return runs


def markers_run(cam: CameraParams, seq: SyntheticSequence, map_path: str) -> dict:
    """The `--markers` runs of the module docstring -> their summary."""
    slam, fwd, kind = markers_pass1(cam, seq)
    mk = marker_map_errors(slam, fwd, seq)
    pass1 = dict(tracked=len(fwd), **metric_summary(fwd, seq), **mk, init=kind, keyframes=slam.map.n_keyframes,
                 points=slam.map.n_points, insertions=slam._system.manager.kf_counter,
                 loop_closures=slam._system.manager.loop_closures,
                 signature=slam.map.signature(), poses=poses_json(fwd))
    slam.saveToFile(map_path)
    extent = map_depth_extent(slam)

    sweeps = {}
    for name in ("reverse", "reloc"):
        loc = UcoSlam()
        loc.readFromFile(map_path, cam)
        loc.setMode(Mode.LOCALIZATION)
        rev = {}
        for i in reversed(range(seq.n_frames)):
            if name == "reloc" and i == MARKER_RESET_FRAME:
                loc.resetTracker()
            f = loc._extractor.process(seq.render(i), i)
            if name == "reloc" and i in MARKER_STRIP_FRAMES:
                f = f._replace(valid=jnp.zeros_like(f.valid))
            pose = loc.process_frame(f)
            if pose is not None:
                rev[i] = np.asarray(pose, np.float32)
        sweeps[name] = dict(tracked=len(rev), **metric_summary(rev, seq), poses=poses_json(rev))
    sweeps["reloc"].update(reset_frame=MARKER_RESET_FRAME, strip_frames=list(MARKER_STRIP_FRAMES),
                           posed_by_markers=sum(str(i) in sweeps["reloc"]["poses"] for i in MARKER_STRIP_FRAMES))
    return dict(params=dict(detectMarkers=True, aruco_markerSize=0.6), pass1=pass1, depth_extent=extent,
                slm_bytes=os.path.getsize(map_path), **sweeps)


def marker_dictionary_run(name: str, frames: int, params: Params = MARKER_PARAMS) -> dict:
    """Pass 1 of the `markers` scenario with its markers drawn as codewords of
    dictionary `name` by the port's renderer (tools/port/marker_render.py:
    the JAX package's renderer draws ARUCO_MIP_36h12 only), the JAX package
    detecting them with `aruco_Dictionary` = name (cv2 for a dictionary
    without a native table) -> the summary phase 15 of chip_smoke.py and
    tests/test_torch_marker_slam_dict.py hold the port to."""
    from tools.port.marker_render import dictionary_scene
    from ucoslam_tpu_torch.geometry.camera import CameraParams as PortCamera

    c = CAMERA
    seq, ids, images, truth = dictionary_scene(name, dict(MARKER_SEQUENCE, n_frames=frames), cam=PortCamera.create(
        c["fx"], c["fy"], c["cx"], c["cy"], width=c["width"], height=c["height"]))
    params = params.replace(aruco_Dictionary=name)
    slam = UcoSlam()
    slam.setParams(None, params, CameraParams.create(c["fx"], c["fy"], c["cx"], c["cy"], width=c["width"],
                                                     height=c["height"]))
    fwd, kind = {}, None
    for i, img in enumerate(images):
        before = slam.map.n_keyframes
        pose = slam.process(img, fseq=i)
        k = init_kind(slam, before)
        if k is not None:
            kind = dict(kind=k, frame=i)
        if pose is not None:
            fwd[i] = np.asarray(pose, np.float32)
    st = slam.map.state
    mk = marker_errors(np.asarray(st.mk_id), np.asarray(st.mk_pose), np.asarray(st.mk_pose_valid), fwd, seq, truth)
    return dict(dictionary=name, backend="native" if slam._extractor.marker_detector._native else "cv2",
                sequence=dict(MARKER_SEQUENCE, n_frames=frames), ids={str(k): v for k, v in ids.items()},
                params=dict(detectMarkers=True, aruco_markerSize=params.aruco_markerSize, aruco_Dictionary=name,
                            maxKeyPointsPerFrame=params.maxKeyPointsPerFrame, maxMapPoints=params.maxMapPoints,
                            maxKeyFrames=params.maxKeyFrames, maxDescDistance=params.maxDescDistance),
                pass1=dict(tracked=len(fwd), **metric_summary(fwd, seq), **mk, init=kind,
                           keyframes=slam.map.n_keyframes, points=slam.map.n_points, poses=poses_json(fwd)))


def depth_run(kind: str, cam: CameraParams, seq: SyntheticSequence, map_path: str) -> dict:
    """The `--stereo` / `--rgbd` runs of the module docstring -> their summary."""
    slam = UcoSlam()
    slam.setParams(None, PARAMS, cam)
    fwd, init = {}, None
    for i in range(seq.n_frames):
        before = slam.map.n_keyframes
        pose = feed(slam, kind, depth_input(kind, seq, i), i)
        if before == 0 and slam.map.n_keyframes > 0:
            init = dict(frame=i, keyframes=slam.map.n_keyframes, metric_locked=slam._system.manager.metric_locked)
        if pose is not None:
            fwd[i] = np.asarray(pose, np.float32)
    pass1 = dict(tracked=len(fwd), **metric_summary(fwd, seq), init=init, keyframes=slam.map.n_keyframes,
                 points=slam.map.n_points, insertions=slam._system.manager.kf_counter,
                 loop_closures=slam._system.manager.loop_closures, signature=slam.map.signature(),
                 poses=poses_json(fwd))
    slam.saveToFile(map_path)
    extent = map_depth_extent(slam)
    f = extract(slam._extractor, kind, depth_input(kind, seq, FRONTEND_FRAME), FRONTEND_FRAME)
    valid = np.asarray(f.valid)
    with_depth = int((valid & (np.asarray(f.depth) > 0)).sum())
    frontend = dict(frame=FRONTEND_FRAME, keypoints=int(valid.sum()), with_depth=with_depth,
                    share=with_depth / max(int(valid.sum()), 1))

    loc = UcoSlam()
    loc.readFromFile(map_path, cam)
    loc.setMode(Mode.LOCALIZATION)
    rev = {}
    for i in reversed(range(seq.n_frames)):
        pose = feed(loc, kind, depth_input(kind, seq, i), i)
        if pose is not None:
            rev[i] = np.asarray(pose, np.float32)
    reverse = dict(tracked=len(rev), **metric_summary(rev, seq), poses=poses_json(rev))
    return dict(pass1=pass1, reverse=reverse, frontend=frontend, depth_extent=extent,
                slm_bytes=os.path.getsize(map_path))


def descriptor_run(family: str, cam: CameraParams, seq: SyntheticSequence) -> dict:
    """The `--descriptor` run of the module docstring -> its summary."""
    import tempfile

    import ucoslam_tpu.features.orb as orb
    from ucoslam_tpu.config import DescriptorType
    from ucoslam_tpu.features import descriptors

    params = Params().setParams(True, DescriptorType[family.upper()]).replace(detectMarkers=False)
    bins, orb.DESC_BINS = orb.DESC_BINS, descriptors.DESC_BINS
    try:
        with tempfile.TemporaryDirectory() as tmp:
            summary, rev = run(params, cam, seq, os.path.join(tmp, "map.slm"))
    finally:
        orb.DESC_BINS = bins
    return dict(descriptor=family, params=dict(kpDescriptorType=family.upper(), maxDescDistance=params.maxDescDistance,
                                               detectMarkers=False), **summary)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out-dir", default="data/torch_port")
    ap.add_argument("--frames", type=int, default=SEQUENCE["n_frames"])
    ap.add_argument("--init-seeds", type=int, default=0)
    ap.add_argument("--markers", action="store_true", help="the markers scenario (see above)")
    ap.add_argument("--marker-dictionary", default=None, help="pass 1 of the markers scenario with this "
                                                               "dictionary's markers (see above)")
    ap.add_argument("--stereo", action="store_true", help="the stereo scenario (see above)")
    ap.add_argument("--rgbd", action="store_true", help="the RGB-D scenario (see above)")
    ap.add_argument("--async-trials", type=int, default=0, help="pass 1 sequential and async (see above)")
    ap.add_argument("--voc", default=None, help="map with this .fbow vocabulary ('auto': data/vocab.fbow; see above)")
    ap.add_argument("--descriptor", choices=("freak", "surf"), default=None,
                    help="map with this descriptor family (see above)")
    for flag in ("reloc", "reloc-brute-force", "gap", "reseed"):
        ap.add_argument(f"--{flag}", action="store_true", help="a recovery scenario (see above)")
    args = ap.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    c = CAMERA
    cam = CameraParams.create(c["fx"], c["fy"], c["cx"], c["cy"], width=c["width"], height=c["height"])
    sequence = dict(SEQUENCE, n_frames=args.frames)
    seq = SyntheticSequence(cam=cam, **sequence)
    name = "mono" if args.frames == SEQUENCE["n_frames"] else f"mono{args.frames}"
    for kind in [k for k in ("stereo", "rgbd") if getattr(args, k)]:
        c = DEPTH_CAMERA
        cam = CameraParams.create(c["fx"], c["fy"], c["cx"], c["cy"], width=c["width"], height=c["height"],
                                  bl=c["bl"], rgb_depthscale=c["rgb_depthscale"])
        sequence = dict(DEPTH_SEQUENCE[kind], n_frames=args.frames)
        seq = SyntheticSequence(cam=cam, **sequence)
        name = name.replace("mono", kind)
        out = {"sequence": sequence, "camera": DEPTH_CAMERA, "params": dict(maxDescDistance=60.0, detectMarkers=False),
               **depth_run(kind, cam, seq, os.path.join(args.out_dir, f"{name}_map.slm"))}
        with open(os.path.join(args.out_dir, f"{name}_jax.json"), "w") as f:
            json.dump(out, f, indent=1)
        print(json.dumps({k: ({kk: vv for kk, vv in v.items() if kk != "poses"} if isinstance(v, dict) else v)
                          for k, v in out.items()}), flush=True)
        name = name.replace(kind, "mono")
    if args.stereo or args.rgbd:
        return
    if args.marker_dictionary:
        out = {"camera": CAMERA, **marker_dictionary_run(args.marker_dictionary, args.frames)}
        tag = args.marker_dictionary.lower() + ("" if args.frames == SEQUENCE["n_frames"] else str(args.frames))
        with open(os.path.join(args.out_dir, f"markers_{tag}_jax.json"), "w") as f:
            json.dump(out, f, indent=1)
        print(json.dumps({k: ({kk: vv for kk, vv in v.items() if kk != "poses"} if isinstance(v, dict) else v)
                          for k, v in out.items()}), flush=True)
        return
    if args.descriptor:
        out = {"sequence": sequence, "camera": CAMERA, **descriptor_run(args.descriptor, cam, seq)}
        with open(os.path.join(args.out_dir, name.replace("mono", args.descriptor) + "_jax.json"), "w") as f:
            json.dump(out, f, indent=1)
        print(json.dumps(out), flush=True)
        return
    if args.markers:
        sequence = dict(MARKER_SEQUENCE, n_frames=args.frames)
        seq = SyntheticSequence(cam=cam, **sequence)
        name = name.replace("mono", "markers")
        if args.init_seeds:
            runs = marker_init_spread(cam, seq, args.init_seeds)
            with open(os.path.join(args.out_dir, f"{name}_init_spread_jax.json"), "w") as f:
                json.dump({"sequence": sequence, "runs": runs}, f, indent=1)
            return
        out = {"sequence": sequence, "camera": CAMERA,
               **markers_run(cam, seq, os.path.join(args.out_dir, f"{name}_map.slm"))}
        with open(os.path.join(args.out_dir, f"{name}_jax.json"), "w") as f:
            json.dump(out, f, indent=1)
        print(json.dumps({k: ({kk: vv for kk, vv in v.items() if kk != "poses"} if isinstance(v, dict) else v)
                          for k, v in out.items()}), flush=True)
        return
    if args.voc:
        from ucoslam_tpu.io.fbow import default_vocab_path

        voc = default_vocab_path() if args.voc == "auto" else args.voc
        np.savez_compressed(os.path.join(args.out_dir, "vocab_jax.npz"), **vocab_digest(voc, cam, seq))
        map_path = os.path.join(args.out_dir, f"{name}_voc_map.slm")
        summary, rev = run(PARAMS, cam, seq, map_path, vocabulary=voc)
        with open(os.path.join(args.out_dir, f"{name}_voc_reverse_jax.json"), "w") as f:
            json.dump({"sequence": sequence, "camera": CAMERA, "vocabulary": os.path.basename(voc), **summary,
                       "reverse_poses": {str(i): rev[i].tolist() for i in sorted(rev)}}, f, indent=1)
        print(json.dumps(summary), flush=True)
        out = {"sequence": sequence, "camera": CAMERA, "scenario": "reloc", "vocabulary": os.path.basename(voc),
               **recovery("reloc", PARAMS, cam, seq, map_path)}
        with open(os.path.join(args.out_dir, f"{name}_voc_reloc_jax.json"), "w") as f:
            json.dump(out, f, indent=1)
        print(json.dumps({k: v for k, v in out.items() if k != "poses"}), flush=True)
        return
    if args.async_trials:
        out = {"sequence": sequence, "camera": CAMERA, **async_runs(cam, seq, args.async_trials, ASYNC_HOLD)}
        with open(os.path.join(args.out_dir, f"{name}_async_jax.json"), "w") as f:
            json.dump(out, f, indent=1)
        return
    if args.init_seeds:
        runs = init_spread(PARAMS, cam, seq, args.init_seeds)
        with open(os.path.join(args.out_dir, f"{name}_init_spread_jax.json"), "w") as f:
            json.dump({"sequence": sequence, "runs": runs}, f, indent=1)
        return
    map_path = os.path.join(args.out_dir, f"{name}_map.slm")
    chosen = [n for n, on in (("reloc", args.reloc), ("reloc_bf", args.reloc_brute_force),
                              ("gap", args.gap), ("reseed", args.reseed)) if on]
    for scenario in chosen:
        out = {"sequence": sequence, "camera": CAMERA, "scenario": scenario,
               **recovery(scenario, PARAMS, cam, seq, map_path)}
        with open(os.path.join(args.out_dir, f"{name}_{scenario}_jax.json"), "w") as f:
            json.dump(out, f, indent=1)
        print(json.dumps({k: v for k, v in out.items() if k not in ("poses", "stats_log")}), flush=True)
    if chosen:
        return
    summary, rev = run(PARAMS, cam, seq, map_path)
    out = {
        "sequence": sequence,
        "camera": CAMERA,
        **summary,
        "slm_bytes": os.path.getsize(map_path),
        "reverse_poses": {str(i): rev[i].tolist() for i in sorted(rev)},
    }
    with open(os.path.join(args.out_dir, f"{name}_reverse_jax.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "reverse_poses"}))


if __name__ == "__main__":
    main()
