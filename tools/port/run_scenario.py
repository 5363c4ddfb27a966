"""Run the PyTorch port on a parity scenario, through the two-pass harness.

The scenarios are `tools/parity/run_parity.py`'s, rebuilt with the port's
own `SyntheticSequence` (that script imports the JAX package): `mono` (60
frames, 1600 points), `loop_easy` (240 frames, 2200 points, the
`sweep_back` trajectory that returns to its start) and `markers` (150
frames, 1600 points, ten 0.6 m markers), on the sequence's own camera;
`stereo` and `rgbd` (150 frames, 1600 points) with a 0.25 m baseline, fed
through `processStereo` (the rendered pair) and `processRGBD` (the render
and its z-buffer in the TUM convention, `chip_smoke.depth_input`). The
protocol is `ucoslam_tpu/apps/test_sequence.py`'s, with its default
parameters (maxMapPoints 8192, maxKeyFrames 64, 1024 keypoints,
maxDescDistance 60; marker detection off where the scene holds no markers,
on with aruco_markerSize 0.6 for `markers`). The ATE of `markers`,
`stereo` and `rgbd` is metric, without scale alignment, as run_parity.py
takes it; run_parity.py feeds its images as 8-bit PNGs, this script the
float32 renders:
pass 1 maps the rendered frames in SLAM mode, then `globalOptimization`,
save; pass 2 reads the checkpoint, `setMode(LOCALIZATION)`,
`resetTracker()` and localizes the frames again. It prints per pass the
frames tracked, the ATE (Horn, scale-aligned) and the median ms per frame
(host clock to a device synchronize), and pass 1's loop candidates, loops
closed, keyframes and points, with the card's name and power limit.
`--voc PATH` loads that `.fbow` vocabulary into the keyframe database
(`auto`: the repository's `data/vocab.fbow`, as run_parity.py does); then
pass 1 also records, per keyframe whose loop query found candidates, the
candidates, those the PnP check verified, the loop found and whether its
correction stood (`record_loops`), for `tools/port/loop_reference.py`'s JAX
run of the same protocol:

    python3 tools/port/run_scenario.py --scenario loop_easy --voc auto [--out FILE]

`--png` runs the protocol as run_parity.py runs it: the scenario's PNG tree
written by the port's writer (`chip_smoke.write_tree`: TUM, with 16-bit
depth for `rgbd`, EuRoC for `stereo`), then the port's
`apps.test_sequence` on it in-process with run_parity.py's switches and
camera file (`chip_smoke.harness_scenario`), the bundled vocabulary, and
the sixth scenario, `loop` (`orbit_out`, 3000 points, `--recovery
--save-every 40`), which needs the harness's recovery rollback and so runs
only with `--png`. `--frames N` cuts every scenario to N frames. The row
holds both passes' tracked frames, the scale-aligned and the metric ATE of
the pass-2 trajectory (run_parity.py takes the metric one for `markers`,
`stereo` and `rgbd`), keyframes, points, recoveries, the harness's fps and
stage timers, the median PNG decode ms, B1 and B2 launches, and the JAX
package's harness on the same tree from `data/torch_port/harness_jax.json`
(`tools/port/harness_reference.py`) where it has that frame count:

    python3 tools/port/run_scenario.py --png --scenario loop --frames 150 [--out FILE]

`--init-seeds N` (with `--png`) writes the tree once and runs the harness
on it once for each of N seeds of the two-view init's draws (0x1717, the
port's own, then 1, 2, ...; every `MapInitializer` the harness builds takes
the seed), recording each run's passes, ATE, rollbacks and the frames pass
2 tracked; `tools/port/slam_spread.py --compare` holds the runs against the
JAX package's (`tools/port/harness_reference.py --init-seeds N`):

    python3 tools/port/run_scenario.py --png --scenario loop --frames 150 --init-seeds 8 --out FILE

`--keep-maps DIR` (with `--png`) keeps each run's map just before the
harness's global BA and after it (`<scenario>_<seed>_pre_gba.slm`,
`<scenario>_<seed>_map.slm`; seed None without `--init-seeds`), for the
other package's pass 2 on the same map.

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from ucoslam_tpu_torch.api import UcoSlam  # noqa: E402
from ucoslam_tpu_torch.config import Mode, Params  # noqa: E402
from ucoslam_tpu_torch.geometry.camera import CameraParams  # noqa: E402
from ucoslam_tpu_torch.io.synthetic import SyntheticSequence  # noqa: E402

SCENARIOS = {
    "mono": dict(n_frames=60, n_points=1600, seed=5),
    "loop_easy": dict(n_frames=240, n_points=2200, seed=5, trajectory="sweep_back"),
    "markers": dict(n_frames=150, n_points=1600, n_markers=10, marker_size=0.6, seed=5),
    "stereo": dict(n_frames=150, n_points=1600, seed=5, depth_mode="stereo"),
    "rgbd": dict(n_frames=150, n_points=1600, seed=5),
    "loop": dict(n_frames=360, n_points=3000, seed=5, trajectory="orbit_out"),
}
#: the camera of run_parity.py's `stereo` and `rgbd` scenes
DEPTH_CAMERA = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480, bl=0.25)
PARAMS = Params().replace(maxMapPoints=8192, maxKeyFrames=64, maxKeyPointsPerFrame=1024, maxDescDistance=60.0,
                          detectMarkers=False)


def record_loops(detector, kfmatch_module) -> list:
    """Wrap a LoopDetector (either package's) so that each keypoint loop
    query appends {kf_slot, fseq, candidates, verified, found, matched_kf,
    closed} to the returned list; `kfmatch_module` is the module namespace
    the detector's `match_keyframe_points_pnp_batch` is looked up in."""
    log = []
    detect, correct = detector.detect_from_keypoints, detector.correct_map
    name = "match_keyframe_points_pnp_batch"

    def detect_logged(world_map, kf_slot, frame, *a, **kw):
        entry = dict(kf_slot=int(kf_slot), fseq=int(np.asarray(frame.fseq)), candidates=[], verified=[])
        cands, match = detector.kfdb.relocalization_candidates, getattr(kfmatch_module, name)

        def cands_logged(*ca, **ck):
            out = cands(*ca, **ck)
            entry["candidates"] = [int(c) for c in out]
            return out

        def match_logged(wm, fr, cand_list, *ma, **mk):
            cms = match(wm, fr, cand_list, *ma, **mk)
            entry["verified"] = [int(c) for c, cm in zip(cand_list, cms) if bool(cm.ok)]
            return cms

        detector.kfdb.relocalization_candidates = cands_logged
        setattr(kfmatch_module, name, match_logged)
        try:
            info = detect(world_map, kf_slot, frame, *a, **kw)
        finally:
            del detector.kfdb.relocalization_candidates
            setattr(kfmatch_module, name, match)
        entry.update(found=bool(info.found), matched_kf=int(info.matched_kf), closed=False)
        log.append(entry)
        return info

    def correct_logged(world_map, info, *a, **kw):
        ok = correct(world_map, info, *a, **kw)
        if log and log[-1]["kf_slot"] == int(info.cur_kf):
            log[-1]["closed"] = bool(ok)
        return ok

    detector.detect_from_keypoints, detector.correct_map = detect_logged, correct_logged
    return log


def loop_summary(log: list) -> dict:
    """Totals of a record_loops log, and its entries with candidates."""
    return dict(queries=len(log), candidates=sum(len(e["candidates"]) for e in log),
                verified=sum(len(e["verified"]) for e in log), found=sum(e["found"] for e in log),
                closed=sum(e["closed"] for e in log), per_keyframe=[e for e in log if e["candidates"]])


def timed_pass(slam: UcoSlam, images, kind: str) -> tuple[dict, list]:
    poses, ms = {}, []
    for i, img in enumerate(images):
        t0 = time.perf_counter()
        pose = chip_smoke.feed(slam, kind, img, i)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        if pose is not None:
            poses[i] = pose
    return poses, ms


def run(name: str, vocabulary: str | None = None, frames: int | None = None) -> dict:
    kind = name if name in ("stereo", "rgbd") else "mono"
    cam = CameraParams.create(**DEPTH_CAMERA) if kind != "mono" else None
    seq = SyntheticSequence(cam=cam, **dict(SCENARIOS[name], n_frames=frames or SCENARIOS[name]["n_frames"]))
    images = [seq.render(i) if kind == "mono" else chip_smoke.depth_input(kind, seq, i) for i in range(seq.n_frames)]
    markers = name == "markers"
    params = PARAMS.replace(detectMarkers=True, aruco_markerSize=0.6) if markers else PARAMS
    metric = markers or kind != "mono"

    def ate(poses):
        if len(poses) < 3:
            return None
        return chip_smoke.metric_summary(poses, seq)["metric_ate"] if metric else chip_smoke.ate_of(poses, seq)

    slam = UcoSlam(device="cuda")
    slam.setParams(None, params, seq.cam, vocabulary=vocabulary)
    from ucoslam_tpu_torch.slam import loopclosure

    loops = record_loops(slam._system.manager.loop_detector, loopclosure)
    t0 = time.perf_counter()
    p1, ms1 = timed_pass(slam, images, kind)
    t_ba = time.perf_counter()
    slam.globalOptimization()
    torch.cuda.synchronize()
    t_ba = time.perf_counter() - t_ba
    t_map = time.perf_counter() - t0
    mgr = slam._system.manager
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "map.slm")
        slam.saveToFile(path)
        loc = UcoSlam(device="cuda")
        loc.readFromFile(path, seq.cam)
    loc.setMode(Mode.LOCALIZATION)
    loc.resetTracker()
    p2, ms2 = timed_pass(loc, images, kind)
    n = seq.n_frames
    return dict(
        scenario=name, sequence=dict(SCENARIOS[name], n_frames=n), frames=n,
        vocabulary=None if vocabulary is None else os.path.basename(vocabulary), loops=loop_summary(loops),
        pass1=dict(tracked=len(p1), tracked_pct=len(p1) / n, ate=ate(p1), metric_ate=metric,
                   ms_median=float(np.median(ms1)), ms_mean=float(np.mean(ms1)), seconds=t_map,
                   global_ba_s=t_ba, loop_queries=mgr.loop_detector.n_queries,
                   loop_candidates=mgr.loop_detector.n_candidates, loops_closed=mgr.loop_closures,
                   relocalizations=slam._system.tracker.n_relocalizations,
                   keyframes=slam.map.n_keyframes, points=slam.map.n_points),
        pass2=dict(tracked=len(p2), tracked_pct=len(p2) / n, ate=ate(p2),
                   ms_median=float(np.median(ms2))),
    )


@contextlib.contextmanager
def init_seed(seed: int | None):
    """Every MapInitializer built inside draws from default_rng(seed) (None:
    the port's own 0x1717); the class is restored on exit."""
    if seed is None:
        yield
        return
    from ucoslam_tpu_torch.slam import initializer

    cls = initializer.MapInitializer
    orig = cls.__init__

    def seeded(self, *a, **kw):
        orig(self, *a, **kw)
        self._rng = np.random.default_rng(seed)

    cls.__init__ = seeded
    try:
        yield
    finally:
        cls.__init__ = orig


@contextlib.contextmanager
def keep_maps(keep: str | None, tag: str):
    """With `keep`, the harness's map is also saved as keep/<tag>_pre_gba.slm
    just before its globalOptimization (the map after it is the harness's
    own map.slm, which run_png copies to keep/<tag>_map.slm)."""
    if keep is None:
        yield
        return
    orig = UcoSlam.globalOptimization

    def saving(self, *a, **kw):
        self.saveToFile(os.path.join(keep, f"{tag}_pre_gba.slm"))
        return orig(self, *a, **kw)

    UcoSlam.globalOptimization = saving
    try:
        yield
    finally:
        UcoSlam.globalOptimization = orig


def run_png(name: str, frames: int, workdir: str, seed: int | None = None, tree=None, keep: str | None = None) -> dict:
    """The scenario's PNG tree through the port's two-pass harness; `tree`:
    (sequence, scenario) of a tree already written under workdir/name;
    `keep`: a directory for the maps before and after the global BA."""
    from ucoslam_tpu_torch.apps import test_sequence
    from ucoslam_tpu_torch.apps.compare_logs import evaluate

    root = os.path.join(workdir, name)
    run_dir = os.path.join(workdir, f"{name}_run" if seed is None else f"{name}_run_{seed}")
    t0 = time.perf_counter()
    seq, sc = tree or chip_smoke.write_tree(name, frames, root)
    write_s = time.perf_counter() - t0
    cam_yml = os.path.join(workdir, f"{name}_cam.yml")
    chip_smoke.write_camera_yml(cam_yml, seq.cam)
    argv = ["--dataset", root, "--out-dir", run_dir, "--camera", cam_yml, *sc["switches"], "--device", "cuda"]
    if sc["params"]:
        pyml = os.path.join(workdir, f"{name}_params.yml")
        Params().replace(maxMapPoints=8192, maxKeyFrames=64, maxKeyPointsPerFrame=1024, maxDescDistance=60.0,
                         **sc["params"]).save_yml(pyml)
        argv += ["--params", pyml]
    chip_smoke.reset_counts()
    t0 = time.perf_counter()
    tag = f"{name}_{seed}"
    with init_seed(seed), keep_maps(keep, tag):
        chip_smoke.run_app(test_sequence.main, argv, os.path.join(workdir, f"{name}.log"))
    if keep is not None:
        shutil.copy(os.path.join(run_dir, "map.slm"), os.path.join(keep, f"{tag}_map.slm"))
    torch.cuda.synchronize()
    harness_s = time.perf_counter() - t0
    launches = chip_smoke.counts()
    with open(os.path.join(run_dir, "summary.json")) as f:
        row = json.load(f)
    gt = os.path.join(run_dir if sc["layout"] == "euroc" else root, "groundtruth.txt")
    ev = evaluate(os.path.join(run_dir, "trajectory.txt"), gt, with_scale=False)
    row.update(scenario=name, sequence=sc["seq"], switches=sc["switches"], metric_ate=None if ev is None else ev[0],
               parity_ate_is_metric=name in ("markers", "stereo", "rgbd"), write_s=write_s, harness_s=harness_s,
               launches=launches)
    if seed is not None:
        with open(os.path.join(run_dir, "trajectory.txt")) as f:
            row.update(seed=seed, pass2_frames=[round(30.0 * float(line.split()[0])) for line in f
                                                if line.strip() and not line.startswith("#")])
        return row
    with open(chip_smoke.HARNESS_REF_PATH) as f:
        row["jax"] = json.load(f)["runs"].get(str(frames), {}).get(name)
    return row


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scenario", choices=sorted(SCENARIOS), default="loop_easy")
    ap.add_argument("--out", default=None, help="also write the JSON result here")
    ap.add_argument("--voc", default=None, help="a .fbow vocabulary for the keyframe database ('auto': data/vocab.fbow)")
    ap.add_argument("--png", action="store_true",
                    help="write the scenario's PNG tree and run the port's apps.test_sequence on it")
    ap.add_argument("--frames", type=int, default=None, help="cut the scenario to this many frames")
    ap.add_argument("--init-seeds", type=int, default=0, help="with --png: one harness run per init seed")
    ap.add_argument("--keep-maps", default=None, help="with --png: keep each run's maps before and after the "
                                                       "global BA in this directory")
    args = ap.parse_args(argv)
    if (args.init_seeds or args.keep_maps) and not args.png:
        ap.error("--init-seeds and --keep-maps need --png")
    if args.keep_maps:
        os.makedirs(args.keep_maps, exist_ok=True)
    if args.scenario == "loop" and not args.png:
        ap.error("the loop scenario's protocol needs the harness's recovery rollback: run it with --png")
    if not torch.cuda.is_available():
        raise SystemExit("run_scenario: no CUDA device")
    from ucoslam_tpu_torch.slam.system import disable_tf32

    disable_tf32()
    from ucoslam_tpu_torch.io.fbow import default_vocab_path

    frames = args.frames or SCENARIOS[args.scenario]["n_frames"]
    if args.png and args.init_seeds:
        with tempfile.TemporaryDirectory() as d:
            tree = chip_smoke.write_tree(args.scenario, frames, os.path.join(d, args.scenario))
            runs = []
            for seed in [0x1717] + list(range(1, args.init_seeds)):
                runs.append(run_png(args.scenario, frames, d, seed, tree, args.keep_maps))
                print(json.dumps({k: v for k, v in runs[-1].items() if k not in ("sequence", "stage_ms")}), flush=True)
        out = dict(scenario=args.scenario, frames=frames, runs=runs)
    elif args.png:
        with tempfile.TemporaryDirectory() as d:
            out = run_png(args.scenario, frames, d, keep=args.keep_maps)
    else:
        out = run(args.scenario, default_vocab_path() if args.voc == "auto" else args.voc, frames)
    out["device"] = torch.cuda.get_device_name(0)
    out["nvidia_smi"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                       capture_output=True, text=True, timeout=60).stdout.strip()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
