"""Run the JAX package's two-pass harness on the parity scenarios' PNG trees.

The reference the port's harness (`ucoslam_tpu_torch.apps.test_sequence`) is
held to by chip_smoke phase 13 and by `tools/port/run_scenario.py --png`.
Each scenario is `tools/parity/run_parity.py`'s
(`chip_smoke.harness_scenario`): the JAX package's `SyntheticSequence` written to disk by the JAX package's own writers
(`write_synthetic_tum`, with 16-bit depth for `rgbd`;
`write_synthetic_euroc` with both cameras for `stereo`), the camera file
run_parity.py writes (`chip_smoke.write_camera_yml`: the sequence's camera,
its baseline included), the
bundled vocabulary, and `ucoslam_tpu.apps.test_sequence.main` run on the
tree in-process with run_parity.py's switches (`--rgbd`, `--stereo`,
`--recovery --save-every 40` for `loop`, a `--params` file with
`aruco_markerSize` 0.6 for `markers`). On the `mono` tree it then runs
`ucoslam_tpu.apps.test_reloc` against pass 1's map.

Per scenario it records pass 1 and pass 2 frames tracked, the ATE of the
pass-2 trajectory (Horn, scale-aligned) and its metric ATE (rigid, no
scale), keyframes, points, recoveries, the harness's fps (CPU) and, for
`mono`, the relocalization rate; into `--out` (default
`data/torch_port/harness_jax.json`) under the key of the frame count, so the
60-frame trees of chip_smoke phase 13 and the 150-frame runs beside
run_scenario.py share one file:

    JAX_PLATFORMS=cpu python -m tools.port.harness_reference            # mono, rgbd, stereo at 60
    JAX_PLATFORMS=cpu python -m tools.port.harness_reference --frames 150 --scenario all --jobs 3

`--jobs N` runs the scenarios in N child processes at once. Imports nothing
of the port (from chip_smoke only its scenario table and camera writer).

`--init-seeds N` runs each scenario once for each of N keys of the two-view
init's draws (0x1717, the package's own, then 1, 2, ...; every
`MapInitializer` the harness builds takes the key, in place of 0x1717) and
writes the runs as a spread (default
`data/torch_port/<scenario><frames>_harness_spread_jax.json`) for
`tools/port/slam_spread.py --compare`, beside the port's
(`tools/port/run_scenario.py --png --init-seeds N`):

    JAX_PLATFORMS=cpu python -m tools.port.harness_reference --frames 150 --scenario loop --init-seeds 8 --jobs 4
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from chip_smoke import HARNESS_REF_PATH as OUT  # noqa: E402
from chip_smoke import HARNESS_TREES as PHASE13  # noqa: E402
from chip_smoke import RIG_CAMERA, harness_scenario, write_camera_yml  # noqa: E402

SCENARIOS = ("mono", "rgbd", "stereo", "markers", "loop", "loop_easy")


def parse_harness(text: str) -> dict:
    """The summary lines test_sequence prints after its two passes."""
    out = {}
    m = re.search(r"mappingFPS=([\d.]+) trackingFPS=([\d.]+) tracked=(\d+)/(\d+) pass1_tracked=(\d+)/\d+ "
                  r"recoveries=(\d+) keyframes=(\d+) points=(\d+)", text)
    if m is None:
        raise RuntimeError("test_sequence printed no summary line:\n" + text[-2000:])
    out.update(mapping_fps=float(m.group(1)), tracking_fps=float(m.group(2)), pass2_tracked=int(m.group(3)),
               frames=int(m.group(4)), pass1_tracked=int(m.group(5)), recoveries=int(m.group(6)),
               keyframes=int(m.group(7)), points=int(m.group(8)))
    m = re.search(r"steadyFPS=([\d.]+)", text)
    out["steady_fps"] = float(m.group(1)) if m else None
    # the recovery rollbacks, as (frame lost, frame rewound to), 0-based: where
    # the |@# lines (1-based) go back to an earlier image
    images = [int(x) for x in re.findall(r"^\|@# Image (\d+)/", text, re.M)]
    out["rewinds"] = [(a - 1, b - 1) for a, b in zip(images, images[1:]) if b <= a]
    return out


@contextlib.contextmanager
def init_key(seed: int | None):
    """Every MapInitializer built inside draws from PRNGKey(seed) (None: the
    package's own 0x1717); the package's class is restored on exit."""
    if seed is None:
        yield
        return
    import jax
    from ucoslam_tpu.slam import initializer

    cls = initializer.MapInitializer
    orig = cls.__init__

    def seeded(self, *a, **kw):
        orig(self, *a, **kw)
        self._key = jax.random.PRNGKey(seed)

    cls.__init__ = seeded
    try:
        yield
    finally:
        cls.__init__ = orig


def run_one(name: str, frames: int, workdir: str, seed: int | None = None) -> dict:
    from ucoslam_tpu.apps import test_reloc, test_sequence
    from ucoslam_tpu.apps.compare_logs import evaluate
    from ucoslam_tpu.config import Params
    from ucoslam_tpu.geometry.camera import CameraParams
    from ucoslam_tpu.io.datasets import write_synthetic_euroc, write_synthetic_tum
    from ucoslam_tpu.io.synthetic import SyntheticSequence

    sc = harness_scenario(name, frames)
    cam = CameraParams.create(**RIG_CAMERA) if sc["rig"] else None
    seq = SyntheticSequence(cam=cam, **sc["seq"])
    tree = os.path.join(workdir, name)
    t0 = time.perf_counter()
    if sc["layout"] == "euroc":
        write_synthetic_euroc(seq, tree, stereo=True)
    else:
        write_synthetic_tum(seq, tree, depth=sc["layout"] == "tum_depth")
    write_s = time.perf_counter() - t0
    cam_yml = os.path.join(workdir, f"{name}_cam.yml")
    write_camera_yml(cam_yml, seq.cam)
    out_dir = os.path.join(workdir, f"{name}_run")
    argv = ["--dataset", tree, "--out-dir", out_dir, "--camera", cam_yml, *sc["switches"]]
    if sc["params"]:
        pyml = os.path.join(workdir, f"{name}_params.yml")
        Params().replace(maxMapPoints=8192, maxKeyFrames=64, maxKeyPointsPerFrame=1024, maxDescDistance=60.0,
                         **sc["params"]).save_yml(pyml)
        argv += ["--params", pyml]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), init_key(seed):
        rc = test_sequence.main(argv)
    run_s = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"test_sequence exited {rc} on {name}")
    text = buf.getvalue()
    rec = parse_harness(text)
    est = os.path.join(out_dir, "trajectory.txt")
    gt = os.path.join(out_dir if sc["layout"] == "euroc" else tree, "groundtruth.txt")
    for key, scaled in (("ate", True), ("metric_ate", False)):
        ev = evaluate(est, gt, with_scale=scaled)
        rec[key] = None if ev is None else float(ev[0])
    rec.update(sequence=sc["seq"], rig=sc["rig"], layout=sc["layout"], argv=sc["switches"],
               write_s=write_s, harness_s=run_s)
    if seed is not None:
        rec["seed"] = seed
        rec["pass2_frames"] = trajectory_frames(est)
    if name == "mono" and seed is None:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            test_reloc.main(["--map", os.path.join(out_dir, "map.slm"), "--dataset", tree, "--camera", cam_yml])
        m = re.search(r"relocRate=([\d.]+) \((\d+)/(\d+)\)", buf.getvalue())
        rec["reloc"] = dict(rate=float(m.group(1)), ok=int(m.group(2)), frames=int(m.group(3)))
    print(f"[{name}] {json.dumps({k: v for k, v in rec.items() if k != 'sequence'})}", flush=True)
    return rec


def trajectory_frames(path: str) -> list:
    """The frame indices of a TUM trajectory the synthetic writers stamped
    i / 30 (both packages' write_synthetic_tum)."""
    with open(path) as f:
        return [round(30.0 * float(line.split()[0])) for line in f if line.strip() and not line.startswith("#")]


def merge(out_path: str, frames: int, results: dict) -> None:
    data = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            data = json.load(f)
    runs = data.setdefault("runs", {}).setdefault(str(frames), {})
    runs.update(results)
    data["note"] = ("JAX package, ucoslam_tpu.apps.test_sequence on CPU (JAX_PLATFORMS=cpu), trees written by "
                    "ucoslam_tpu.io.datasets; tools/port/harness_reference.py")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--scenario", action="append", choices=(*SCENARIOS, "all"),
                    help="default: chip_smoke phase 13's trees (mono, rgbd, stereo)")
    ap.add_argument("--jobs", type=int, default=1, help="scenarios run at once, each in its own process")
    ap.add_argument("--init-seeds", type=int, default=0, help="one run per init key (see above)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--part", help=argparse.SUPPRESS)  # a child's result file
    ap.add_argument("--seed", type=int, default=None, help=argparse.SUPPRESS)  # a child's init key
    args = ap.parse_args(argv)
    names = args.scenario or list(PHASE13)
    if "all" in names:
        names = list(SCENARIOS)
    if args.part:
        (name,) = names
        with tempfile.TemporaryDirectory() as d:
            rec = run_one(name, args.frames, d, args.seed)
        with open(args.part, "w") as f:
            json.dump(rec, f)
        return 0
    seeds = [0x1717] + list(range(1, args.init_seeds)) if args.init_seeds else [None]
    jobs = [(name, seed) for name in names for seed in seeds]
    results = {}
    if args.jobs <= 1:
        with tempfile.TemporaryDirectory() as d:
            for job in jobs:
                results[job] = run_one(job[0], args.frames, d, job[1])
    else:
        with tempfile.TemporaryDirectory() as d:
            pending, procs = list(jobs), {}
            while pending or procs:
                while pending and len(procs) < args.jobs:
                    name, seed = job = pending.pop(0)
                    part = os.path.join(d, f"{name}_{seed}.json")
                    cmd = [sys.executable, "-m", "tools.port.harness_reference", "--frames", str(args.frames),
                           "--scenario", name, "--part", part]
                    if seed is not None:
                        cmd += ["--seed", str(seed)]
                    procs[job] = (subprocess.Popen(cmd, cwd=REPO), part)
                for job, (p, part) in list(procs.items()):
                    if p.poll() is not None:
                        del procs[job]
                        if p.returncode != 0:
                            raise RuntimeError(f"{job} failed with exit code {p.returncode}")
                        with open(part) as f:
                            results[job] = json.load(f)
                time.sleep(1.0)
    if not args.init_seeds:
        out = args.out or OUT
        merge(out, args.frames, {name: rec for (name, _), rec in results.items()})
        print(f"wrote {out}: {sorted(name for name, _ in results)} at {args.frames} frames")
        return 0
    for name in names:
        out = args.out or os.path.join(REPO, "data", "torch_port", f"{name}{args.frames}_harness_spread_jax.json")
        runs = [results[(name, seed)] for seed in seeds]
        with open(out, "w") as f:
            json.dump(dict(scenario=name, frames=args.frames, seeds=seeds, runs=runs,
                           note="JAX package, ucoslam_tpu.apps.test_sequence on CPU, one run per init key; "
                                "tools/port/harness_reference.py --init-seeds"), f, indent=1)
        print(f"wrote {out}: {name} at {args.frames} frames over {len(seeds)} init keys")
    return 0


if __name__ == "__main__":
    sys.exit(main())
