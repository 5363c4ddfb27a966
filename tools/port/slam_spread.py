"""Spread of the port's monocular SLAM over the two-view init's draws.

The initializer draws its 256 F/H hypotheses from a numpy Generator seeded
0x1717 (`slam/initializer.py`); the JAX package draws from its own PRNG, so
the two packages' first maps differ by the draws alone, and so does all the
drift that follows. This runs pass 1 of chip_smoke.py's phase 5
(`UcoSlam(device="cuda").setParams` -> `process` per frame, with the
parameters the JAX package mapped with) once per seed, and prints per seed
the frame the init landed on, the frames tracked, the ATE, the keyframes,
points and insertions, beside the JAX package's one run; then the spread.

    python3 tools/port/slam_spread.py --frames 150 --seeds 5 [--markers] [--out FILE]

Seeds: 0x1717 (the port's own) and 1, 2, ... Needs a CUDA device. With
`--markers`, the pass is chip_smoke.py's phase 8 (a) on the `markers`
scene, and each seed also records the init's kind and frame and the mapped
markers' distance from the scene's; its "ate" is the metric ATE, without
scale alignment (the JAX side: `make_reference_map.py --markers
--init-seeds N`).

`--compare PORT_JSON` (no device needed) holds a written summary against the
JAX package's spread over its own draws (`--jax`, default
`data/torch_port/mono_init_spread_jax.json`, from
`tools/port/make_reference_map.py --init-seeds N`): each side's ATE median
and range, how many of the port/JAX pairs favour JAX, and the two-sided
Mann-Whitney U test of the two ATE samples (scipy; U is the port's); for
harness spreads (`run_scenario.py --png --init-seeds`, against
`harness_reference.py --init-seeds`) the same for pass 2's ATE, both
passes' tracked frames and the frames pass 2 loses against pass 1; for
`--markers` summaries also the same by the init's kind, Fisher's exact test
of the kinds' shares, and the markers' distance from the scene's.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from ucoslam_tpu_torch.api import UcoSlam  # noqa: E402
from ucoslam_tpu_torch.config import Params  # noqa: E402
from ucoslam_tpu_torch.io.serialize import load_map_meta  # noqa: E402


def pass1(scene, params: Params, seed: int, markers: bool = False, device="cuda") -> dict:
    """One forward SLAM pass with the initializer's draws seeded `seed`."""
    ref, cam, seq, images = scene
    slam = UcoSlam(device=device)
    slam.setParams(None, params, cam)
    slam._system.initializer._rng = np.random.default_rng(seed)
    poses, init = {}, None
    t0 = time.perf_counter()
    for i, img in enumerate(images):
        before = slam.map.n_keyframes
        pose = slam.process(img, fseq=i)
        if (k := chip_smoke.init_kind(slam, before)) is not None:
            init = dict(kind=k, frame=i)
        if pose is not None:
            poses[i] = pose
    seconds = time.perf_counter() - t0
    out = dict(seed=seed, init_frame=min(poses) if poses else None, init=init, tracked=len(poses),
               ate=chip_smoke.ate_of(poses, seq) if len(poses) >= 3 else None,
               keyframes=slam.map.n_keyframes, points=slam.map.n_points,
               insertions=slam._system.manager.n_insertions, seconds=seconds)
    if markers:
        ms = chip_smoke.metric_summary(poses, seq)
        out.update(ate=ms["metric_ate"], scale_aligned_ate=ms["ate"],
                   **chip_smoke.marker_errors(*slam.map.h("mk_id", "mk_pose", "mk_pose_valid"), poses, seq,
                                              seq.marker_poses))
    return out


def _summary(xs: list) -> dict:
    return dict(n=len(xs), median=float(np.median(xs)), min=min(xs), max=max(xs))


def compare(port_json: str, jax_json: str) -> dict:
    """The port's ATE spread against the JAX package's (module docstring).
    Where both sides recorded the init's kind (`--markers`): how many runs
    of each kind, Fisher's exact test of the two kinds' shares, each kind's
    ATE spread with its Mann-Whitney test, and the same for the mapped
    markers' mean distance from the scene's."""
    from scipy.stats import fisher_exact, mannwhitneyu

    with open(port_json) as f:
        port_runs = [r for r in json.load(f)["runs"] if r["ate"] is not None]
    with open(jax_json) as f:
        jax_runs = [r for r in json.load(f)["runs"] if r["ate"] is not None]

    def spread(key, port_rs, jax_rs):
        a, b = [r[key] for r in port_rs], [r[key] for r in jax_rs]
        test = mannwhitneyu(a, b, alternative="two-sided")
        return dict(port=_summary(a), jax=_summary(b), pairs_favouring_jax=sum(x > y for x in a for y in b),
                    pairs=len(a) * len(b), mann_whitney_u=float(test.statistic), p_two_sided=float(test.pvalue))

    out = spread("ate", port_runs, jax_runs)
    if all("pass2_tracked" in r for r in port_runs + jax_runs):
        # harness spreads (run_scenario.py --png / harness_reference.py
        # --init-seeds): "ate" is pass 2's; also both passes' frames and
        # what pass 2 loses against pass 1
        for r in port_runs + jax_runs:
            r["pass2_lost"] = r["pass1_tracked"] - r["pass2_tracked"]
        for key in ("pass2_tracked", "pass1_tracked", "pass2_lost"):
            out[key] = spread(key, port_runs, jax_runs)
    if all(r.get("init") for r in port_runs + jax_runs):
        kinds = sorted({r["init"]["kind"] for r in port_runs + jax_runs})
        by_kind = {k: ([r for r in port_runs if r["init"]["kind"] == k], [r for r in jax_runs if r["init"]["kind"] == k])
                   for k in kinds}
        out["init_kinds"] = {k: dict(port=len(p), jax=len(j)) for k, (p, j) in by_kind.items()}
        if len(kinds) == 2:
            table = [[len(by_kind[k][0]) for k in kinds], [len(by_kind[k][1]) for k in kinds]]
            out["init_kinds_fisher_p"] = float(fisher_exact(table).pvalue)
        out["ate_by_init_kind"] = {k: spread("ate", p, j) for k, (p, j) in by_kind.items() if len(p) > 1 and len(j) > 1}
        if all(r.get("marker_err_mean") is not None for r in port_runs + jax_runs):
            out["marker_err_mean_by_init_kind"] = {k: spread("marker_err_mean", p, j) for k, (p, j) in by_kind.items()
                                                   if len(p) > 1 and len(j) > 1}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=60, choices=(60, 150))
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--markers", action="store_true", help="the markers scene (see above)")
    ap.add_argument("--out", default=None, help="also write the JSON summary here")
    ap.add_argument("--compare", metavar="PORT_JSON", default=None, help="compare a written summary with --jax")
    ap.add_argument("--jax", default=os.path.join(REPO, "data", "torch_port", "mono_init_spread_jax.json"))
    args = ap.parse_args(argv)
    if args.compare:
        print(json.dumps(compare(args.compare, args.jax)))
        return
    if not torch.cuda.is_available():
        raise SystemExit("slam_spread: no CUDA device")
    from ucoslam_tpu_torch.slam.system import disable_tf32

    disable_tf32()
    map_path, ref_path = (chip_smoke.marker_paths if args.markers else chip_smoke.reference_paths)(args.frames)
    scene = chip_smoke.load_scene(ref_path)
    ref = scene[0]
    params = Params.from_dict(load_map_meta(map_path)["params"])
    runs = []
    for seed in [0x1717] + list(range(1, args.seeds)):
        runs.append(pass1(scene, params, seed, args.markers))
        print(json.dumps(runs[-1]), flush=True)
    ates = [r["ate"] for r in runs if r["ate"] is not None]
    if args.markers:
        j1 = ref["pass1"]
        jax = dict(tracked=j1["tracked"], ate=j1["metric_ate"], keyframes=j1["keyframes"], points=j1["points"],
                   init=j1["init"], marker_err_mean=j1["marker_err_mean"])
    else:
        jax = dict(tracked=ref["pass1_tracked"], ate=ref["pass1_ate"], keyframes=ref["n_keyframes"],
                   points=ref["n_points"], insertions=ref.get("pass1_insertions"))
    summary = dict(
        frames=args.frames, markers=args.markers, device=torch.cuda.get_device_name(0),
        nvidia_smi=subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                  capture_output=True, text=True, timeout=60).stdout.strip(),
        jax=jax, ate_min=min(ates), ate_median=float(np.median(ates)), ate_max=max(ates),
        tracked_min=min(r["tracked"] for r in runs), tracked_max=max(r["tracked"] for r in runs),
        gate_ate=1.2 * jax["ate"] + 0.002, within_gate=sum(a <= 1.2 * jax["ate"] + 0.002 for a in ates), runs=runs,
    )
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items() if k != "runs"}))


if __name__ == "__main__":
    main()
