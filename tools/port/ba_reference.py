"""Write the JAX package's global BA at scale, which chip_smoke phase 11 holds the port to.

Hands `chip_smoke.ba_scale_problem`'s arrays (the problem of bench.py's
global-BA benchmark, rebuilt in numpy from the same draws: 128 keyframes x
16384 points x 131072 observations) to the JAX package's `ba_solve` with
solver="auto", ITERS LM steps and one stage (bench.py's `_ba_iter_time`
long run), and writes under `--out-dir` (default `data/torch_port`):

- `ba128_jax.json`: the problem's shape, the route `ba_solve` took
  (point-major when `pm_problem_for` builds the problem), the cost history,
  the skew cap's dropped observations, and the reference's own spread: the
  same solve by its dense and its CG route (solver="dense", "cg"), each
  pair's `chip_smoke.ba_gap` and final costs. This monocular problem fixes
  one camera, which leaves its scale free, and its points see little
  baseline, so the routes stop at different points of a flat valley: the
  spread is the yardstick for the port's cameras and points. Under
  `controls`, the "auto" solve cut to ITERS // 2 and ITERS // 4 LM steps,
  its cost and ba_gap from the full solve: what a solver that stops early
  reads on phase 11's gates;
- `ba128_jax.npz`: the optimized camera poses and points (float32) of the
  "auto" solve;
- under `ring128` in the JSON: the same spread for the global BA of
  chip_smoke's drifted ring map at 128 keyframes (`ring_loop_scene(n_kf=128)`,
  the first keyframe fixed, `baIters` LM steps a stage, two stages, as
  `globalOptimization`): each route's map chi2 after the BA is written back,
  and the largest keyframe-pose difference between the routes. The map is a
  chain of keyframes that share points only with their neighbours, so the
  routes part on it too.

    JAX_PLATFORMS=cpu python -m tools.port.ba_reference

About 4 minutes on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import jax.numpy as jnp
import numpy as np

import chip_smoke
from ucoslam_tpu.config import Params
from ucoslam_tpu.geometry.camera import CameraParams
from ucoslam_tpu.mapping import Map
from ucoslam_tpu.mapping.frame import empty_frame
from ucoslam_tpu.optim.ba import BAProblem, _build_cam_obs, apply_ba_result, ba_solve, build_ba_problem
from ucoslam_tpu.optim.schur_pm import pm_problem_for

#: the problem (bench.py's `_make_ba_problem` defaults) and the solve
SHAPE = dict(n_kf=128, n_pt=16384, obs_per_pt=8)
ITERS, STAGES = 24, 1


def reference_problem(arrays: dict) -> tuple[BAProblem, CameraParams]:
    """The JAX package's BAProblem of ba_scale_problem's arrays."""
    problem = BAProblem(**{k: jnp.asarray(v) for k, v in arrays.items()}, bf=jnp.float32(chip_smoke.BA_BF),
                        cam_obs=jnp.asarray(_build_cam_obs(arrays["obs_cam"], len(arrays["cam_pose"]),
                                                           len(arrays["obs_cam"]))))
    return problem, CameraParams.create(*chip_smoke.BA_CAMERA)


#: the ring map's parameters (chip_smoke.ring_ba_on's)
RING_PARAMS = Params().replace(maxDescDistance=60.0, detectMarkers=False, KFMinConfidence=0.4)


def ring_map(scene) -> Map:
    """The JAX package's Map of ring_loop_scene, the returning keyframe
    inserted (the keyframes of chip_smoke.ring_loop_map, without its
    keyframe database)."""
    m = Map(RING_PARAMS)
    n = m.state.N
    slots = m.add_points(scene["pts"], scene["normals"], scene["descs"], scene["min_dist"], scene["max_dist"],
                         np.zeros(len(scene["pts"]), np.int32), 0)

    def frame(uv, desc, ids, pose, fseq):
        k = len(uv)
        pad = lambda a, fill=0: np.concatenate([a, np.full((n - k,) + a.shape[1:], fill, a.dtype)])
        return empty_frame(n)._replace(
            fseq=jnp.int32(fseq), und_xy=jnp.asarray(pad(uv)), desc=jnp.asarray(pad(desc)),
            valid=jnp.asarray(np.arange(n) < k), ids=jnp.asarray(pad(ids.astype(np.int32), -1)),
            pose_f2g=jnp.asarray(pose))

    for kf in scene["kfs"]:
        m.add_keyframe(frame(kf["uv"], scene["descs"][kf["obs"]], slots[kf["obs"]], kf["pose"], kf["fseq"]))
    lp = scene["loop"]
    dup = m.add_points(lp["dup"], lp["dup_normals"], lp["desc"], lp["dup_min_dist"], lp["dup_max_dist"],
                       np.zeros(len(lp["dup"]), np.int32), 0)
    m.add_keyframe(frame(lp["uv"], lp["desc"], dup, lp["pose"], lp["fseq"]))
    return m


def ring_spread() -> dict:
    """Each route's global BA of the 128-keyframe ring map: map chi2 after,
    and the largest keyframe-pose difference between the routes."""
    scene = chip_smoke.ring_loop_scene(n_kf=128)
    cam = CameraParams.create(*chip_smoke.BA_CAMERA)
    chi2, poses = {}, {}
    for solver in ("auto", "dense", "cg"):
        m = ring_map(scene)
        problem, kf_slots, pt_slots, mk_slots = build_ba_problem(m, cam)
        r = ba_solve(problem, cam, iters=RING_PARAMS.baIters, stages=2, solver=solver)
        apply_ba_result(m, r, kf_slots, pt_slots, problem, mk_slots=mk_slots)
        chi2[solver] = float(m.global_reproj_chi2(cam))
        poses[solver] = np.asarray(m.state.kf_pose)[m.keyframes.active_slots()]
    pairs = (("dense", "auto"), ("cg", "auto"), ("cg", "dense"))
    return dict(vertex_slots=int(problem.cam_pose.shape[0]), iters=RING_PARAMS.baIters, chi2=chi2,
                pose={f"{a}_{b}": float(np.abs(poses[a] - poses[b]).max()) for a, b in pairs})


def route_gap(a, b, arrays: dict) -> dict:
    """chip_smoke.ba_gap between two BAResults of one problem, and a's final cost."""
    return dict(chip_smoke.ba_gap((a.cam_pose, a.pt_pos), (b.cam_pose, b.pt_pos), arrays),
                cost=float(np.asarray(a.cost_history)[-1]))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out-dir", default="data/torch_port")
    args = ap.parse_args(argv)
    arrays = chip_smoke.ba_scale_problem(**SHAPE)
    problem, cam = reference_problem(arrays)
    pm = pm_problem_for(problem)
    t0 = time.perf_counter()
    r = ba_solve(problem, cam, iters=ITERS, stages=STAGES, solver="auto")
    costs = np.asarray(r.cost_history)
    seconds = time.perf_counter() - t0
    out = dict(shape=SHAPE, iters=ITERS, stages=STAGES, solver="auto",
               route="point_major" if pm is not None else "general",
               dropped_obs=None if pm is None else int(pm.dropped_obs),
               cost_history=costs.tolist(), seconds_cpu=seconds)
    routes = {"auto": r}
    for solver in ("dense", "cg"):
        routes[solver] = ba_solve(problem, cam, iters=ITERS, stages=STAGES, solver=solver)
    out["spread"] = {f"{a}_{b}": route_gap(routes[a], routes[b], arrays)
                     for a, b in (("dense", "auto"), ("cg", "auto"), ("cg", "dense"))}
    out["controls"] = {str(n): route_gap(ba_solve(problem, cam, iters=n, stages=STAGES, solver="auto"), r, arrays)
                       for n in (ITERS // 2, ITERS // 4)}
    out["ring128"] = ring_spread()
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "ba128_jax.json"), "w") as f:
        json.dump(out, f, indent=1)
    np.savez_compressed(os.path.join(args.out_dir, "ba128_jax.npz"), cam_pose=np.asarray(r.cam_pose, np.float32),
                        pt_pos=np.asarray(r.pt_pos, np.float32))
    print(json.dumps({k: v for k, v in out.items() if k != "cost_history"}))


if __name__ == "__main__":
    main()
