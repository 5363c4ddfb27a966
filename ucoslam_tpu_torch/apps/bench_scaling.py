"""Weak scaling of the sharded bundle adjustment over worlds of local ranks.

Port of `ucoslam_tpu/apps/bench_scaling.py`: the sharded Schur solver
(`parallel.sharded_ba.sharded_ba_solve`; `ba_solve` at one rank) on worlds
of 1, 2, 4, ... ranks started on this host by `parallel.distributed.spawn`,
with a CONSTANT load a rank (points and observations grow with the world),
reporting ms an LM iteration (one warm-up solve, then one timed one, over
its iterations) and the efficiency against the world of one; then the
point-major sharded solver's collectives at the largest world (two an LM
step, one a relinearization, none inside PCG, independent of cg_iters).
The problem is bench.py's (n_kf keyframes along a gentle curve, each point
seen by obs-per-point consecutive keyframes; its own copy, `scale_problem`).
It prints the JSON lines the reference's app prints, the collectives as
counted (all_reduce calls and payload bytes) where the reference reads them
from the compiled program. Not the repository's benchmark: it writes no file.

    python -m ucoslam_tpu_torch.apps.bench_scaling --max-ranks 2 [--points-per-device 4096]

Ranks: one card each under NCCL when there are enough cards, else gloo with
every rank on cuda:0 (NCCL refuses two ranks on one card); without a card
it exits with an error. `--device cpu` asks for gloo ranks on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ucoslam_tpu_torch.parallel.distributed import spawn, world_backend

#: bench.py's camera and stereo baseline x fx
CAMERA, BF = (500.0, 500.0, 320.0, 240.0), 50.0


def _se3_exp(xi: np.ndarray) -> np.ndarray:
    rho, phi = xi[:3].astype(np.float64), xi[3:].astype(np.float64)
    th = np.linalg.norm(phi)
    K = np.array([[0, -phi[2], phi[1]], [phi[2], 0, -phi[0]], [-phi[1], phi[0], 0]])
    if th < 1e-8:
        R, V = np.eye(3) + K, np.eye(3) + 0.5 * K
    else:
        a, b, c = np.sin(th) / th, (1 - np.cos(th)) / th**2, (th - np.sin(th)) / th**3
        R, V = np.eye(3) + a * K + b * K @ K, np.eye(3) + b * K + c * K @ K
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, V @ rho
    return T.astype(np.float32)


def scale_problem(n_kf: int, n_pt: int, obs_per_pt: int, seed: int = 7) -> dict:
    """bench.py's `_make_ba_problem` as numpy arrays (the draws of
    chip_smoke.ba_scale_problem, in the same order)."""
    fx, fy, cx, cy = CAMERA
    rng = np.random.default_rng(seed)
    X = rng.uniform(-4, 4, (n_pt, 3)).astype(np.float32)
    X[:, 2] = rng.uniform(6, 16, n_pt)
    poses = np.stack([_se3_exp(np.array(
        [0.1 * np.sin(k * 0.1), 0.05 * np.cos(k * 0.13), 0.002 * k, 0.005 * np.sin(k * 0.2),
         0.005 * np.cos(k * 0.1), 0.0], np.float32)) for k in range(n_kf)])
    base = (np.arange(n_pt, dtype=np.int64) * n_kf // n_pt).astype(np.int32)
    obs_cam2 = (base[:, None] + np.arange(obs_per_pt, dtype=np.int32)) % n_kf
    T = poses[obs_cam2]
    Xc = np.einsum("pmij,pj->pmi", T[:, :, :3, :3], X) + T[:, :, :3, 3]
    uv = np.stack([fx * Xc[..., 0] / Xc[..., 2] + cx, fy * Xc[..., 1] / Xc[..., 2] + cy], -1).astype(np.float32)
    uv += rng.normal(0, 0.5, uv.shape).astype(np.float32)
    O = n_pt * obs_per_pt
    poses_init = poses.copy()
    xi_n = rng.normal(0, 0.01, (n_kf, 6)).astype(np.float32)
    for k in range(1, n_kf):
        poses_init[k] = _se3_exp(xi_n[k]) @ poses[k]
    X_init = X + rng.normal(0, 0.05, X.shape).astype(np.float32)
    return dict(
        cam_pose=poses_init, cam_fixed=np.arange(n_kf) == 0, cam_valid=np.ones(n_kf, bool), pt_pos=X_init,
        pt_valid=np.ones(n_pt, bool), obs_cam=obs_cam2.reshape(-1).astype(np.int32),
        obs_pt=np.repeat(np.arange(n_pt, dtype=np.int32), obs_per_pt), obs_uv=uv.reshape(O, 2),
        obs_sigma2=np.ones(O, np.float32), obs_depth=np.zeros(O, np.float32), obs_valid=np.ones(O, bool),
        pt_obs=np.arange(O, dtype=np.int32).reshape(n_pt, obs_per_pt),
    )


def _problem(arrays: dict, device):
    from ucoslam_tpu_torch.optim.ba import BAProblem, _build_cam_obs

    def t(a):
        a = np.ascontiguousarray(a)
        return torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a).to(device)

    return BAProblem(**{k: t(v) for k, v in arrays.items()}, bf=BF,
                     cam_obs=t(_build_cam_obs(arrays["obs_cam"], arrays["cam_pose"].shape[0])))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _weak_rank(mesh, n_kf: int, n_pt: int, obs_per_pt: int, iters: int) -> dict:
    """One rank of a weak-scaling world: the world's problem, solved twice."""
    from ucoslam_tpu_torch.geometry.camera import CameraParams
    from ucoslam_tpu_torch.optim.ba import ba_solve
    from ucoslam_tpu_torch.parallel.sharded_ba import shard_ba_problem, sharded_ba_solve

    problem = _problem(scale_problem(n_kf, n_pt, obs_per_pt), mesh.device)
    cam = CameraParams.create(*CAMERA)
    if mesh.size == 1:
        def solve():
            return ba_solve(problem, cam, iters=iters, stages=1)
    else:
        sharded = shard_ba_problem(problem, mesh.size)

        def solve():
            return sharded_ba_solve(sharded, cam, mesh, iters=iters, stages=1)
    solve()
    _sync(mesh.device)
    mesh.reset_counts()
    t0 = time.perf_counter()
    solve()
    _sync(mesh.device)
    return dict(t_iter=(time.perf_counter() - t0) / iters, all_reduce_calls=mesh.collectives + mesh.gathers,
                all_reduce_bytes=mesh.bytes_reduced)


def _pm_rank(mesh, n_kf: int, n_pt: int, obs_per_pt: int, iters: int) -> dict:
    """The point-major sharded solver's collectives at cg_iters 8 and 32."""
    from ucoslam_tpu_torch.geometry.camera import CameraParams
    from ucoslam_tpu_torch.optim.schur_pm import pm_problem_for
    from ucoslam_tpu_torch.parallel.sharded_pm import shard_pm_problem, sharded_pm_solve

    pm = pm_problem_for(_problem(scale_problem(n_kf, n_pt, obs_per_pt), mesh.device))
    if pm is None:
        return dict(n_all_reduce=None)
    spm = shard_pm_problem(pm, mesh.size)
    counts = {}
    for cg in (8, 32):
        mesh.reset_counts()
        sharded_pm_solve(spm, CameraParams.create(*CAMERA), mesh, iters=iters, stages=1, cg_iters=cg)
        counts[cg] = mesh.collectives + mesh.gathers
    return dict(n_all_reduce=counts[32], independent_of_cg_iters=counts[8] == counts[32],
                bytes=mesh.bytes_reduced)


def _world(n: int, device: str) -> dict:
    """spawn's backend and device for a world of n ranks on `device`."""
    if device == "cuda" and torch.cuda.device_count() < n:
        device = "cuda:0"
    return dict(backend=world_backend(device, n), device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--points-per-device", type=int, default=4096)
    ap.add_argument("--keyframes", type=int, default=64)
    ap.add_argument("--obs-per-point", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--max-ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the ranks' devices: the cards (the default), or the CPU when asked")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device (--device cpu runs the world on the CPU)")
    sizes = [n for n in (1, 2, 4, 8, 16, 32, 64) if n <= args.max_ranks]
    rows, t1_iter = [], None
    for n in sizes:
        world = _world(n, args.device)
        out = spawn(_weak_rank, n, args.keyframes, args.points_per_device * n, args.obs_per_point, args.iters,
                    **world)
        dt = max(r["t_iter"] for r in out)
        if n == 1:
            t1_iter = dt
        rows.append({
            "devices": n, "points": args.points_per_device * n, "t_iter_ms": round(dt * 1e3, 3),
            "weak_scaling_efficiency": round(t1_iter / dt, 3),
            "collectives": None if n == 1 else dict(all_reduce_calls=out[0]["all_reduce_calls"],
                                                    all_reduce_bytes=out[0]["all_reduce_bytes"]),
            "backend": world["backend"], "device": world["device"],
        })
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"metric": "ba_weak_scaling", "rows": rows}))
    n = max((s for s in sizes if s > 1), default=None)
    if n:
        out = spawn(_pm_rank, n, args.keyframes, args.points_per_device * n, args.obs_per_point, args.iters,
                    **_world(n, args.device))[0]
        print(json.dumps({
            "metric": "sharded_pm_collectives", "devices": n, "n_all_reduce_sites": out["n_all_reduce"],
            "note": "all_reduce calls of one solve (two an LM step, one a relinearization, one a stage and one "
                    f"to assemble the outputs); the same at cg_iters 8 and 32: {out.get('independent_of_cg_iters')}",
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
