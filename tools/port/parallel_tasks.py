"""Rank-side programs of the port's sharded solvers, for the tests and chip_smoke.py.

Each function runs on every rank of a world that
`ucoslam_tpu_torch.parallel.distributed.spawn` starts, receives the mesh
first and host (numpy) problems after it, and returns host results with the
mesh's collective counts. Imports only torch and the port, so a spawned rank
never loads JAX.
"""

from __future__ import annotations

import time

import torch

from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.parallel.distributed import to_device


def _sync(mesh):
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def ba(mesh, problem, cam: dict, iters: int, stages: int, solver: str = "auto", cg_iters: int = 32,
       repeats: int = 1) -> dict:
    """sharded_ba_solve on a shard_ba_problem problem (host arrays)."""
    from ucoslam_tpu_torch.parallel.sharded_ba import sharded_ba_solve

    problem = to_device(problem, mesh.device)
    cam = CameraParams.create(**cam)
    out, ms = None, []
    for _ in range(repeats):
        mesh.reset_counts()
        _sync(mesh)
        t0 = time.perf_counter()
        res = sharded_ba_solve(problem, cam, mesh, iters=iters, stages=stages, solver=solver, cg_iters=cg_iters)
        _sync(mesh)
        ms.append(1e3 * (time.perf_counter() - t0))
        out = dict(cam_pose=res.cam_pose, pt_pos=res.pt_pos, obs_chi2=res.obs_chi2, obs_bad=res.obs_bad,
                   costs=res.cost_history, mk_pose=res.mk_pose)
    return dict(out, collectives=mesh.collectives, gathers=mesh.gathers, ms=ms, size=mesh.size,
                device=str(mesh.device))


def pm(mesh, pm_problem, cam: dict, iters: int, stages: int, cg_iters: int = 32, relin_every: int = 6,
       repeats: int = 1) -> dict:
    """shard_pm_problem + sharded_pm_solve on a PMProblem (host arrays)."""
    from ucoslam_tpu_torch.parallel.sharded_pm import shard_pm_problem, sharded_pm_solve

    spm = shard_pm_problem(to_device(pm_problem, mesh.device), mesh.size)
    cam = CameraParams.create(**cam)
    out, ms = None, []
    for _ in range(repeats):
        mesh.reset_counts()
        _sync(mesh)
        t0 = time.perf_counter()
        cam_pose, pt_pos, costs, c2, bad = sharded_pm_solve(spm, cam, mesh, iters=iters, stages=stages,
                                                            cg_iters=cg_iters, relin_every=relin_every)
        _sync(mesh)
        ms.append(1e3 * (time.perf_counter() - t0))
        out = dict(cam_pose=cam_pose, pt_pos=pt_pos, costs=costs, c2=c2, bad=bad)
    return dict(out, collectives=mesh.collectives, gathers=mesh.gathers, ms=ms, size=mesh.size,
                device=str(mesh.device))


def posegraph(mesh, problem, iters: int, fix_scale: bool) -> dict:
    """sharded_pose_graph_solve on a shard_pose_graph_problem problem."""
    from ucoslam_tpu_torch.parallel.sharded_posegraph import sharded_pose_graph_solve

    mesh.reset_counts()
    poses = sharded_pose_graph_solve(to_device(problem, mesh.device), mesh, iters=iters, fix_scale=fix_scale)
    return dict(poses=poses, collectives=mesh.collectives, size=mesh.size)


def dispatch(mesh, problem, cam: dict, n_iters: int) -> dict:
    """ba._solve_dispatch with the mesh forced (set_ba_mesh), recording the
    route it takes -> the result and the route ("pm", "ba" or "single")."""
    from ucoslam_tpu_torch.optim import ba as ba_mod
    from ucoslam_tpu_torch.parallel import sharded_ba, sharded_pm

    routes = []
    wrapped = {}
    for mod, name, tag in ((sharded_pm, "sharded_pm_solve", "pm"), (sharded_ba, "sharded_ba_solve", "ba"),
                           (ba_mod, "ba_solve", "single")):
        inner = getattr(mod, name)
        wrapped[(mod, name)] = inner

        def logged(*a, _inner=inner, _tag=tag, **k):
            routes.append(_tag)
            return _inner(*a, **k)

        setattr(mod, name, logged)
    ba_mod.set_ba_mesh(mesh)
    try:
        problem = to_device(problem, mesh.device)
        res, solved = ba_mod._solve_dispatch(problem, CameraParams.create(**cam), n_iters,
                                             int(problem.pt_valid.sum()))
    finally:
        ba_mod.set_ba_mesh("auto")
        for (mod, name), inner in wrapped.items():
            setattr(mod, name, inner)
    return dict(routes=routes, cam_pose=res.cam_pose, pt_pos=res.pt_pos, costs=res.cost_history,
                obs_bad=res.obs_bad, collectives=mesh.collectives)


def batch(mesh, jobs) -> list:
    """Several of this module's programs in one world: jobs are (name,
    args, kwargs) -> their results in order."""
    return [globals()[name](mesh, *args, **kwargs) for name, args, kwargs in jobs]


def fail_on(mesh, rank: int):
    """Raise on `rank` (the spawner must fail the world)."""
    if mesh.rank == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    mesh.psum(torch.zeros(1, device=mesh.device))  # the others wait in a collective
    return mesh.rank


def pm_step_ms(mesh, pm_problem, cam: dict) -> dict:
    """The sharded point-major solver's ms an LM step, as chip_smoke.py's
    phase 11 measures the single device's ((t(24) - t(6)) / 18 of one-stage
    solves, warmed up), and its collectives an LM step and a
    relinearization, from the counts of solves that differ by one of them."""
    from ucoslam_tpu_torch.parallel.sharded_pm import shard_pm_problem, sharded_pm_solve

    spm = shard_pm_problem(to_device(pm_problem, mesh.device), mesh.size)
    cam = CameraParams.create(**cam)

    def run(iters, relin_every=6):
        mesh.reset_counts()
        _sync(mesh)
        t0 = time.perf_counter()
        sharded_pm_solve(spm, cam, mesh, iters=iters, stages=1, relin_every=relin_every)
        _sync(mesh)
        return time.perf_counter() - t0, mesh.collectives

    run(6), run(24)
    (t6, _), (t24, _) = run(6), run(24)
    per_step = (run(24, 24)[1] - run(6, 6)[1]) / 18
    per_relin = run(12, 6)[1] - run(12, 12)[1]
    return dict(ms_per_step=1e3 * (t24 - t6) / 18, collectives_per_step=per_step, collectives_per_relin=per_relin,
                size=mesh.size, device=str(mesh.device))


def async_guard(mesh) -> dict:
    """Whether a `System` in each mapping mode can be made under each
    setting of the BA dispatch in this world -> {case: "ok" | the error}.
    "auto (cuda)" stands the rank's CUDA check at True, as on a world of
    cards (the System itself runs on mesh.device)."""
    from ucoslam_tpu_torch.config import Params
    from ucoslam_tpu_torch.optim import ba as ba_mod
    from ucoslam_tpu_torch.slam.system import System

    cam = CameraParams.create(500.0, 500.0, 320.0, 240.0)
    out = {}
    cases = (("mesh", True, False), ("mesh", False, False), ("auto", False, False), ("auto", False, True),
             ("none", False, False))
    available = torch.cuda.is_available
    for setting, sequential, cuda in cases:
        params = Params().replace(maxMapPoints=256, maxKeyFrames=8, maxKeyPointsPerFrame=512,
                                  runSequential=sequential)
        ba_mod.set_ba_mesh({"mesh": mesh, "auto": "auto", "none": None}[setting])
        if cuda:
            torch.cuda.is_available = lambda: True
        try:
            system = System(params, cam, device=mesh.device)
            system.shutdown()
            result = "ok"
        except ValueError as e:
            result = str(e)
        finally:
            torch.cuda.is_available = available
            ba_mod.set_ba_mesh("auto")
        out[f"{setting}{' (cuda)' if cuda else ''} sequential={sequential}"] = result
    return out
