"""The port's sharded solvers (ucoslam_tpu_torch/parallel/) against the reference's.

Worlds of 1, 2 and 4 CPU ranks on gloo, started by the port's own spawner
(`parallel.distributed.spawn`: each rank a child process importing only
torch and the port; its programs are `tools/port/parallel_tasks.py`); the
JAX side runs on `make_mesh(n)` of the 8 virtual CPU devices
(tests/conftest.py). Each world is started once and runs every case:

- `sharded_ba_solve` (dense and CG routes, and a map with marker vertices)
  against JAX's `sharded_ba_solve` (on 2 devices: each mesh size is a
  compile) and against the port's single-device `ba_solve`: cost histories
  within 1e-4 relative of JAX's and 1e-5 of the single solve, poses within
  1e-3, the same bad associations;
- `sharded_pose_graph_solve` against JAX's (2 devices) and JAX's
  single-device solve, with and without fix_scale: poses within 1e-4;
- `sharded_pm_solve` against both packages' single-device `pm_staged_lm`
  (JAX's own sharded point-major solver does not run: ROADMAP Queue 3):
  cost histories within 1e-4 relative, poses within 1e-3;
- the point-major solver's collectives: one a relinearization, two an LM
  step, one a stage, none inside PCG (the count does not move with
  cg_iters);
- the dispatch (`ba._solve_dispatch`): with a mesh set, a marker-free
  problem of >= 128 keyframes goes to the sharded point-major solver and a
  marker map to the general sharded one, as tests/test_sharded_ba.py:88 and
  tests/test_sharded_pm.py:113 check the reference's; "auto" does not
  shard a CPU world;
- async mapping refused where the dispatch may shard (world of 2);
- the single-process fallback (no world: nothing initialized, a mesh of
  one, the sharded solve equal to the single-device one bit for bit).

Two runs of one world size, a failing rank and apps/bench_scaling.py are in
tests/test_torch_parallel_apps.py.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import tests.test_torch_schur_pm as pm_tests
from tests.test_ba import CAM as REF_CAM
from tests.test_ba import build_marker_map
from tests.test_posegraph import ring_problem
from tools.port import parallel_tasks
from ucoslam_tpu.optim import ba as ref_ba
from ucoslam_tpu.optim import posegraph as ref_posegraph
from ucoslam_tpu.optim import schur_pm as ref_pm
from ucoslam_tpu.parallel import make_mesh as ref_make_mesh
from ucoslam_tpu.parallel import shard_ba_problem as ref_shard_ba
from ucoslam_tpu.parallel import shard_pose_graph_problem as ref_shard_pg
from ucoslam_tpu.parallel import sharded_ba_solve as ref_sharded_ba
from ucoslam_tpu.parallel import sharded_pose_graph_solve as ref_sharded_pg
from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.optim import ba, posegraph, schur_pm
from ucoslam_tpu_torch.optim.ba import BAProblem
from ucoslam_tpu_torch.parallel import distributed, make_mesh, shard_ba_problem, sharded_ba_solve
from ucoslam_tpu_torch.parallel.distributed import spawn, to_host
from ucoslam_tpu_torch.parallel.sharded_posegraph import shard_pose_graph_problem

torch.set_num_threads(2)

CAM = CameraParams.create(500.0, 500.0, 320.0, 240.0)
CAM_ARGS = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0)
WORLDS = (1, 2, 4)
ITERS = 8


def port_problem(ref_problem) -> BAProblem:
    """A reference BAProblem's arrays as the port's (int32 indices -> int64)."""
    out = {}
    for f in dataclasses.fields(BAProblem):
        v = getattr(ref_problem, f.name, None)
        if v is None or f.name == "bf":
            continue
        a = np.array(v)
        out[f.name] = torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a)
    return BAProblem(**out, bf=float(ref_problem.bf))


def marker_problems():
    m, _, _, _ = build_marker_map()
    ref_problem, _, _, mk_slots = ref_ba.build_ba_problem(m, REF_CAM)
    assert len(mk_slots) == 2
    return ref_problem, port_problem(ref_problem)


def problems():
    """name -> (reference problem, port problem, solver, stages)."""
    dense = pm_tests.from_test_ba(n_kf=8, n_pt=200, depth_frac=0.3, outlier_frac=0.05)
    cg = pm_tests.from_test_ba(n_kf=8, n_pt=200, pose_noise=0.03)
    return {"dense": (*dense, "dense", 2), "cg": (*cg, "cg", 1), "markers": (*marker_problems(), "dense", 2)}


def pose_graph():
    problem, _, _ = ring_problem(scale_drift=1.03)
    return problem, posegraph.PoseGraphProblem(*(torch.from_numpy(np.array(x)) for x in problem))


def dispatch_problems():
    """A marker-free problem of 128 keyframes (point-major) and a marker map."""
    _, big = pm_tests.both(pm_tests.chip_smoke.ba_scale_problem(128, 1024, 4), pm_tests.chip_smoke.BA_BF)
    return {"pm": big, "ba": marker_problems()[1]}


@functools.cache
def data():
    """The problems, built once a process (not at import: every test worker
    imports this module)."""
    return dict(problems=problems(), pose_graph=pose_graph(), dispatch=dispatch_problems(),
                pm=schur_pm.build_pm_problem(pm_tests.from_test_ba(n_kf=8, n_pt=200, depth_frac=0.3)[1]))


def world_jobs(n: int):
    d = data()
    jobs = []
    for name, (_, port, solver, stages) in d["problems"].items():
        jobs.append(("ba", (to_host(shard_ba_problem(port, n)), CAM_ARGS, ITERS, stages, solver), {}))
    _, pg = d["pose_graph"]
    for fix_scale in (False, True):
        jobs.append(("posegraph", (to_host(shard_pose_graph_problem(pg, n)), 15, fix_scale), {}))
    for cg_iters in (8, 32):
        jobs.append(("pm", (to_host(d["pm"]), CAM_ARGS, 12, 2, cg_iters), {}))
    if n == 2:
        for p in d["dispatch"].values():
            jobs.append(("dispatch", (to_host(p), CAM_ARGS, 4), {}))
        jobs.append(("async_guard", (), {}))
    return jobs


NAMES = ("dense", "cg", "markers")  # the order of world_jobs' BA cases


@pytest.fixture(scope="module")
def worlds():
    """world size -> each rank's results of world_jobs (one world each, the
    three worlds at once: 7 single-threaded ranks)."""
    import concurrent.futures

    jobs = {n: world_jobs(n) for n in WORLDS}
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        futures = {n: pool.submit(spawn, parallel_tasks.batch, n, jobs[n], device="cpu", threads=1, timeout=900)
                   for n in WORLDS}
        return {n: f.result() for n, f in futures.items()}


@functools.cache
def ref_sharded(kind: str, name, n: int):
    """The reference's sharded solve at mesh size n (compiled once)."""
    if kind == "ba":
        ref_problem, _, solver, stages = data()["problems"][name]
        return ref_sharded_ba(ref_shard_ba(ref_problem, n), REF_CAM, ref_make_mesh(n), iters=ITERS, stages=stages,
                              solver=solver)
    ref_problem, _ = data()["pose_graph"]
    return np.asarray(ref_sharded_pg(ref_shard_pg(ref_problem, n), ref_make_mesh(n), iters=15, fix_scale=name))


def _case(worlds, n, index):
    """Rank 0's result of job `index`, after checking every rank agrees."""
    ranks = [r[index] for r in worlds[n]]
    for other in ranks[1:]:
        for k, v in ranks[0].items():
            if isinstance(v, np.ndarray):
                assert np.array_equal(v, other[k]), f"ranks disagree on {k}"
    return ranks[0]


def test_world_layout(worlds):
    for n in WORLDS:
        assert len(worlds[n]) == n
        assert all(r[0]["size"] == n and r[0]["device"] == "cpu" for r in worlds[n])


def bad_pairs(problem: BAProblem, bad: np.ndarray) -> set:
    """The (camera, point) pairs of the bad observations: the same in any
    observation order."""
    return set(zip(problem.obs_cam.numpy()[bad].tolist(), problem.obs_pt.numpy()[bad].tolist()))


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", ["dense", "cg", "markers"])
def test_sharded_ba_equals_reference(worlds, name, n):
    _, port, solver, stages = data()["problems"][name]
    got = _case(worlds, n, NAMES.index(name))
    # the reference's sharded solver at 2 devices (its compile is the cost);
    # every world size is held to the port's single-device solve below
    want = ref_sharded("ba", name, 2)
    rc = np.asarray(want.cost_history)
    assert (np.abs(got["costs"] - rc) <= 1e-4 * rc).all(), (got["costs"], rc)
    assert got["costs"][-1] < got["costs"][0]
    assert np.abs(got["cam_pose"] - np.asarray(want.cam_pose)).max() < 1e-3
    if n == 2:  # the same sharded observation order
        assert np.array_equal(got["obs_bad"], np.asarray(want.obs_bad))
    if name == "markers":
        assert np.abs(got["mk_pose"] - np.asarray(want.mk_pose)).max() < 1e-3
    single = ba.ba_solve(port, CAM, iters=ITERS, stages=stages, solver=solver)
    sc = single.cost_history.numpy()
    assert (np.abs(got["costs"] - sc) <= 1e-5 * sc).all(), (got["costs"], sc)
    assert np.abs(got["cam_pose"] - single.cam_pose.numpy()).max() < 1e-3
    assert bad_pairs(shard_ba_problem(port, n), got["obs_bad"]) == bad_pairs(port, single.obs_bad.numpy())
    # the collectives: per stage its starting cost, per LM step the system
    # and the acceptance cost, and on the CG route one per PCG iteration
    per_step = 2 + (32 if solver == "cg" else 0)
    assert got["collectives"] == stages * (1 + ITERS * per_step)
    assert got["gathers"] == 1


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("fix_scale", [False, True])
def test_sharded_pose_graph_equals_reference(worlds, fix_scale, n):
    ref_problem, _ = data()["pose_graph"]
    got = _case(worlds, n, len(NAMES) + int(fix_scale))
    np.testing.assert_allclose(got["poses"], ref_sharded("posegraph", fix_scale, 2), atol=1e-4)
    single = np.asarray(ref_posegraph.pose_graph_solve(ref_problem, iters=15, fix_scale=fix_scale))
    np.testing.assert_allclose(got["poses"], single, atol=1e-4)
    assert got["collectives"] == 2 * 15
    if fix_scale:  # every vertex keeps its starting scale (det of the rotation block = s^3)
        start = np.asarray(ref_problem.poses)
        np.testing.assert_allclose(np.linalg.det(got["poses"][:, :3, :3]), np.linalg.det(start[:, :3, :3]),
                                   rtol=1e-4)


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_pm_equals_single_device(worlds, n):
    got = _case(worlds, n, len(NAMES) + 3)  # cg_iters 32
    ref_problem, port = pm_tests.from_test_ba(n_kf=8, n_pt=200, depth_frac=0.3)
    want = ref_pm.pm_staged_lm(ref_pm.build_pm_problem(ref_problem), REF_CAM, iters=12, stages=2)
    mine = schur_pm.pm_staged_lm(schur_pm.build_pm_problem(port), CAM, iters=12, stages=2)
    P = port.pt_pos.shape[0]
    for what, (cp, pp, costs) in (("jax", want[:3]), ("port", mine[:3])):
        costs = np.asarray(costs)
        assert (np.abs(got["costs"] - costs) <= 1e-4 * costs).all(), (what, got["costs"], costs)
        assert np.abs(got["cam_pose"] - np.asarray(cp)).max() < 1e-3, what
        assert np.abs(got["pt_pos"][:P] - np.asarray(pp)).max() < 1e-2, what
    assert np.array_equal(got["bad"][:P], mine[4].numpy())


@pytest.mark.parametrize("n", WORLDS)
def test_pm_collectives_per_step_and_relinearization(worlds, n):
    """One collective a relinearization, two an LM step, one a stage's start,
    none inside PCG: the same count at cg_iters 8 and 32."""
    c8 = _case(worlds, n, len(NAMES) + 2)["collectives"]
    c32 = _case(worlds, n, len(NAMES) + 3)["collectives"]
    iters, stages, relin_every = 12, 2, 6
    n_macro = -(-iters // relin_every)
    R = -(-iters // n_macro)
    assert c8 == c32 == stages * (1 + n_macro * (1 + 2 * R))


def test_dispatch_routes(worlds):
    base = len(NAMES) + 4
    pm_case, ba_case = _case(worlds, 2, base), _case(worlds, 2, base + 1)
    assert pm_case["routes"] == ["pm"], pm_case["routes"]
    assert ba_case["routes"] == ["ba"], ba_case["routes"]
    single = ba.ba_solve(data()["dispatch"]["pm"], CameraParams.create(*pm_tests.chip_smoke.BA_CAMERA), iters=4, stages=2)
    sc = single.cost_history.numpy()
    assert (np.abs(pm_case["costs"] - sc) <= 1e-4 * sc).all()
    assert np.array_equal(pm_case["obs_bad"], single.obs_bad.numpy())
    # no world here, and "auto" never shards a CPU world
    assert ba._resolve_ba_mesh(10**6, "cpu") is None


def test_async_mapping_refuses_a_sharding_world(worlds):
    """In a world of 2, a System in async mode (runSequential=False) is
    refused wherever the dispatch may shard its BAs (a mesh set, or "auto"
    on CUDA ranks): its mapping worker would reach the collectives at its
    own time. Sequential mode, single-device solves and "auto" in a CPU
    world are made as before."""
    got = _case(worlds, 2, len(NAMES) + 6)
    assert got.pop("mesh sequential=True") == "ok"
    assert got.pop("auto sequential=False") == "ok"
    assert got.pop("none sequential=False") == "ok"
    assert set(got) == {"mesh sequential=False", "auto (cuda) sequential=False"}
    for case, err in got.items():
        assert err.startswith("runSequential=False with bundle adjustment sharded over the ranks"), (case, err)


def test_single_process_fallback(monkeypatch):
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.init_distributed() is False
    assert not torch.distributed.is_initialized()
    assert distributed.is_primary()
    assert make_mesh().device.type == distributed.global_mesh().device.type == "cuda"  # the card unless asked
    mesh = make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    assert distributed.global_mesh(device="cpu").size == 1
    assert ba.ba_mesh_spans_ranks() is False
    _, port, solver, stages = data()["problems"]["dense"]
    got = sharded_ba_solve(shard_ba_problem(port, 1), CAM, mesh, iters=ITERS, stages=stages, solver=solver)
    want = ba.ba_solve(port, CAM, iters=ITERS, stages=stages, solver=solver)
    assert torch.equal(got.cam_pose, want.cam_pose) and torch.equal(got.cost_history, want.cost_history)
