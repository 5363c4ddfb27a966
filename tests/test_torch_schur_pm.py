"""The port's point-major and matrix-free CG bundle adjustment against the
JAX package's, on the CPU.

- `build_pm_problem`: every table (the (P, MO) grid, `o_src`, `cam_obs`, the
  camera-pair and vertex-pair tables) exactly equal to the reference's, on
  bench.py's problem at 128 keyframes x 1024 points x 4 observations
  (`chip_smoke.ba_scale_problem`) and on tests/test_ba.py's skewed graph,
  where the skew cap drops observations;
- `pm_staged_lm` on tests/test_ba.py's problems (every point seen by every
  keyframe; with stereo edges, and without): the cost history within 1e-4
  relative of the reference's at every step (the two never part there), the
  final cost within 1%, poses within 1e-3, points within 1e-2, the same bad
  associations;
- the dispatching `ba_solve` (solver="auto") at 128 vertex slots routes to
  the point-major solver in both packages, with the same tolerances; on the
  skewed graph at 128 keyframes the dropped observations get the exact chi2
  at the solution, and every chi2 lands at its source index;
- bench.py's 128-keyframe problem: the histories agree to 1e-4 for the first
  linearization's six steps and part after it (a monocular problem with one
  fixed camera leaves the scale free, and lam has fallen to ~1e-6 there, so
  the PCG step along that direction is float noise; the reference's own
  dense, CG and point-major routes part there too); the final costs within
  1%;
- marker problems: `build_pm_problem` returns None, and `ba_solve` routes
  them to the dense solve below 512 vertex slots and to CG from 512;
- the CG branch of `ba_solve` against the reference's CG at
  tests/test_ba.py:329-348's sizes, and against the port's dense solve, at
  that test's tolerances (poses within 2e-3, points within 2e-2), the same
  outliers flagged;
- `global_bundle_adjustment` on the 128-keyframe drifted ring map
  (`chip_smoke.ring_loop_scene(n_kf=128)`; 15 LM steps a stage, as
  chip_smoke's ring BA): both packages take the point-major route; the chi2
  falls under a tenth of the drifted map's;
  the port's final chi2 within 1.2x of the reference's and its keyframe poses
  within the reference's own spread between its routes on that map
  (`data/torch_port/ba128_jax.json`, at globalOptimization's 100 steps: a
  weakly conditioned chain, on which the reference's dense and CG solves
  end 0.14-0.15 from its point-major one; after 15 steps 0.11-0.15).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
import tests.test_ba as ba_tests
import tests.test_torch_loop as loop_tests
from tests.test_ba import CAM as REF_CAM
from ucoslam_tpu.config import Params
from ucoslam_tpu.geometry.camera import CameraParams as RefCamera
from ucoslam_tpu.optim import ba as ref_ba
from ucoslam_tpu.optim import schur_pm as ref_pm
from ucoslam_tpu_torch.config import Params as PortParams
from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.optim import ba, schur_pm
from ucoslam_tpu_torch.optim.ba import BAProblem, _build_cam_obs

torch.set_num_threads(2)

FIELDS = ("cam_pose", "cam_fixed", "cam_valid", "pt_pos", "pt_valid", "obs_cam", "obs_pt", "obs_uv", "obs_sigma2",
          "obs_depth", "obs_valid", "pt_obs")
TABLES = ("o_cam", "o_src", "o_valid", "o_uv", "o_sigma2", "o_depth", "cam_obs", "pair_m1", "pair_m2", "vp_pair",
          "vp_other", "vp_trans")
CAM = CameraParams.create(float(REF_CAM.fx), float(REF_CAM.fy), float(REF_CAM.cx), float(REF_CAM.cy))
BENCH_CAM, REF_BENCH_CAM = CameraParams.create(*chip_smoke.BA_CAMERA), RefCamera.create(*chip_smoke.BA_CAMERA)


def both(arrays: dict, bf: float):
    """The same numpy problem in both packages (with its cam_obs table)."""
    cam_obs = _build_cam_obs(arrays["obs_cam"], arrays["cam_pose"].shape[0])
    ref = ref_ba.BAProblem(**{k: jnp.asarray(v) for k, v in arrays.items()}, bf=jnp.float32(bf),
                           cam_obs=jnp.asarray(cam_obs))

    def t(a):
        a = np.array(a)
        return torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a)

    port = BAProblem(**{k: t(v) for k, v in arrays.items()}, bf=bf, cam_obs=t(cam_obs))
    return ref, port


def from_test_ba(**kw):
    """tests/test_ba.py's make_problem(**kw), its generator seeded as that
    module seeds it (so the problem does not depend on the tests run before)."""
    ba_tests.RNG = np.random.default_rng(51)
    rp, _, _ = ba_tests.make_problem(**kw)
    return both({k: np.asarray(getattr(rp, k)) for k in FIELDS}, float(rp.bf))


def skewed(n_kf: int):
    """tests/test_ba.py's skewed graph: 8% of the observations of bench.py's
    problem (1024 points x 6) moved onto 30 points."""
    a = chip_smoke.ba_scale_problem(n_kf, 1024, 6)
    rng = np.random.default_rng(0)
    obs_pt = a["obs_pt"].copy()
    hyper = rng.choice(1024, 30, replace=False)
    m = rng.random(len(obs_pt)) < 0.08
    obs_pt[m] = rng.choice(hyper, int(m.sum()))
    a["obs_pt"] = obs_pt
    return both(a, chip_smoke.BA_BF)


def assert_tables_equal(ref_problem, port_problem):
    r, p = ref_pm.build_pm_problem(ref_problem), schur_pm.build_pm_problem(port_problem)
    assert r is not None and p is not None
    for name in TABLES:
        assert np.array_equal(np.asarray(getattr(r, name)), getattr(p, name).numpy()), name
    assert r.dropped_obs == p.dropped_obs
    return r, p


def test_tables_equal_reference():
    assert_tables_equal(*both(chip_smoke.ba_scale_problem(128, 1024, 4), chip_smoke.BA_BF))
    r, _ = assert_tables_equal(*skewed(16))
    assert r.dropped_obs > 0


def assert_close(ref_out, port_out, what, pose_tol=1e-3, pt_tol=1e-2):
    """(cam_pose, pt_pos, costs) of both packages: every step within 1e-4
    relative, the final cost within 1%, poses within pose_tol, points within
    pt_tol."""
    (rc, rp, rcost), (pc, pp, pcost) = ref_out, port_out
    rcost, pcost = np.asarray(rcost), pcost.numpy()
    assert (np.abs(rcost - pcost) <= 1e-4 * rcost).all(), f"{what}: histories part: {rcost} vs {pcost}"
    assert abs(rcost[-1] - pcost[-1]) <= 0.01 * rcost[-1], what
    assert pcost[-1] < pcost[0], what
    assert np.abs(np.asarray(rc) - pc.numpy()).max() < pose_tol, what
    assert np.abs(np.asarray(rp) - pp.numpy()).max() < pt_tol, what


@pytest.mark.parametrize("kw", [dict(n_kf=8, n_pt=200, depth_frac=0.3), dict(n_kf=8, n_pt=200, pose_noise=0.03),
                                dict(n_kf=6, n_pt=150, depth_frac=0.4, outlier_frac=0.05)],
                         ids=["stereo", "mono", "outliers"])
def test_pm_staged_lm_equals_reference(kw):
    ref_problem, port_problem = from_test_ba(**kw)
    r = ref_pm.pm_staged_lm(ref_pm.build_pm_problem(ref_problem), REF_CAM, iters=12, stages=2)
    p = schur_pm.pm_staged_lm(schur_pm.build_pm_problem(port_problem), CAM, iters=12, stages=2)
    assert_close(r[:3], p[:3], str(kw))
    assert np.array_equal(np.asarray(r[4]), p[4].numpy())


@pytest.fixture
def pm_calls(monkeypatch):
    calls = []
    inner = schur_pm.pm_staged_lm
    monkeypatch.setattr(schur_pm, "pm_staged_lm", lambda *a, **k: calls.append(1) or inner(*a, **k))
    return calls


def test_ba_solve_routes_to_point_major(pm_calls):
    ref_problem, port_problem = from_test_ba(n_kf=128, n_pt=64, depth_frac=0.3)
    assert ref_pm.pm_problem_for(ref_problem) is not None
    r = ref_ba.ba_solve(ref_problem, REF_CAM, iters=12, stages=2)
    p = ba.ba_solve(port_problem, CAM, iters=12, stages=2)
    assert pm_calls == [1]
    assert_close((r.cam_pose, r.pt_pos, r.cost_history), (p.cam_pose, p.pt_pos, p.cost_history), "V=128")
    assert np.array_equal(np.asarray(r.obs_bad), p.obs_bad.numpy())
    np.testing.assert_allclose(p.obs_chi2.numpy(), np.asarray(r.obs_chi2), rtol=1e-3, atol=1e-3)


def test_bench_problem_parts_after_first_linearization(pm_calls):
    ref_problem, port_problem = both(chip_smoke.ba_scale_problem(128, 1024, 4), chip_smoke.BA_BF)
    r = np.asarray(ref_ba.ba_solve(ref_problem, REF_BENCH_CAM, iters=24, stages=1).cost_history)
    p = ba.ba_solve(port_problem, BENCH_CAM, iters=24, stages=1).cost_history.numpy()
    assert pm_calls == [1]
    assert np.abs(r[:6] - p[:6]).max() <= 1e-4 * r[5]
    assert abs(r[-1] - p[-1]) <= 0.01 * r[-1] and p[-1] < p[0]


def test_dropped_observations_get_exact_chi2(pm_calls):
    ref_problem, port_problem = skewed(128)
    pm = schur_pm.pm_problem_for(port_problem)
    assert pm is not None and pm.dropped_obs > 0
    p = ba.ba_solve(port_problem, BENCH_CAM, iters=4, stages=1)
    assert pm_calls == [1]
    direct, q = ba._chi2_of(port_problem, p.cam_pose, p.pt_pos, BENCH_CAM)
    assert torch.equal(p.obs_chi2, direct)  # every chi2 at its source index, the dropped ones exact
    bad = port_problem.obs_valid & ((direct > ba._delta2(port_problem)) | (q[:, 2] <= 0))
    assert torch.equal(p.obs_bad, bad)
    r = ref_ba.ba_solve(ref_problem, REF_BENCH_CAM, iters=4, stages=1)
    assert abs(float(r.cost_history[-1]) - float(p.cost_history[-1])) <= 0.01 * float(r.cost_history[-1])


def with_marker(problem: BAProblem, K_extra: int = 0) -> BAProblem:
    """problem with one marker vertex (and K_extra more invalid cameras)."""
    import dataclasses

    if K_extra:
        pad = lambda x, v: torch.cat([x, x.new_full((K_extra,) + x.shape[1:], v)])
        problem = dataclasses.replace(
            problem, cam_pose=torch.cat([problem.cam_pose, torch.eye(4).expand(K_extra, 4, 4)]),
            cam_fixed=pad(problem.cam_fixed, True), cam_valid=pad(problem.cam_valid, False),
            cam_obs=pad(problem.cam_obs, -1))
    return dataclasses.replace(
        problem, mk_pose=torch.eye(4)[None], mk_fixed=torch.zeros(1, dtype=torch.bool),
        mk_valid=torch.ones(1, dtype=torch.bool), mk_obj=torch.zeros(1, 4, 3), mobs_cam=torch.zeros(1, dtype=torch.int64),
        mobs_mk=torch.zeros(1, dtype=torch.int64), mobs_uv=torch.zeros(1, 4, 2), mobs_w=torch.ones(1),
        mobs_valid=torch.ones(1, dtype=torch.bool))


def test_marker_problems_take_the_general_path(monkeypatch):
    _, port_problem = both(chip_smoke.ba_scale_problem(128, 256, 4), chip_smoke.BA_BF)
    assert schur_pm.build_pm_problem(with_marker(port_problem)) is None
    assert schur_pm.pm_problem_for(with_marker(port_problem)) is None
    routes = []
    monkeypatch.setattr(schur_pm, "pm_staged_lm", lambda *a, **k: pytest.fail("a marker problem took point-major"))
    monkeypatch.setattr(ba, "_staged_lm", lambda problem, cam, iters, stages, use_cg, cg_iters: routes.append(use_cg)
                        or (problem.cam_pose, problem.mk_pose, problem.pt_pos, torch.zeros(1), None, None))
    ba.ba_solve(with_marker(port_problem), BENCH_CAM)  # V = 129: dense
    ba.ba_solve(with_marker(port_problem, K_extra=384), BENCH_CAM)  # V = 513: CG
    ba.ba_solve(port_problem, BENCH_CAM, solver="cg")  # an explicit request
    ba.ba_solve(port_problem, BENCH_CAM, solver="dense")
    assert routes == [False, True, True, False]


@pytest.mark.parametrize("kw,stages,cg_iters", [(dict(n_kf=8, n_pt=200, pose_noise=0.03), 1, 40),
                                                (dict(n_kf=6, n_pt=150, depth_frac=0.4, outlier_frac=0.05), 2, 32)],
                         ids=["clean", "stereo_outliers"])
def test_cg_equals_reference(kw, stages, cg_iters):
    ref_problem, port_problem = from_test_ba(**kw)
    r = ref_ba.ba_solve(ref_problem, REF_CAM, iters=12 if stages == 1 else 15, stages=stages, solver="cg",
                        cg_iters=cg_iters)
    p = ba.ba_solve(port_problem, CAM, iters=12 if stages == 1 else 15, stages=stages, solver="cg", cg_iters=cg_iters)
    assert_close((r.cam_pose, r.pt_pos, r.cost_history), (p.cam_pose, p.pt_pos, p.cost_history), "cg", 2e-3, 2e-2)
    assert np.array_equal(np.asarray(r.obs_bad), p.obs_bad.numpy())
    if stages == 2:
        assert p.obs_bad.any()  # the outliers flagged
    d = ba.ba_solve(port_problem, CAM, iters=12 if stages == 1 else 15, stages=stages, solver="dense")
    assert (d.cam_pose - p.cam_pose).abs().max() < 2e-3
    assert (d.pt_pos - p.pt_pos).abs().max() < 2e-2


def test_global_ba_on_128_keyframe_ring(monkeypatch, pm_calls):
    params = Params().replace(maxDescDistance=60.0, detectMarkers=False, KFMinConfidence=0.4)
    monkeypatch.setattr(loop_tests, "PARAMS", params)
    scene = chip_smoke.ring_loop_scene(n_kf=128)
    m_ref, _, _, _, cam_ref = loop_tests.ref_ring_map(scene)
    m, det, _, _ = chip_smoke.ring_loop_map(scene, PortParams.from_dict(params.to_dict()), "cpu")
    chi_before = m.global_reproj_chi2(det.cam)
    problem, _, _, _ = ref_ba.build_ba_problem(m_ref, cam_ref)
    assert problem.cam_pose.shape[0] >= 128 and ref_pm.pm_problem_for(problem) is not None
    # the reference's own spread: its dense and CG solves of this map against
    # its point-major one (tools/port/ba_reference.py)
    with open(os.path.join(os.path.dirname(chip_smoke.__file__), "data", "torch_port", "ba128_jax.json")) as f:
        ring = json.load(f)["ring128"]["pose"]
    spread = min(ring["dense_auto"], ring["cg_auto"])
    ref_ba.global_bundle_adjustment(m_ref, cam_ref, n_iters=15)
    ba.global_bundle_adjustment(m, det.cam, n_iters=15)
    assert pm_calls == [1]
    chi_ref, chi = m_ref.global_reproj_chi2(cam_ref), m.global_reproj_chi2(det.cam)
    assert chi < 0.1 * chi_before and chi <= 1.2 * chi_ref, (chi_before, chi, chi_ref)
    slots = m.keyframes.active_slots()
    d = np.abs(m.h("kf_pose")[slots] - np.asarray(m_ref.state.kf_pose)[slots]).max()
    assert d <= spread, (d, spread)


def test_ba_gap_is_blind_to_the_gauge():
    """chip_smoke.ba_gap, which phase 11 holds the port's BA to the JAX
    package's with, reads zero between a solution and the same one moved by
    a similarity that keeps the rotations (the free scale and translation of
    a problem with one fixed camera), and reads a moved point."""
    arrays = chip_smoke.ba_scale_problem(128, 1024, 4)
    pose, pts = arrays["cam_pose"].astype(np.float64), arrays["pt_pos"].astype(np.float64)
    s, t = 1.3, np.array([0.4, -0.2, 0.7])
    moved = pose.copy()
    moved[:, :3, 3] = s * pose[:, :3, 3] - np.einsum("kij,j->ki", pose[:, :3, :3], t)
    gap = chip_smoke.ba_gap((moved.astype(np.float32), (s * pts + t).astype(np.float32)), (pose, pts), arrays)
    assert gap["reprojection_p99"] < 1e-3 and gap["point_p99"] < 1e-5 and gap["rotation"] == 0, gap
    off = pts.copy()
    off[:20, 0] += 0.5  # across the cameras' rays
    gap = chip_smoke.ba_gap((pose, off), (pose, pts), arrays)
    assert gap["point_p99"] > 0.01 and gap["reprojection_p99"] > 1.0, gap
    spread = {"a_b": dict(gap), "c_b": {k: v / 2 for k, v in gap.items()}}
    assert chip_smoke.ba_gap_failures(gap, spread) == []
    assert chip_smoke.ba_gap_failures({k: 2.5 * v for k, v in gap.items()}, spread) == ["reprojection_p99", "point_p50",
                                                                                      "point_p99"]
