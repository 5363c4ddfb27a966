"""The port's bundle adjustment and keyframe insertion against the
reference's, on a map the reference built: a short JAX SLAM run over
oracle frames, carried across as numpy arrays. build_ba_problem gives the
same observation tables; the dense ba_solve (from perturbed poses and
points) gives poses and points within 1e-4 relative and the same bad
associations; global_bundle_adjustment over the whole map (directly and
through UcoSlam.globalOptimization) gives the global reprojection chi2
within 1%; one MapManager.new_keyframe gives the
same keyframe slot and the same map-point count.

With marker vertices, on tests/test_ba.py's marker map (two markers seen by
six keyframes, their poses perturbed): build_ba_problem gives the same
marker vertices, corner edges and weights (and planar edges with
inPlaneMarkers); the dense ba_solve gives keyframe poses within 1e-4,
points within 1e-4 relative and the cost history within 1e-4 relative of
the reference's, and marker poses within 1e-3 (a marker vertex's tilt is
weakly observed: with the costs in step, float32 sums in another order
parted the two packages' marker poses by 1.6e-4 over the 20 LM steps); the
global BA
meets the reference test's gates (corner error down 5x, the planar prior
flattening the tilted marker); a fixed marker vertex is not written back."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucoslam_tpu.api import UcoSlam as RefSlam
from ucoslam_tpu.config import Params
from ucoslam_tpu.io import SyntheticSequence as RefSequence
from ucoslam_tpu.mapping.map import Map as RefMap
from ucoslam_tpu.optim import ba as ref_ba
from ucoslam_tpu.slam import System as RefSystem
from ucoslam_tpu_torch.api import UcoSlam
from ucoslam_tpu_torch.config import Params as PortParams
from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.mapping.frame import frame_from_numpy
from ucoslam_tpu_torch.mapping.map import Map, map_state_from_numpy
from ucoslam_tpu_torch.optim import ba
from ucoslam_tpu_torch.slam.mapmanager import MapManager

torch.set_num_threads(2)

PARAMS = Params().replace(
    maxMapPoints=4096, maxKeyFrames=32, maxKeyPointsPerFrame=512, maxDescDistance=60.0, detectMarkers=False,
)
PORT_PARAMS = PortParams.from_dict(PARAMS.to_dict())


@pytest.fixture(scope="module")
def run():
    """The reference's SLAM over 14 oracle frames, and its track of frame 14."""
    seq = RefSequence(n_frames=40, seed=1)
    sys_ = RefSystem(PARAMS, seq.cam)
    for i in range(14):
        sys_.process_frame(seq.frame(i))
    frame = seq.frame(14)
    res = sys_.tracker.track(sys_.map, frame, sys_._prior())
    assert res.ok and sys_.map.n_keyframes >= 3
    return seq, sys_, res


def _carry(ref_map):
    """The reference map as the port's (a copy), and a reference copy."""
    st = ref_map.state
    port = Map(PORT_PARAMS, map_state_from_numpy({k: np.asarray(v) for k, v in st._asdict().items()}, "cpu"))
    copy = RefMap(ref_map.params)
    copy.state = st
    for m in (port, copy):
        m.points.sync_from_mask(ref_map.points.active)
        m.keyframes.sync_from_mask(ref_map.keyframes.active)
    return port, copy


def _cam(seq):
    c = seq.cam
    return CameraParams.create(float(c.fx), float(c.fy), float(c.cx), float(c.cy), bl=float(c.bl))


def _problems(run):
    """All keyframes, the two oldest held fixed (which also fixes the
    mono scale, so the solution is unique)."""
    seq, sys_, _ = run
    port_map, _ = _carry(sys_.map)
    fixed = sys_.map.keyframes.active_slots()[:2]
    want = ref_ba.build_ba_problem(sys_.map, seq.cam, fixed_kfs=fixed)
    got = ba.build_ba_problem(port_map, _cam(seq), fixed_kfs=fixed)
    return want, got


def test_build_ba_problem_equals_reference(run):
    (rp, r_kf, r_pt, _), (pp, p_kf, p_pt, p_mk) = _problems(run)
    assert len(p_mk) == 0 and pp.mk_pose is None
    np.testing.assert_array_equal(p_kf, r_kf)
    np.testing.assert_array_equal(p_pt, r_pt)
    O, Pn = pp.obs_cam.shape[0], len(p_pt)
    assert O > 500 and int(np.asarray(rp.obs_valid).sum()) == O
    for k in ("obs_cam", "obs_pt", "obs_uv", "obs_sigma2", "obs_depth"):
        np.testing.assert_array_equal(getattr(pp, k).numpy(), np.asarray(getattr(rp, k))[:O], err_msg=k)
    np.testing.assert_array_equal(pp.pt_obs.numpy(), np.asarray(rp.pt_obs)[:Pn])
    np.testing.assert_array_equal(pp.pt_pos.numpy(), np.asarray(rp.pt_pos)[:Pn])
    np.testing.assert_array_equal(pp.cam_obs.numpy(), np.asarray(rp.cam_obs))
    for k in ("cam_pose", "cam_fixed", "cam_valid"):
        np.testing.assert_array_equal(getattr(pp, k).numpy(), np.asarray(getattr(rp, k)), err_msg=k)
    assert pp.bf == float(rp.bf)


def test_ba_solve_dense_equals_reference(run):
    (rp, _, _, _), (pp, _, p_pt, _) = _problems(run)
    rng = np.random.default_rng(0)
    Pn, K = len(p_pt), pp.cam_pose.shape[0]
    # start both from the same perturbed estimate: points by ~2%, free cameras by ~1 cm
    dp = (rng.normal(0, 0.02, (Pn, 3)) * np.abs(pp.pt_pos.numpy())).astype(np.float32)
    dt = np.where((pp.cam_valid & ~pp.cam_fixed).numpy()[:, None], rng.normal(0, 0.01, (K, 3)), 0.0)
    cam_pose = pp.cam_pose.numpy().copy()
    cam_pose[:, :3, 3] += dt.astype(np.float32)
    pt_pos = pp.pt_pos.numpy() + dp
    pp.cam_pose, pp.pt_pos = torch.from_numpy(cam_pose), torch.from_numpy(pt_pos)
    rp_pt = np.asarray(rp.pt_pos).copy()
    rp_pt[:Pn] = pt_pos
    rp = rp._replace(cam_pose=jnp.asarray(cam_pose), pt_pos=jnp.asarray(rp_pt))

    want = ref_ba.ba_solve(rp, run[0].cam, iters=10, stages=2)
    got = ba.ba_solve(pp, _cam(run[0]), iters=10, stages=2)
    O = pp.obs_cam.shape[0]
    w_cam, w_pt = np.asarray(want.cam_pose), np.asarray(want.pt_pos)[:Pn]
    assert np.abs(got.cam_pose.numpy() - w_cam).max() <= 1e-4 * np.abs(w_cam).max()
    assert np.abs(got.pt_pos.numpy() - w_pt).max() <= 1e-4 * np.abs(w_pt).max()
    np.testing.assert_array_equal(got.obs_bad.numpy(), np.asarray(want.obs_bad)[:O])
    # the LM did real work: the points moved well past the tolerance
    assert np.abs(w_pt - pt_pos).max() > 100 * 1e-4 * np.abs(w_pt).max()
    np.testing.assert_allclose(got.cost_history.numpy(), np.asarray(want.cost_history), rtol=1e-3)


@pytest.mark.parametrize("via", ["function", "facade"])
def test_global_bundle_adjustment_equals_reference(run, via):
    """global_bundle_adjustment, called directly or through
    UcoSlam.globalOptimization (as tests/test_api.py uses it)."""
    seq, sys_, _ = run
    port_map, ref_copy = _carry(sys_.map)
    cam = _cam(seq)
    # both from the same perturbed map: points by ~2%, keyframes but the first by ~1 cm
    rng = np.random.default_rng(1)
    st = ref_copy.state
    pt_pos = np.asarray(st.pt_pos) * (1 + rng.normal(0, 0.02, (st.P, 1))).astype(np.float32)
    kf_pose = np.asarray(st.kf_pose).copy()
    kfs = ref_copy.keyframes.active_slots()[1:]
    kf_pose[kfs, :3, 3] += rng.normal(0, 0.01, (len(kfs), 3)).astype(np.float32)
    ref_copy.state = st._replace(pt_pos=jnp.asarray(pt_pos), kf_pose=jnp.asarray(kf_pose))
    port_map.state = port_map.state.replace(pt_pos=torch.from_numpy(pt_pos), kf_pose=torch.from_numpy(kf_pose))
    chi_before = port_map.global_reproj_chi2(cam)
    assert abs(chi_before - ref_copy.global_reproj_chi2(seq.cam)) <= 1e-4 * chi_before
    if via == "function":
        ref_ba.global_bundle_adjustment(ref_copy, seq.cam, n_iters=10)
        ba.global_bundle_adjustment(port_map, cam, n_iters=10)
    else:
        ref_slam, slam = RefSlam(), UcoSlam(device="cpu")
        ref_slam.setParams(ref_copy, PARAMS, seq.cam)
        slam.setParams(port_map, PORT_PARAMS, cam)
        ref_slam.globalOptimization(n_iters=10)
        slam.globalOptimization(n_iters=10)
    chi_ref, chi = ref_copy.global_reproj_chi2(seq.cam), port_map.global_reproj_chi2(cam)
    assert chi < 0.5 * chi_before
    assert abs(chi - chi_ref) <= 0.01 * chi_ref, (chi, chi_ref)


def test_new_keyframe_equals_reference(run):
    seq, sys_, res = run
    port_map, ref_copy = _carry(sys_.map)
    mgr = MapManager(PORT_PARAMS, _cam(seq), device="cpu")
    mgr.kf_counter = sys_.manager.kf_counter
    st = port_map.state
    for s in port_map.keyframes.active_slots():
        mgr.kfdb.add(int(s), st.kf_desc[int(s)], st.kf_kpt_valid[int(s)])
    frame = frame_from_numpy({k: np.asarray(v) for k, v in res.frame._asdict().items() if k != "markers"}, "cpu")
    n_before = port_map.n_points

    want = sys_.manager.new_keyframe(ref_copy, res.frame, host_ids=res.host_ids,
                                     host_depth=res.host_depth, host_valid=res.host_valid)
    got = mgr.new_keyframe(port_map, frame, host_ids=res.host_ids, host_depth=res.host_depth,
                           host_valid=res.host_valid)
    assert got == want
    assert port_map.n_points == ref_copy.n_points and port_map.n_points > n_before
    assert port_map.n_keyframes == ref_copy.n_keyframes
    assert mgr.n_insertions == 1 and mgr.loop_detector.n_queries == 1
    port_map.check_consistency()


# ---- marker vertices: tests/test_ba.py's marker map -----------------------

MARKER_FIELDS = ("mk_pose", "mk_fixed", "mk_valid", "mk_obj", "mobs_cam", "mobs_mk", "mobs_uv", "mobs_w", "mobs_valid")
PLANAR_FIELDS = ("plan_ref", "plan_other", "plan_w", "plan_valid")
MARKER_CAM = CameraParams.create(500.0, 500.0, 320.0, 240.0)


def _marker_maps(in_plane, tilt=0.0):
    from tests.test_ba import build_marker_map

    ref_map, mk_true, obj, _ = build_marker_map(in_plane=in_plane, tilt=tilt)
    port = Map(PortParams.from_dict(ref_map.params.to_dict()),
               map_state_from_numpy({k: np.asarray(v) for k, v in ref_map.state._asdict().items()}, "cpu"))
    port.points.sync_from_mask(ref_map.points.active)
    port.keyframes.sync_from_mask(ref_map.keyframes.active)
    return ref_map, port, mk_true, obj


@pytest.mark.parametrize("in_plane", [False, True])
def test_marker_ba_problem_and_solve_equal_reference(in_plane):
    from tests.test_ba import CAM as REF_CAM

    ref_map, port, _, _ = _marker_maps(in_plane, tilt=0.12 if in_plane else 0.0)
    rp, r_kf, r_pt, r_mk = ref_ba.build_ba_problem(ref_map, REF_CAM)
    pp, p_kf, p_pt, p_mk = ba.build_ba_problem(port, MARKER_CAM)
    np.testing.assert_array_equal(p_mk, r_mk)
    assert len(p_mk) == 2
    for k in MARKER_FIELDS + (PLANAR_FIELDS if in_plane else ()):
        np.testing.assert_array_equal(getattr(pp, k).numpy(), np.asarray(getattr(rp, k)), err_msg=k)
    assert (pp.plan_ref is None) == (not in_plane) == (rp.plan_ref is None)
    want = ref_ba.ba_solve(rp, REF_CAM, iters=10, stages=2)
    got = ba.ba_solve(pp, MARKER_CAM, iters=10, stages=2)
    Pn = len(p_pt)
    assert np.abs(got.cam_pose.numpy() - np.asarray(want.cam_pose)).max() < 1e-4
    assert np.abs(got.mk_pose.numpy() - np.asarray(want.mk_pose)).max() < 1e-3
    np.testing.assert_allclose(got.cost_history.numpy(), np.asarray(want.cost_history), rtol=1e-4)
    w_pt = np.asarray(want.pt_pos)[:Pn]
    assert np.abs(got.pt_pos.numpy() - w_pt).max() <= 1e-4 * np.abs(w_pt).max()
    assert np.abs(got.mk_pose.numpy() - pp.mk_pose.numpy()).max() > 1e-3  # the markers moved


def test_marker_global_ba_gates():
    """tests/test_ba.py::TestMarkerVertices' gates on the port."""
    _, port, mk_true, obj = _marker_maps(False)

    def corner_err(m):
        mk = m.h("mk_pose")[:2]
        return float(np.mean([np.linalg.norm((obj @ mk[i][:3, :3].T + mk[i][:3, 3])
                                             - (obj @ mk_true[i][:3, :3].T + mk_true[i][:3, 3]), axis=-1).mean()
                              for i in range(2)]))

    err0 = corner_err(port)
    ba.global_bundle_adjustment(port, MARKER_CAM, n_iters=25)
    err1 = corner_err(port)
    assert err0 > 0.005 and err1 < 0.2 * err0 and err1 < 0.01, (err0, err1)
    _, flat, _, _ = _marker_maps(True, tilt=0.12)
    ba.global_bundle_adjustment(flat, MARKER_CAM, n_iters=25)
    mk = flat.h("mk_pose")[:2]
    assert float(np.arccos(np.clip((np.linalg.inv(mk[0]) @ mk[1])[2, 2], -1, 1))) < 0.06


def test_marker_pose_written_back_only_when_free():
    _, port, _, _ = _marker_maps(False)
    before = port.h("mk_pose")[:2].copy()
    problem, kf_slots, pt_slots, mk_slots = ba.build_ba_problem(port, MARKER_CAM)
    problem.mk_fixed = problem.mk_fixed.clone()
    problem.mk_fixed[0] = True  # marker 0 held fixed, marker 1 free
    result = ba.ba_solve(problem, MARKER_CAM, iters=10, stages=2)
    ba.apply_ba_result(port, result, kf_slots, pt_slots, problem, mk_slots=mk_slots)
    after = port.h("mk_pose")[:2]
    np.testing.assert_array_equal(after[0], before[0])
    assert np.abs(after[1] - before[1]).max() > 1e-3
