"""The port's depth SLAM path (stereo / RGB-D) against the JAX package, on the
same seeded inputs:

- the counterpart of tests/test_slam_e2e.py::TestRGBD (oracle RGB-D frames:
  >= 90% tracked, ATE without scale alignment < 0.05) in both packages: the
  same frames tracked, the port's ATE within 1.2x + 0.002 of the reference's;
  and of tests/test_stereo.py's metric stereo SLAM (oracle stereo frames),
  with the same gates;
- `initialize_from_depth` on one oracle frame and one rendered RGB-D frame:
  the same points within 1e-5, the same flags, descriptors and keyframe ids,
  min/max distances within 1e-5 relative;
- `System._try_initialize` on a depth frame: on success the metric lock,
  the identity pose, kf_counter 1, the running inlier count and the
  keyframe-database entry, as the reference; with fewer than 100 depths
  None, and no two-view attempt, as the reference;
- direct depth points at a keyframe (`_create_stereo_points`) on the
  reference's RGB-D map and a frame it tracked, with a 6 m close-depth cut
  (bl 0.15) and a 50-point cap by response that both bind: the same
  keypoints chosen,
  points, normals and distance bounds within 1e-5, the same descriptors,
  flags and observations;
- a loop correction on a map with depth keeps the scale: the mapper asks
  `correct_map` for `fix_scale` exactly when a keyframe carries depth, as
  the reference's, and the fixed-scale pose graph on the scale-drift ring
  of tests/test_posegraph.py gives the reference's poses within 1e-4;
- local BA on the reference's RGB-D map: the same observation tables with
  their depths and `bf`, and the dense solve from perturbed poses and
  points (stereo edges gated at CHI2_3D) within 1e-4 relative of the
  reference's, with the same bad associations;
- the keyframe rule with a baseline (the stereo clause: tracked close points
  < 100 and creatable ones > 70, and thRefRatio capped at 0.75) on the
  TrackResults of the port's RGB-D run, as recorded and with most tracked
  keypoints untracked: the reference decides alike on every one, over a
  grid of the rule's state.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucoslam_tpu.config import Params as RefParams
from ucoslam_tpu.features.frame_extractor import FrameExtractor as RefExtractor
from ucoslam_tpu.geometry.horn import ate_rmse
from ucoslam_tpu.io.synthetic import SyntheticSequence as RefSequence
from ucoslam_tpu.mapping.map import Map as RefMap
from ucoslam_tpu.slam import System as RefSystem
from ucoslam_tpu.optim import ba as ref_ba
from ucoslam_tpu.optim.posegraph import pose_graph_solve as ref_pose_graph_solve
from ucoslam_tpu.slam.initializer import MapInitializer as RefInitializer
from ucoslam_tpu.slam.mapmanager import MapManager as RefMapManager
from ucoslam_tpu.slam.tracker import TrackResult as RefTrackResult
from ucoslam_tpu_torch.config import Params, TrackingState
from ucoslam_tpu_torch.io.synthetic import SyntheticSequence
from ucoslam_tpu_torch.mapping.frame import frame_from_numpy
from ucoslam_tpu_torch.mapping.map import Map
from ucoslam_tpu_torch.optim import ba, posegraph
from ucoslam_tpu_torch.slam.initializer import MapInitializer
from ucoslam_tpu_torch.slam.mapmanager import MapManager
from tests.test_posegraph import ring_problem
from tests.test_torch_ba import _cam, _carry
from ucoslam_tpu_torch.slam.system import System

torch.set_num_threads(2)

# tests/test_slam_e2e.py's parameters
PARAMS = Params().replace(maxMapPoints=4096, maxKeyFrames=32, maxKeyPointsPerFrame=512, maxDescDistance=60.0,
                          ransacIters=256)
REF_PARAMS = RefParams.from_dict(PARAMS.to_dict())
RGBD_SCENE = dict(n_frames=30, seed=5, depth_mode="rgbd")


def _port_frame(f):
    return frame_from_numpy({k: np.asarray(v) for k, v in f._asdict().items() if k != "markers"}, "cpu")


def _centres(poses):
    idx = sorted(poses)
    return idx, np.stack([-poses[i][:3, :3].T @ poses[i][:3, 3] for i in idx])


def _run(system, frames, n):
    poses = {}
    for i in range(n):
        p = system.process_frame(frames(i))
        if p is not None:
            poses[i] = np.asarray(p)
    return poses


@pytest.fixture(scope="module")
def rgbd_runs():
    """Both packages over the oracle RGB-D sequence; the port's TrackResults
    with the rule's state before each decision."""
    seq, ref_seq = SyntheticSequence(**RGBD_SCENE), RefSequence(**RGBD_SCENE)
    port = System(PARAMS, seq.cam, device="cpu")
    recorded = []
    decide = port._need_keyframe

    def recording(res):
        recorded.append((res, port.frames_since_kf, port.last_kf_inliers, port.pose.copy(),
                         port._last_kf_rot.copy()))
        return decide(res)

    port._need_keyframe = recording
    ref = RefSystem(REF_PARAMS, ref_seq.cam)
    return dict(seq=seq, ref_seq=ref_seq, port=port, ref=ref, recorded=recorded,
                port_poses=_run(port, lambda i: seq.frame(i, device="cpu"), seq.n_frames),
                ref_poses=_run(ref, ref_seq.frame, seq.n_frames))


def test_rgbd_tracks_with_true_scale(rgbd_runs):
    seq = rgbd_runs["seq"]
    ates = []
    for system, poses in ((rgbd_runs["port"], rgbd_runs["port_poses"]), (rgbd_runs["ref"], rgbd_runs["ref_poses"])):
        assert min(poses) == 0 and system.manager.metric_locked  # the depth init at frame 0
        assert len(poses) >= 0.9 * (seq.n_frames - 1)
        idx, est = _centres(poses)
        ates.append(ate_rmse(est, seq.gt_positions()[idx], with_scale=False))
        assert ates[-1] < 0.05, f"metric ATE {ates[-1]}"
    assert sorted(rgbd_runs["port_poses"]) == sorted(rgbd_runs["ref_poses"])
    assert ates[0] <= 1.2 * ates[1] + 0.002, ates


def test_stereo_slam_metric_scale():
    """Counterpart of tests/test_stereo.py's metric stereo SLAM (oracle
    stereo frames, 8 octaves)."""
    scene = dict(n_frames=25, seed=33, depth_mode="stereo")
    seq, ref_seq = SyntheticSequence(**scene), RefSequence(**scene)
    port = System(PARAMS.replace(nOctaveLevels=8), seq.cam, device="cpu")
    ref = RefSystem(REF_PARAMS.replace(nOctaveLevels=8), ref_seq.cam)
    runs = []
    for system, frames in ((port, lambda i: seq.frame(i, device="cpu")), (ref, ref_seq.frame)):
        poses = _run(system, frames, seq.n_frames)
        assert min(poses) == 0 and system.manager.metric_locked
        assert len(poses) >= 0.9 * (seq.n_frames - 1)
        idx, est = _centres(poses)
        ate = ate_rmse(est, seq.gt_positions()[idx], with_scale=False)
        assert ate < 0.05, f"stereo metric ATE {ate}"
        runs.append((idx, ate))
    (port_frames, port_ate), (ref_frames, ref_ate) = runs
    assert port_frames == ref_frames
    assert port_ate <= 1.2 * ref_ate + 0.002, (port_ate, ref_ate)


@pytest.mark.parametrize("source", ["oracle", "rendered"])
def test_initialize_from_depth_matches_reference(source):
    ref_seq = RefSequence(**RGBD_SCENE)
    if source == "oracle":
        ref_frame = ref_seq.frame(0)
    else:  # the reference's RGB-D frontend on a render and its z-buffer
        img, z = ref_seq.render_with_depth(0)
        ext = RefExtractor(REF_PARAMS.replace(nOctaveLevels=4), ref_seq.cam)
        ref_frame = ext.process_rgbd(img, np.clip(z * 5000.0, 0, 65535).astype(np.uint16), 0)
    ref_map, port_map = RefMap(REF_PARAMS), Map(PARAMS, device="cpu")
    assert RefInitializer(REF_PARAMS, ref_seq.cam).initialize_from_depth(ref_frame, ref_map)
    cam = SyntheticSequence(**RGBD_SCENE).cam
    assert MapInitializer(PARAMS, cam).initialize_from_depth(_port_frame(ref_frame), port_map)
    want = {k: np.asarray(v) for k, v in ref_map.state._asdict().items()}
    got = {k: v.numpy() for k, v in dataclasses.asdict(port_map.state).items() if isinstance(v, torch.Tensor)}
    act = want["pt_active"]
    n = int((np.asarray(ref_frame.valid) & (np.asarray(ref_frame.depth) > 0)).sum())
    assert act.sum() == n >= 100
    np.testing.assert_array_equal(got["pt_active"], act)
    np.testing.assert_allclose(got["pt_pos"][act], want["pt_pos"][act], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["pt_normal"][act], want["pt_normal"][act], atol=1e-5, rtol=0)
    for k in ("pt_min_dist", "pt_max_dist"):
        np.testing.assert_allclose(got[k][act], want[k][act], rtol=1e-5, atol=0)
    for k in ("pt_flags", "pt_desc", "pt_creation_kf", "kf_ids", "kf_pose", "kf_active", "kf_depth"):
        np.testing.assert_array_equal(got[k], want[k].view(np.int32) if want[k].dtype == np.uint32 else want[k], k)
    assert port_map.n_keyframes == ref_map.n_keyframes == 1


def test_depth_init_branch_as_reference():
    """A depth frame initializes alone: the metric lock, the identity pose,
    kf_counter 1, the valid keypoints as the running inlier count and the
    keyframe-database entry. With fewer than 100 depths the frame returns
    None and the next one does not two-view initialize, in both packages."""
    seq, ref_seq = SyntheticSequence(**RGBD_SCENE), RefSequence(**RGBD_SCENE)
    port, ref = System(PARAMS, seq.cam, device="cpu"), RefSystem(REF_PARAMS, ref_seq.cam)
    p0, r0 = port.process_frame(seq.frame(0, device="cpu")), ref.process_frame(ref_seq.frame(0))
    np.testing.assert_array_equal(p0, np.eye(4, dtype=np.float32))
    np.testing.assert_array_equal(np.asarray(r0), p0)
    for s in (port, ref):
        assert s.manager.metric_locked and s.manager.kf_counter == 1 and s.map.n_keyframes == 1
    assert port.state == TrackingState.TRACKING and port.last_kf_inliers == ref.last_kf_inliers > 100
    np.testing.assert_array_equal(port.manager.kfdb.word_ids.numpy(), np.asarray(ref.manager.kfdb.word_ids))
    assert (port.manager.kfdb.word_ids[0] >= 0).any()

    # few depths: frames 0 and 10 (baseline enough for a two-view init) with
    # 50 depths each
    port, ref = System(PARAMS, seq.cam, device="cpu"), RefSystem(REF_PARAMS, ref_seq.cam)
    two_view = []
    port.initializer.initialize_two_view = lambda *a: two_view.append(a)
    for i in (0, 10):
        f, rf = seq.frame(i, device="cpu"), ref_seq.frame(i)
        few = np.asarray(rf.depth).copy()
        few[50:] = 0.0
        assert port.process_frame(f.replace(depth=torch.from_numpy(few))) is None
        assert ref.process_frame(rf._replace(depth=jnp.asarray(few))) is None
        for s in (port, ref):
            assert s.map.n_keyframes == 0 and s.initializer.ref_frame is None and not s.manager.metric_locked
    assert not two_view
    # the same frames without depth two-view initialize (so the branch, not the frames, held them back)
    mono = System(PARAMS, seq.cam, device="cpu")
    for i in (0, 10):
        mono.process_frame(seq.frame(i, device="cpu").replace(depth=torch.zeros(seq.n_kpt_slots)))
    assert mono.map.n_keyframes == 2


def test_stereo_points_at_keyframe_match_reference(rgbd_runs):
    ref_sys, ref_seq, seq = rgbd_runs["ref"], rgbd_runs["ref_seq"], rgbd_runs["seq"]
    res = ref_sys.tracker.track(ref_sys.map, ref_seq.frame(seq.n_frames - 1), ref_sys._prior())
    assert res.ok
    port_map, ref_copy = _carry(ref_sys.map)
    params = REF_PARAMS.replace(maxNewPoints=50)
    ref_mgr = RefMapManager(params, ref_seq.cam._replace(bl=0.15))
    mgr = MapManager(Params.from_dict(params.to_dict()), dataclasses.replace(_cam(ref_seq), bl=0.15), device="cpu")
    close = (res.host_depth > 0) & (res.host_depth < 6.0) & res.host_valid & (res.host_ids < 0)
    assert 50 < close.sum() < ((res.host_depth > 0) & res.host_valid & (res.host_ids < 0)).sum()  # cut and cap bind
    n_before = ref_copy.n_points
    # oracle frames carry no detector response: draw one, so the cap keeps the strongest 50
    f = res.frame._replace(response=jnp.asarray(np.random.default_rng(4).uniform(0, 100, res.frame.n), jnp.float32))
    for m, manager, frame in ((ref_copy, ref_mgr, f), (port_map, mgr, _port_frame(f))):
        manager.kf_counter = ref_sys.manager.kf_counter
        slot = m.add_keyframe(frame)
        manager._create_stereo_points(m, slot, frame, host_depth=res.host_depth, host_valid=res.host_valid,
                                      host_ids=res.host_ids)
    assert port_map.n_points == ref_copy.n_points == n_before + 50
    want = {k: np.asarray(v) for k, v in ref_copy.state._asdict().items()}
    got = {k: v.numpy() for k, v in dataclasses.asdict(port_map.state).items() if isinstance(v, torch.Tensor)}
    new = want["pt_active"] & ~np.asarray(ref_sys.map.state.pt_active)
    np.testing.assert_array_equal(got["pt_active"], want["pt_active"])
    for k in ("pt_pos", "pt_normal"):
        np.testing.assert_allclose(got[k][new], want[k][new], atol=1e-5, rtol=0, err_msg=k)
    for k in ("pt_min_dist", "pt_max_dist"):
        np.testing.assert_allclose(got[k][new], want[k][new], rtol=1e-5, atol=0, err_msg=k)
    for k in ("pt_desc", "pt_flags", "pt_creation_kf", "kf_ids"):
        np.testing.assert_array_equal(got[k], want[k].view(np.int32) if want[k].dtype == np.uint32 else want[k], k)


@pytest.mark.parametrize("with_depth", [True, False])
def test_loop_correction_fixes_scale_with_depth(with_depth):
    ref_seq = RefSequence(**RGBD_SCENE)
    f = ref_seq.frame(0)
    if not with_depth:
        f = f._replace(depth=jnp.zeros_like(f.depth))
    params = REF_PARAMS.replace(detectMarkers=False)
    port_params = Params.from_dict(params.to_dict())
    ref_map, port_map = RefMap(params), Map(port_params, device="cpu")
    ref_map.add_keyframe(f)
    port_map.add_keyframe(_port_frame(f))
    asked = {}

    class Found:  # a loop the detector reports
        found = True

    cam = SyntheticSequence(**RGBD_SCENE).cam
    for name, mgr, m, frame in (("ref", RefMapManager(params, ref_seq.cam), ref_map, f),
                                ("port", MapManager(port_params, cam, device="cpu"), port_map, _port_frame(f))):
        def correct_map(world_map, info, fix_scale=False, name=name):
            asked[name] = fix_scale
            return False

        mgr.loop_detector.detect_from_keypoints = lambda *a: Found()
        mgr.loop_detector.correct_map = correct_map
        mgr._detect_and_close_loop(m, 0, frame)
    assert asked == {"ref": with_depth, "port": with_depth}

    problem, _, _ = ring_problem(scale_drift=1.03)
    want = np.asarray(ref_pose_graph_solve(problem, iters=25, fix_scale=True))
    got = posegraph.pose_graph_solve(posegraph.PoseGraphProblem(*(torch.from_numpy(np.array(x)) for x in problem)),
                                     iters=25, fix_scale=True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_stereo_ba_edges_match_reference(rgbd_runs):
    ref_map, ref_seq = rgbd_runs["ref"].map, rgbd_runs["ref_seq"]
    port_map, _ = _carry(ref_map)
    fixed = ref_map.keyframes.active_slots()[:2]
    rp = ref_ba.build_ba_problem(ref_map, ref_seq.cam, fixed_kfs=fixed)[0]
    pp, _, p_pt, _ = ba.build_ba_problem(port_map, _cam(ref_seq), fixed_kfs=fixed)
    O, Pn, K = pp.obs_cam.shape[0], len(p_pt), pp.cam_pose.shape[0]
    for k in ("obs_cam", "obs_pt", "obs_uv", "obs_sigma2", "obs_depth"):
        np.testing.assert_array_equal(getattr(pp, k).numpy(), np.asarray(getattr(rp, k))[:O], err_msg=k)
    assert (pp.obs_depth > 0).sum() > 0.5 * O and pp.bf == float(rp.bf) > 0
    # both from the same perturbed estimate: points by ~2%, free cameras by ~1 cm
    rng = np.random.default_rng(0)
    pt_pos = pp.pt_pos.numpy() + (rng.normal(0, 0.02, (Pn, 3)) * np.abs(pp.pt_pos.numpy())).astype(np.float32)
    cam_pose = pp.cam_pose.numpy().copy()
    cam_pose[:, :3, 3] += np.where((pp.cam_valid & ~pp.cam_fixed).numpy()[:, None],
                                   rng.normal(0, 0.01, (K, 3)), 0.0).astype(np.float32)
    pp.cam_pose, pp.pt_pos = torch.from_numpy(cam_pose), torch.from_numpy(pt_pos)
    rp_pt = np.asarray(rp.pt_pos).copy()
    rp_pt[:Pn] = pt_pos
    want = ref_ba.ba_solve(rp._replace(cam_pose=jnp.asarray(cam_pose), pt_pos=jnp.asarray(rp_pt)), ref_seq.cam,
                           iters=10, stages=2)
    got = ba.ba_solve(pp, _cam(ref_seq), iters=10, stages=2)
    w_cam, w_pt = np.asarray(want.cam_pose), np.asarray(want.pt_pos)[:Pn]
    assert np.abs(got.cam_pose.numpy() - w_cam).max() <= 1e-4 * np.abs(w_cam).max()
    assert np.abs(got.pt_pos.numpy() - w_pt).max() <= 1e-4 * np.abs(w_pt).max()
    np.testing.assert_array_equal(got.obs_bad.numpy(), np.asarray(want.obs_bad)[:O])
    assert np.abs(got.pt_pos.numpy() - pt_pos).max() > 100 * 1e-4 * np.abs(w_pt).max()  # the LM moved the points


def test_stereo_keyframe_rule_on_recorded_results(rgbd_runs):
    """The port's TrackResults of the RGB-D run, decided by both packages'
    keyframe rule with a 0.25 m baseline (close = depth < 10 m, so the
    stereo clause can fire) over a grid of frames since the last keyframe
    and running inlier counts."""
    seq, ref_seq = rgbd_runs["seq"], rgbd_runs["ref_seq"]
    cam = dataclasses.replace(seq.cam, bl=0.25)
    port = System(PARAMS, cam, device="cpu")
    ref = RefSystem(REF_PARAMS, ref_seq.cam._replace(bl=0.25))
    decisions, by_stereo = [], 0
    assert len(rgbd_runs["recorded"]) >= 20
    for res, since, last, pose, last_rot in rgbd_runs["recorded"]:
        assert res.host_depth is not None and (res.host_depth > 0).sum() > 100
        tracked = np.nonzero(res.host_ids >= 0)[0]
        # as recorded, and with all but 80 of its tracked keypoints untracked
        for ids in (res.host_ids, np.where(np.isin(np.arange(len(res.host_ids)), tracked[80:]), -1, res.host_ids)):
            res = dataclasses.replace(res, host_ids=ids.astype(np.int32))
            ref_res = RefTrackResult(res.ok, res.pose_f2g, ref_seq.frame(int(res.frame.fseq)), res.n_matches,
                                     res.n_inliers, res.matched_point_slots, host_ids=res.host_ids,
                                     host_depth=res.host_depth, host_valid=res.host_valid)
            close = (res.host_depth > 0) & (res.host_depth < 40.0 * cam.bl)
            stereo = (int((close & (ids >= 0)).sum()) < 100 and int((close & (ids < 0) & res.host_valid).sum()) > 70)
            for since_kf in (0, 1, 5, 20):
                for running in (res.n_inliers, int(res.n_inliers / 0.8), 4 * res.n_inliers):
                    for s in (port, ref):
                        s.frames_since_kf, s.last_kf_inliers, s.pose, s._last_kf_rot = since_kf, running, pose, last_rot
                    got = port._need_keyframe(res)
                    assert got == ref._need_keyframe(ref_res), (int(res.frame.fseq), since_kf, running)
                    decisions.append(got)
                    by_stereo += got and stereo and 0 < since_kf < 20 and res.n_inliers >= 0.75 * running
    assert any(decisions) and not all(decisions)
    assert by_stereo > 0  # the stereo clause alone decided some
