"""Marker-aided SLAM on the port, on the CPU: the counterparts of
tests/test_marker_slam.py, on the same seeded sequences with the same gates,
and the cross-package checkpoint.

- metric-scale init (30 oracle frames, 3 markers): >= 90% tracked, metric
  ATE (no scale alignment) < 0.08, scale-aligned ATE < 0.05, >= 2 markers
  in the map and >= 1 with a pose;
- one-frame marker init (10 frames, aruco_allowOneFrameInitialization):
  initialized on frame 0 and >= 8 frames tracked; the reference's init on
  frame 0 is the same, its marker's map pose within 1e-4;
- the marker fallback when the keypoints of frames 15-19 vanish: >= 3 of
  them posed, metric ATE < 0.1;
- forceInitializationFromMarkers with no markers: no init at all, in the
  port and in the reference;
- the production path (rendered frames, the native detector) is in
  tests/test_torch_markers.py; the two-frame marker init, the metric scale
  of the hybrid init and the marker fallback, held against the reference
  on shared inputs, are in tests/test_torch_marker_init.py;
- `Map.center_ref_system_in_marker` on the metric-scale run after 20
  frames: the marker pose becomes the identity, the reprojection chi2 is
  kept (within 20%), an unknown id is refused;
- the checkpoint: the port reads the JAX package's marker map
  (data/torch_port/markers_map.slm) with its signature, and the JAX package
  reads the port's marker checkpoint with the port's signature and marker
  arrays.
"""

import os

import numpy as np
import pytest
import torch

from ucoslam_tpu.api import UcoSlam as RefSlam
from ucoslam_tpu.config import Params as RefParams
from ucoslam_tpu.geometry.camera import CameraParams as RefCamera
from ucoslam_tpu.io.synthetic import SyntheticSequence as RefSequence
from ucoslam_tpu.slam import System as RefSystem
from ucoslam_tpu_torch.api import UcoSlam
from ucoslam_tpu_torch.config import Params
from ucoslam_tpu_torch.geometry.horn import ate_rmse
from ucoslam_tpu_torch.io.serialize import load_map, load_map_meta
from ucoslam_tpu_torch.io.synthetic import SyntheticSequence
from ucoslam_tpu_torch.mapping.frame import empty_markers
from ucoslam_tpu_torch.slam.system import System

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = Params().replace(maxMapPoints=4096, maxKeyFrames=32, maxKeyPointsPerFrame=512, maxDescDistance=60.0,
                          aruco_markerSize=0.5)


def run(seq, params=PARAMS, strip_kpts=frozenset(), strip_markers=frozenset(), snapshot=None):
    """The port's System over the oracle frames; `snapshot` = (frame count,
    path): a checkpoint of the session after that many frames."""
    slam = UcoSlam(device="cpu")
    slam.setParams(None, params, seq.cam)
    poses = {}
    for i in range(seq.n_frames):
        if snapshot is not None and i == snapshot[0]:
            slam.saveToFile(snapshot[1])
        f = seq.frame(i, device="cpu")
        if i in strip_kpts:
            f = f.replace(valid=torch.zeros_like(f.valid))
        if i in strip_markers:
            f = f.replace(markers=empty_markers())
        p = slam.process_frame(f)
        if p is not None:
            poses[i] = p
    return slam, poses


def centres(poses):
    idx = sorted(poses)
    return idx, np.stack([-poses[i][:3, :3].T @ poses[i][:3, 3] for i in idx])


def metric_ate(poses, seq):
    idx, est = centres(poses)
    return ate_rmse(est, seq.gt_positions()[idx], with_scale=False)


@pytest.fixture(scope="module")
def metric_run(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mk") / "after20.slm")
    seq = SyntheticSequence(n_frames=30, seed=13, n_markers=3, marker_size=0.5)
    slam, poses = run(seq, snapshot=(20, path))
    return seq, slam, poses, path


def test_marker_init_recovers_metric_scale(metric_run):
    seq, slam, poses, _ = metric_run
    assert len(poses) >= 0.9 * (seq.n_frames - 1)
    assert metric_ate(poses, seq) < 0.08
    idx, est = centres(poses)
    assert ate_rmse(est, seq.gt_positions()[idx], with_scale=True) < 0.05
    assert int(slam.map.h("mk_active").sum()) >= 2
    assert int(slam.map.h("mk_pose_valid").sum()) >= 1
    assert slam._system.manager.metric_locked


def test_one_frame_marker_init_equals_reference():
    kw = dict(n_frames=10, seed=14, n_markers=2, marker_size=0.5, marker_noise=0.05)
    params = PARAMS.replace(aruco_allowOneFrameInitialization=True)
    seq = SyntheticSequence(**kw)
    slam, poses = run(seq, params)
    assert 0 in poses and len(poses) >= 8
    # frame 0 alone through both packages: the same init, the same marker pose
    port = System(params, seq.cam, device="cpu")
    ref_seq = RefSequence(**kw)
    ref = RefSystem(RefParams.from_dict(params.to_dict()), ref_seq.cam)
    got, want = port.process_frame(seq.frame(0, device="cpu")), ref.process_frame(ref_seq.frame(0))
    np.testing.assert_array_equal(got, np.eye(4, dtype=np.float32))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port.map.h("mk_pose_valid"), np.asarray(ref.map.state.mk_pose_valid))
    np.testing.assert_array_equal(port.map.h("mk_id"), np.asarray(ref.map.state.mk_id))
    assert np.abs(port.map.h("mk_pose") - np.asarray(ref.map.state.mk_pose)).max() < 1e-4


def test_marker_fallback_when_keypoints_die():
    seq = SyntheticSequence(n_frames=30, seed=15, n_markers=3, marker_size=0.5)
    strip = set(range(15, 20))
    slam, poses = run(seq, strip_kpts=strip)
    assert sum(i in poses for i in strip) >= 3
    assert slam._system.n_marker_poses >= 3
    assert metric_ate(poses, seq) < 0.1


def test_force_initialization_from_markers():
    params = PARAMS.replace(forceInitializationFromMarkers=True)
    seq = SyntheticSequence(n_frames=20, seed=16, n_markers=0)
    slam, poses = run(seq, params)
    assert len(poses) == 0 and slam.map.n_keyframes == 0
    # the reference on the same frames: no init either
    ref_seq = RefSequence(n_frames=20, seed=16, n_markers=0)
    ref = RefSystem(RefParams.from_dict(params.to_dict()), ref_seq.cam)
    assert all(ref.process_frame(ref_seq.frame(i)) is None for i in range(ref_seq.n_frames))
    assert ref.map.n_keyframes == 0


def test_center_ref_system_in_marker(metric_run):
    seq, _, _, path = metric_run
    m = load_map(path, "cpu")
    mk_id, mk_valid = m.h("mk_id", "mk_pose_valid")
    sel = np.nonzero((mk_id >= 0) & mk_valid)[0]
    assert len(sel) > 0
    chi_before = m.global_reproj_chi2(seq.cam)
    assert m.center_ref_system_in_marker(int(mk_id[sel[0]]))
    assert np.allclose(m.h("mk_pose")[sel[0]], np.eye(4), atol=1e-4)
    chi_after = m.global_reproj_chi2(seq.cam)
    assert abs(chi_after - chi_before) < max(0.2 * chi_before, 0.5)
    assert not m.center_ref_system_in_marker(99999)


def test_marker_checkpoint_read_by_both_packages(metric_run, tmp_path):
    # the JAX package's marker map, read by the port
    jax_map = os.path.join(REPO, "data", "torch_port", "markers_map.slm")
    m = load_map(jax_map, "cpu")
    assert m.signature() == load_map_meta(jax_map)["signature"]
    assert int(m.h("mk_pose_valid").sum()) >= 1 and m.markers.n_active >= 1
    # the port's marker checkpoint, read by the JAX package
    seq, slam, _, _ = metric_run
    path = str(tmp_path / "port_markers.slm")
    slam.saveToFile(path)
    ref = RefSlam()
    ref.readFromFile(path, RefCamera.create(float(seq.cam.fx), float(seq.cam.fy), float(seq.cam.cx),
                                            float(seq.cam.cy)))
    assert ref.map.signature() == slam.map.signature()
    for k in ("mk_id", "mk_pose", "mk_pose_valid", "kf_mk_slot", "kf_mk_corners"):
        np.testing.assert_array_equal(np.asarray(getattr(ref.map.state, k)), slam.map.h(k), err_msg=k)
    np.testing.assert_array_equal(ref.map.markers.active, slam.map.markers.active)
    assert ref._system.manager.metric_locked


@pytest.mark.parametrize("n_close,n_tracked", [(80, 10), (40, 10), (80, 120)])
def test_keyframe_decision_on_a_marker_pose(n_close, n_tracked):
    """A camera with a baseline (the parity scenes' default camera has
    bl = 0.1) and a pose the markers gave: that result carries no bundled
    host fetch, and the close-point keyframe test reads the frame's own
    depth, ids and valid, as the reference's does."""
    import jax.numpy as jnp

    from ucoslam_tpu.mapping.frame import empty_frame as ref_empty_frame
    from ucoslam_tpu.slam.tracker import TrackResult as RefTrackResult
    from ucoslam_tpu_torch.geometry.camera import CameraParams
    from ucoslam_tpu_torch.mapping.frame import empty_frame
    from ucoslam_tpu_torch.slam.system import System
    from ucoslam_tpu_torch.slam.tracker import TrackResult

    n = 256
    depth = np.zeros(n, np.float32)
    depth[: n_close + n_tracked] = 2.0
    ids = np.full(n, -1, np.int32)
    ids[n_close : n_close + n_tracked] = np.arange(n_tracked)
    valid = np.ones(n, bool)
    params = Params().replace(maxKeyPointsPerFrame=n, detectMarkers=False)
    ref_params = RefParams().replace(maxKeyPointsPerFrame=n, detectMarkers=False)
    sys_ = System(params, CameraParams.create(500.0, 500.0, 320.0, 240.0, bl=0.1), device="cpu")
    ref_sys = RefSystem(ref_params, RefCamera.create(500.0, 500.0, 320.0, 240.0, bl=0.1))
    frame = empty_frame(n, "cpu").replace(depth=torch.from_numpy(depth), ids=torch.from_numpy(ids),
                                          valid=torch.from_numpy(valid))
    ref_frame = ref_empty_frame(n)._replace(depth=jnp.asarray(depth), ids=jnp.asarray(ids), valid=jnp.asarray(valid))
    got, want = [], []
    for frames_since_kf in (0, 3):
        for s in (sys_, ref_sys):
            s.frames_since_kf, s.last_kf_inliers = frames_since_kf, 100
        got.append(sys_._need_keyframe(TrackResult(True, np.eye(4, dtype=np.float32), frame, 95, 90,
                                                   np.zeros(0, np.int32))))
        want.append(ref_sys._need_keyframe(RefTrackResult(True, jnp.eye(4), ref_frame, 95, 90,
                                                          np.zeros(0, np.int32))))
    assert got == want
    assert got[1] == (n_close > 70 and n_tracked < 100)
