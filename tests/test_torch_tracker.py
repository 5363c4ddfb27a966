"""The port's tracker against the reference's on the same map and frame.

The map is built from a rendered frame of the synthetic sequence (keypoints
back-projected through the renderer's exact depth), the tracked frame is a
later rendered frame extracted by the reference; both packages get the same
MapState and Frame, converted to tensors with map_state_from_numpy and
frame_from_numpy. The reference runs its XLA path on the CPU (dense matcher,
jnp.linalg.solve in the LM); the port runs the plain versions of
kernels B1 and B2 (CG(8) solve). Pose within 1e-4, equal inlier counts.
With two markers of known map pose in view, the tracker's marker-corner
rows are equal, and _track_step (whose LM weighs them against the keypoint
rows by sigma2_mk) gives the pose within 1e-4 and the same inliers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucoslam_tpu.config import Params
from ucoslam_tpu.features.frame_extractor import FrameExtractor as RefExtractor
from ucoslam_tpu.geometry.camera import CameraParams as RefCamera
from ucoslam_tpu.io.synthetic import SyntheticSequence as RefSequence
from ucoslam_tpu.mapping.frame import strip_markers
from ucoslam_tpu.mapping.map import Map as RefMap
from ucoslam_tpu.mapping.map import empty_map_state
from ucoslam_tpu.geometry import se3_exp as ref_se3_exp
from ucoslam_tpu.markers.detector import SyntheticMarkerDetector as RefMarkerDetector
from ucoslam_tpu_torch.mapping.frame import markers_from_numpy
from ucoslam_tpu.slam import tracker as ref_tracker
from ucoslam_tpu_torch.config import Params as PortParams
from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.mapping.frame import frame_from_numpy
from ucoslam_tpu_torch.mapping.map import Map, map_state_from_numpy
from ucoslam_tpu_torch.slam import tracker

torch.set_num_threads(2)

PARAMS = Params().replace(
    detectMarkers=False, maxDescDistance=60.0, maxKeyPointsPerFrame=512,
    nOctaveLevels=4, maxMapPoints=1024, maxKeyFrames=4,
)


@pytest.fixture(scope="module")
def scene():
    cam = RefCamera.create(500.0, 500.0, 320.0, 240.0)
    seq = RefSequence(cam=cam, n_frames=20, n_points=700, seed=13)
    ext = RefExtractor(PARAMS, cam)
    img0, dep0 = seq.render_with_depth(4)
    f0 = ext.process(img0, 4)
    xy = np.asarray(f0.xy)
    ok = np.array(f0.valid)
    xi, yi = np.round(xy[:, 0]).astype(int).clip(0, 639), np.round(xy[:, 1]).astype(int).clip(0, 479)
    z = dep0[yi, xi]
    ok &= z > 0
    T0 = seq.gt_pose(4)
    pc = np.c_[(xy[:, 0] - 320.0) / 500.0 * z, (xy[:, 1] - 240.0) / 500.0 * z, z]
    pw = (pc - T0[:3, 3]) @ T0[:3, :3]  # camera -> world
    centre = -T0[:3, :3].T @ T0[:3, 3]
    ray = pw - centre
    dist = np.linalg.norm(ray, axis=1)
    octave = np.asarray(f0.octave)
    n = int(ok.sum())
    st = empty_map_state(PARAMS)
    P = st.P
    pad = lambda a, fill=0: np.concatenate([a, np.full((P - n,) + a.shape[1:], fill, a.dtype)])  # noqa: E731
    max_d = (dist * 1.2**octave)[ok].astype(np.float32)
    st = st._replace(
        pt_pos=jnp.asarray(pad(pw[ok].astype(np.float32))),
        pt_normal=jnp.asarray(pad((ray[ok] / dist[ok, None]).astype(np.float32))),
        pt_desc=jnp.asarray(pad(np.asarray(f0.desc)[ok])),
        pt_min_dist=jnp.asarray(pad(max_d / 1.2**3)),
        pt_max_dist=jnp.asarray(pad(max_d, 1e9)),
        pt_active=jnp.asarray(pad(np.ones(n, bool), False)),
        kf_active=st.kf_active.at[0].set(True),
    )
    frame = ext.process(seq.render(6), 6)
    return cam, seq, st, frame


def _port_inputs(st, frame):
    state = map_state_from_numpy({k: np.asarray(v) for k, v in st._asdict().items()}, "cpu")
    fr = frame_from_numpy(
        {k: np.asarray(v) for k, v in frame._asdict().items() if k != "markers"}, "cpu"
    )
    return state, fr


def _prior(seq, i, shift):
    T = seq.gt_pose(i).copy()
    T[:3, 3] += shift
    return T.astype(np.float32)


@pytest.mark.parametrize("shift", [(0.0, 0.0, 0.0), (0.06, -0.03, 0.05)])
def test_track_step_matches_reference(scene, shift):
    cam, seq, st, frame = scene
    prior = _prior(seq, 5, shift)  # the previous frame's pose, as a motion prior
    want = ref_tracker._track_step(
        st, strip_markers(frame),
        cam, jnp.asarray(prior), jnp.float32(15.0), jnp.float32(60.0), jnp.float32(1.2),
    )
    state, fr = _port_inputs(st, frame)
    zero_mk = (torch.zeros(64, 3), torch.zeros(64, 2), torch.zeros(64, dtype=torch.bool))
    got = tracker._track_step(
        state, fr, CameraParams.create(500.0, 500.0, 320.0, 240.0), torch.from_numpy(prior),
        15.0, 60.0, 1.2, *zero_mk,
    )
    pose, ids, inlier, n_matched, n_inl, vis, seen = got
    assert int(want[4]) > 50, "the scene tracks"
    assert int(n_inl) == int(want[4])
    assert int(n_matched) == int(want[3])
    assert np.abs(pose.numpy() - np.asarray(want[0])).max() < 1e-4
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(vis.numpy(), np.asarray(want[5]))


def test_tracker_track_matches_reference(scene):
    cam, seq, st, frame = scene
    prior = _prior(seq, 5, (0.0, 0.0, 0.0))
    ref_map = RefMap(PARAMS)
    ref_map.state = st
    want = ref_tracker.Tracker(PARAMS, cam).track(ref_map, frame, jnp.asarray(prior))
    state, fr = _port_inputs(st, frame)
    port_params = PortParams.from_dict(PARAMS.to_dict())
    port_map = Map(port_params, state)
    trk = tracker.Tracker(port_params, CameraParams.create(500.0, 500.0, 320.0, 240.0), "cpu")
    got = trk.track(port_map, fr, torch.from_numpy(prior))
    assert trk.n_attempts == 1
    assert got.ok == want.ok and got.ok
    assert got.n_inliers == want.n_inliers and got.n_matches == want.n_matches
    assert np.abs(got.pose_f2g - want.pose_f2g).max() < 1e-4
    np.testing.assert_array_equal(got.matched_point_slots, want.matched_point_slots)
    np.testing.assert_array_equal(got.host_ids, want.host_ids)


def test_fetch_to_host_round_trips():
    ts = (torch.randn(4, 4), torch.arange(-3, 5, dtype=torch.int32), torch.tensor([True, False]),
          torch.tensor(7), torch.tensor(-2.5))
    out = tracker.fetch_to_host(*ts)
    for t, a in zip(ts, out):
        assert a.shape == tuple(t.shape)
        np.testing.assert_array_equal(a, t.numpy())


def test_marker_rows_and_track_step_match_reference(scene):
    cam, seq, st, frame = scene
    flip = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    g2m = {100 + i: np.asarray(ref_se3_exp(jnp.asarray(xi, jnp.float32))) @ flip
           for i, xi in enumerate([(-1.0, 0.5, 4.5, 0.3, 0.2, 0.0), (1.2, -0.4, 5.0, -0.2, 0.3, 0.1)])}
    markers = RefMarkerDetector(g2m, 0.5).detect_at_pose(seq.gt_pose(6), cam, noise=0.3, rng=np.random.default_rng(2))
    assert int(np.asarray(markers.valid).sum()) == 2
    st = st._replace(
        mk_id=st.mk_id.at[:2].set(jnp.asarray([100, 101], jnp.int32)),
        mk_pose=st.mk_pose.at[:2].set(jnp.asarray(np.stack([g2m[100], g2m[101]]))),
        mk_pose_valid=st.mk_pose_valid.at[:2].set(True), mk_size=st.mk_size.at[:2].set(0.5),
        mk_active=st.mk_active.at[:2].set(True),
    )
    frame = frame._replace(markers=markers)
    params = PARAMS.replace(detectMarkers=True)
    ref_map = RefMap(params)
    ref_map.state = st
    want_rows = [np.asarray(a) for a in ref_tracker.Tracker(params, cam)._marker_rows(ref_map, frame)]
    state, fr = _port_inputs(st, frame)
    fr = fr.replace(markers=markers_from_numpy(markers))
    port_params = PortParams.from_dict(params.to_dict())
    trk = tracker.Tracker(port_params, CameraParams.create(500.0, 500.0, 320.0, 240.0), "cpu")
    rows = trk._marker_rows(Map(port_params, state), fr)
    for g, w in zip(rows, want_rows):
        np.testing.assert_array_equal(g.numpy(), w)
    assert int(rows[2].sum()) == 8
    prior = _prior(seq, 5, (0.04, -0.02, 0.03))
    want = ref_tracker._track_step(
        st, strip_markers(frame), cam, jnp.asarray(prior), jnp.float32(15.0), jnp.float32(60.0),
        jnp.float32(1.2), *(jnp.asarray(w) for w in want_rows),
    )
    got = tracker._track_step(state, fr, CameraParams.create(500.0, 500.0, 320.0, 240.0), torch.from_numpy(prior),
                              15.0, 60.0, 1.2, *rows)
    assert int(got[4]) == int(want[4]) > 50
    assert np.abs(got[0].numpy() - np.asarray(want[0])).max() < 1e-4
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
