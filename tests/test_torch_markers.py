"""The port's marker modules against the reference's, on the same inputs.

- dictionary codewords and marker textures: bit-equal;
- the native detector the port builds (its copy of native/'s source, into
  build/ucoslam_tpu_torch/, never native/) against the reference's on the
  same rendered image: the same ids and bit-equal corners (the same code for
  the native tables, the same flags); the full ArucoDetector.detect (IPPE
  included) alike; a dictionary neither package resolves raises in both;
- IPPE on tests/test_markers.py's cases, with 0.5 px corner noise so that
  the best pose's error is not zero: poses within 1e-4 and err_ratio within
  1e-3 (relative) where err_ratio >= 1.5; the frontal-ambiguous and the
  tilted-unambiguous cases on the same side of the 3.0 gate;
- SyntheticSequence(n_markers=10): the same marker poses, rendered images
  pixel for pixel (at most 0.1% of pixels may differ; none did when this
  was written), oracle detections with the same ids and corners (1e-3 px).
  Their IPPE poses are held within 2e-3 where err_ratio >= 1.5, and
  err_ratio within 1e-3 at the median and 10% at worst: a small, far
  marker's IPPE is ill-conditioned in float32 (the homography is the null
  vector of A^T A, whose condition is squared);
- removeKeyPointsIntoMarkers' point-in-quad test: equal;
- tests/test_marker_slam.py's production path on the port: rendered frames
  with real markers through `UcoSlam(device="cpu").setParams` (which builds
  the native detector with g++) and `process`: >= 1 marker mapped, >= 8 of
  16 frames tracked, the median step-length ratio within 25% of 1, metric
  ATE < 0.5, and no valid keypoint inside a detected marker;
- every function of slam/markermap.py on a map of oracle keyframes: the
  same slots and observation arrays, the same poses set (within 1e-4), the
  same metric-scale estimate (1e-4 relative), the size fit (1e-4), the
  corner error (1e-4 relative) and the pose from valid markers (1e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucoslam_tpu.config import Params
from ucoslam_tpu.features.frame_extractor import _points_in_quads
from ucoslam_tpu.geometry import CameraParams as RefCamera
from ucoslam_tpu.geometry import se3_exp as ref_se3_exp
from ucoslam_tpu.io import SyntheticSequence as RefSequence
from ucoslam_tpu.mapping.frame import empty_frame as ref_empty_frame
from ucoslam_tpu.mapping.map import Map as RefMap
from ucoslam_tpu.markers import dictionary as ref_dictionary
from ucoslam_tpu.markers import native as ref_native
from ucoslam_tpu.markers.detector import ArucoDetector as RefDetector
from ucoslam_tpu.markers.ippe import ippe_square_poses as ref_ippe
from ucoslam_tpu.markers.ippe import marker_object_points as ref_object_points
from ucoslam_tpu.slam import markermap as ref_mm
from ucoslam_tpu_torch.api import UcoSlam
from ucoslam_tpu_torch.config import Params as PortParams
from ucoslam_tpu_torch.features.frame_extractor import points_in_quads
from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.geometry.horn import ate_rmse
from ucoslam_tpu_torch.io.synthetic import SyntheticSequence
from ucoslam_tpu_torch.mapping.frame import empty_frame, markers_from_numpy
from ucoslam_tpu_torch.mapping.map import Map
from ucoslam_tpu_torch.markers import dictionary, native
from ucoslam_tpu_torch.markers.detector import ArucoDetector
from ucoslam_tpu_torch.markers.ippe import ippe_square_poses
from ucoslam_tpu_torch.slam import markermap

torch.set_num_threads(2)

REF_CAM = RefCamera.create(500.0, 500.0, 320.0, 240.0)
CAM = CameraParams.create(500.0, 500.0, 320.0, 240.0)
SLAM_PARAMS = PortParams().replace(maxMapPoints=4096, maxKeyFrames=32, maxKeyPointsPerFrame=512,
                                  maxDescDistance=60.0)
SCENE = dict(n_frames=60, n_points=1600, n_markers=10, marker_size=0.6, seed=5)  # the markers parity scene


@pytest.mark.parametrize("name", ["ARUCO_MIP_36h12", "ARUCO_MIP_16h3"])
def test_dictionary_and_textures_bit_equal(name):
    words = dictionary.load_codewords(name)
    np.testing.assert_array_equal(words, ref_dictionary.load_codewords(name))
    assert dictionary.dict_bits(name) == ref_dictionary.dict_bits(name)
    for mid in (0, 17, len(words) - 1):
        tex, ratio = dictionary.marker_texture(mid, name=name)
        ref_tex, ref_ratio = ref_dictionary.marker_texture(mid, name=name)
        np.testing.assert_array_equal(tex, ref_tex)
        assert ratio == ref_ratio


@pytest.fixture(scope="module")
def scenes():
    return RefSequence(**SCENE), SyntheticSequence(**SCENE)


def test_native_detector_equals_reference(scenes):
    ref_seq, _ = scenes
    assert ref_native.native_available()
    lib = native.build()
    assert lib.parent == native.BUILD_DIR and lib.parent.name == "ucoslam_tpu_torch"
    n_found = 0
    for i in (0, 30, 59):
        gray = np.clip(ref_seq.render(i), 0, 255).astype(np.uint8)
        ids, corners = native.detect_markers_native(gray)
        want_ids, want_corners = ref_native.detect_markers_native(gray)
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_array_equal(corners, want_corners)
        n_found += len(ids)
    assert n_found >= 5, "the rendered markers are detected"


def test_aruco_detector_equals_reference(scenes):
    ref_seq, _ = scenes
    img = ref_seq.render(30)
    got = ArucoDetector("ARUCO_MIP_36h12", marker_size=0.6, device="cpu").detect(img, CAM)
    want = RefDetector("ARUCO_MIP_36h12", marker_size=0.6, backend="native").detect(img, REF_CAM)
    np.testing.assert_array_equal(got.id, np.asarray(want.id))
    np.testing.assert_array_equal(got.valid, np.asarray(want.valid))
    np.testing.assert_array_equal(got.corners, np.asarray(want.corners))
    np.testing.assert_array_equal(got.und_corners, np.asarray(want.und_corners))
    v = got.valid & (np.asarray(want.err_ratio) >= 1.5)
    assert v.sum() >= 2
    assert np.abs(got.pose1[v] - np.asarray(want.pose1)[v]).max() < 1e-3


def test_unknown_dictionary_raises_in_both():
    """A name the reference cannot resolve (cv2.aruco has no
    DICT_ARUCO_MIP_25h7) raises in the port too, naming it; every name the
    reference resolves builds (tests/test_torch_dictionaries.py)."""
    with pytest.raises(AttributeError):
        RefDetector("ARUCO_MIP_25h7", backend="cv2")
    with pytest.raises(ValueError, match="ARUCO_MIP_25h7"):
        ArucoDetector("ARUCO_MIP_25h7", device="cpu")
    assert ArucoDetector("TAG36h11", device="cpu").spec.max_correction == 3


def _project(T, size):
    obj = np.asarray(ref_object_points(jnp.float32(size)))
    return np.asarray(REF_CAM.project(jnp.asarray(obj @ T[:3, :3].T + T[:3, 3])))


def _ippe_both(corners, sizes):
    want = [np.asarray(a) for a in ref_ippe(jnp.asarray(corners), jnp.asarray(sizes), REF_CAM)]
    got = [a.numpy() for a in ippe_square_poses(torch.from_numpy(corners), torch.from_numpy(sizes), CAM)]
    return got, want


def _hold(got, want, ratio_min=1.5, pose_tol=1e-4, ratio_tol=1e-3):
    ratio_g, ratio_w = got[3] / got[2], want[3] / want[2]
    sel = ratio_w >= ratio_min
    for k in (0, 1):
        assert np.abs(got[k][sel] - want[k][sel]).max() < pose_tol, ("pose", k)
    assert (np.abs(ratio_g - ratio_w)[sel] / ratio_w[sel]).max() < ratio_tol
    return int(sel.sum())


def test_ippe_recovers_pose_batch_equals_reference():
    """tests/test_markers.py::test_recovers_pose_batch's poses, noisy corners."""
    rng = np.random.default_rng(71)
    corners = []
    for _ in range(16):
        xi = np.concatenate([rng.uniform(-1.0, 1.0, 2), [0.0], rng.uniform(-0.5, 0.5, 3)]).astype(np.float32)
        T = np.asarray(ref_se3_exp(jnp.asarray(xi))).copy()
        T[2, 3] += 4.0
        corners.append(_project(T, 0.5))
    corners = (np.stack(corners) + rng.normal(0, 0.5, (16, 4, 2))).astype(np.float32)
    assert _hold(*_ippe_both(corners, np.full(16, 0.5, np.float32))) >= 12


def test_ippe_ambiguity_cases_equal_reference():
    """tests/test_markers.py's frontal-far (ambiguous) and tilted-close cases."""
    T_far = np.eye(4, dtype=np.float32)
    T_far[2, 3] = 20.0
    T_tilt = np.asarray(ref_se3_exp(jnp.asarray([0.3, 0.1, 0.0, 0.7, 0.2, 0.0], jnp.float32))).copy()
    T_tilt[2, 3] += 2.0
    rng = np.random.default_rng(3)
    corners = np.stack([_project(T_far, 0.2), _project(T_tilt, 0.5)])
    corners = (corners + rng.normal(0, 0.5, corners.shape)).astype(np.float32)
    got, want = _ippe_both(corners, np.asarray([0.2, 0.5], np.float32))
    ratio_g, ratio_w = got[3] / got[2], want[3] / want[2]
    assert ratio_g[0] < 3.0 and ratio_w[0] < 3.0
    assert ratio_g[1] > 3.0 and ratio_w[1] > 3.0
    assert _hold(got, want) >= 1


def test_synthetic_scene_markers_equal_reference(scenes):
    ref_seq, seq = scenes
    np.testing.assert_array_equal(seq.points, ref_seq.points)
    want_poses = ref_seq._marker_detector.poses
    assert sorted(seq.marker_poses) == sorted(want_poses)
    for mid, T in want_poses.items():
        assert np.abs(seq.marker_poses[mid] - T).max() < 1e-6
    rows = []
    for i in (0, 20, 40, 59):
        img, want_img = seq.render(i), ref_seq.render(i)
        assert (img != want_img).mean() <= 1e-3
        f, rf = seq.frame(i, device="cpu"), ref_seq.frame(i)
        rm = rf.markers
        np.testing.assert_array_equal(f.markers.id, np.asarray(rm.id))
        np.testing.assert_array_equal(f.markers.valid, np.asarray(rm.valid))
        assert np.abs(f.markers.corners - np.asarray(rm.corners)).max() < 1e-3
        np.testing.assert_array_equal(f.xy.numpy(), np.asarray(rf.xy))
        v = f.markers.valid & (np.asarray(rm.err_ratio) >= 1.5)
        assert np.abs(f.markers.pose1[v] - np.asarray(rm.pose1)[v]).max() < 2e-3
        rows += list(np.abs(f.markers.err_ratio[v] - np.asarray(rm.err_ratio)[v]) / np.asarray(rm.err_ratio)[v])
    assert len(rows) >= 20 and np.median(rows) < 1e-3 and max(rows) < 0.1


def test_points_in_quads_equal_reference():
    rng = np.random.default_rng(5)
    xy = rng.uniform(0, 640, (500, 2)).astype(np.float32)
    quads = np.zeros((16, 4, 2), np.float32)
    for m in range(16):
        c, h, a = rng.uniform(100, 500, 2), rng.uniform(10, 80), rng.uniform(0, np.pi)
        ang = a + np.arange(4) * np.pi / 2 * (1 if m % 2 else -1)  # both windings
        quads[m] = c + h * np.stack([np.cos(ang), np.sin(ang)], -1)
    valid = rng.random(16) < 0.7
    want = np.asarray(_points_in_quads(jnp.asarray(xy), jnp.asarray(quads), jnp.asarray(valid)))
    got = points_in_quads(torch.from_numpy(xy), torch.from_numpy(quads), torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 20 < want.sum() < 480


def test_rendered_markers_native_detector_production_path():
    seq = SyntheticSequence(n_frames=16, seed=3, n_points=700, n_markers=4, marker_size=0.8)
    params = SLAM_PARAMS.replace(aruco_markerSize=0.8, forceInitializationFromMarkers=True,
                            aruco_allowOneFrameInitialization=True)
    slam = UcoSlam(device="cpu")
    slam.setParams(None, params, seq.cam)  # builds the native detector from aruco_*
    assert slam._extractor.marker_detector is not None
    poses = {}
    for i in range(seq.n_frames):
        img = np.clip(seq.render(i), 0, 255).astype(np.uint8)
        if i == 8:  # removeKeyPointsIntoMarkers: no keypoint left inside a marker
            f = slam._extractor.process(img, i)
            assert f.markers.valid.any()
            inside = points_in_quads(f.xy, torch.from_numpy(f.markers.corners), torch.from_numpy(f.markers.valid))
            assert not bool((inside & f.valid).any())
        p = slam.process(img, fseq=i)
        if p is not None:
            poses[i] = p
    assert int((slam.map.h("mk_id") >= 0).sum()) >= 1
    assert len(poses) >= 8
    idx = sorted(poses)
    est = np.stack([-poses[i][:3, :3].T @ poses[i][:3, 3] for i in idx])
    gt = seq.gt_positions()[idx]
    ratio = np.median(np.linalg.norm(np.diff(est, axis=0), axis=1)
                      / np.clip(np.linalg.norm(np.diff(gt, axis=0), axis=1), 1e-9, None))
    assert abs(ratio - 1.0) < 0.25, ratio
    assert ate_rmse(est, gt, with_scale=False) < 0.5


# ---- slam/markermap.py on a map of oracle keyframes ----------------------

MAP_PARAMS = Params().replace(maxMapPoints=256, maxKeyFrames=8, maxKeyPointsPerFrame=512, aruco_markerSize=0.5)
KF_FRAMES = (0, 6, 12, 18)


def _maps(scale=1.0):
    """Both packages' maps holding oracle keyframes of a 3-marker scene at
    the true poses (translations times `scale`), their markers recorded
    through resolve_marker_slots / record_marker_observations."""
    ref_seq = RefSequence(n_frames=30, seed=13, n_markers=3, marker_size=0.5)
    ref_map, port_map = RefMap(MAP_PARAMS), Map(PortParams.from_dict(MAP_PARAMS.to_dict()), device="cpu")
    slots = []
    for i in KF_FRAMES:
        T = ref_seq.gt_pose(i).copy()
        T[:3, 3] *= scale
        rf = ref_seq.frame(i)
        rf = ref_empty_frame(512)._replace(fseq=jnp.int32(i), pose_f2g=jnp.asarray(T), markers=rf.markers)
        pf = empty_frame(512, "cpu").replace(fseq=i, pose_f2g=torch.from_numpy(T),
                                             markers=markers_from_numpy(rf.markers))
        s_ref = ref_mm.resolve_marker_slots(ref_map, rf.markers)
        ref_mm.record_marker_observations(ref_map, ref_map.add_keyframe(rf), rf.markers, s_ref)
        s_port = markermap.resolve_marker_slots(port_map, pf.markers)
        markermap.record_marker_observations(port_map, port_map.add_keyframe(pf), pf.markers, s_port)
        slots.append((s_port, s_ref))
    return ref_seq, ref_map, port_map, slots


def test_resolve_and_record_equal_reference():
    _, ref_map, port_map, slots = _maps()
    for s_port, s_ref in slots:
        np.testing.assert_array_equal(s_port, s_ref)
    st = ref_map.state
    for k in ("mk_id", "mk_active", "mk_size", "kf_mk_slot", "kf_mk_corners"):
        np.testing.assert_array_equal(port_map.h(k), np.asarray(getattr(st, k)), err_msg=k)
    np.testing.assert_array_equal(port_map.markers.active, ref_map.markers.active)
    assert port_map.markers.n_active == 3


def test_update_marker_poses_equal_reference():
    _, ref_map, port_map, _ = _maps()
    n_ref = ref_mm.update_marker_poses(ref_map, REF_CAM, MAP_PARAMS)
    n_port = markermap.update_marker_poses(port_map, CAM, port_map.params)
    assert n_port == n_ref == 3
    np.testing.assert_array_equal(port_map.h("mk_pose_valid"), np.asarray(ref_map.state.mk_pose_valid))
    assert np.abs(port_map.h("mk_pose") - np.asarray(ref_map.state.mk_pose)).max() < 1e-4


def test_reproj_corner_err_equals_reference():
    ref_seq, ref_map, port_map, _ = _maps()
    kf_pose, corners = port_map.h("kf_pose"), port_map.h("kf_mk_corners")
    g2m = ref_seq._marker_detector.poses[100]
    for k in range(len(KF_FRAMES)):
        got = markermap._reproj_corner_err(g2m, kf_pose[k], corners[k, 0], 0.5, CAM)
        want = ref_mm._reproj_corner_err(g2m, kf_pose[k], corners[k, 0], 0.5, REF_CAM)
        assert abs(got - want) <= 1e-4 * max(want, 1.0)
        assert got < 2.0


def test_scale_estimate_and_size_fit_equal_reference():
    """On a map at half scale with no marker poses: the size fit of each
    pending marker and the median correction (~2)."""
    ref_seq, ref_map, port_map, _ = _maps(scale=0.5)
    want = ref_mm.estimate_scale_from_pending_markers(ref_map, REF_CAM, MAP_PARAMS)
    got = markermap.estimate_scale_from_pending_markers(port_map, CAM, port_map.params)
    assert want is not None and abs(want - 2.0) < 0.1
    assert abs(got - want) <= 1e-4 * want
    # the fit itself, from the true marker pose scaled into the map
    kf_pose, corners = port_map.h("kf_pose"), port_map.h("kf_mk_corners")
    g2m = ref_seq._marker_detector.poses[100].copy()
    g2m[:3, 3] *= 0.5
    valid = np.arange(8) < 4
    poses = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
    poses[:4] = kf_pose[:4]
    c = np.zeros((8, 4, 2), np.float32)
    c[:4] = corners[:4, 0]
    w_g2m, w_size, w_rms = (np.asarray(a) for a in ref_mm._fit_marker_pose_size(
        jnp.asarray(poses), jnp.asarray(c), jnp.asarray(valid), REF_CAM, jnp.asarray(g2m), jnp.float32(0.5)))
    g_g2m, g_size, g_rms = (a.numpy() for a in markermap._fit_marker_pose_size(
        torch.from_numpy(poses), torch.from_numpy(c), torch.from_numpy(valid), CAM, torch.from_numpy(g2m),
        torch.tensor(0.5)))
    assert abs(float(w_size) - 0.25) < 0.01
    assert np.abs(g_g2m - w_g2m).max() < 1e-4
    assert abs(float(g_size) - float(w_size)) < 1e-4 * float(w_size)
    assert abs(float(g_rms) - float(w_rms)) < 1e-4


@pytest.mark.parametrize("frame_index", [9, 24])
def test_best_pose_from_valid_markers_equals_reference(frame_index):
    ref_seq, ref_map, port_map, _ = _maps()
    ref_mm.update_marker_poses(ref_map, REF_CAM, MAP_PARAMS)
    markermap.update_marker_poses(port_map, CAM, port_map.params)
    rm = ref_seq.frame(frame_index).markers
    want = ref_mm.best_pose_from_valid_markers(ref_map, rm, REF_CAM)
    got = markermap.best_pose_from_valid_markers(port_map, markers_from_numpy(rm), CAM)
    assert want is not None and got is not None
    assert np.abs(got - want).max() < 1e-4
    centre = -want[:3, :3].T @ want[:3, 3]
    gt = ref_seq.gt_pose(frame_index)
    assert np.linalg.norm(centre + gt[:3, :3].T @ gt[:3, 3]) < 0.1


def test_ippe_is_stable_under_rounding_size_corner_noise():
    """IPPE computes in float64: on the seed-13 scene's oracle markers
    (frames 0 and 9, one far marker among them), 1e-4 px of corner noise
    moves no pose by more than 2e-4. In float32 the polish's normal
    equations turned the same noise into a far larger move of the far
    marker's pose.
    (err_ratio is not held here: 1e-4 px is 1e-3 of the smallest corner
    error, so the ratio itself moves by that much.)"""
    seq = SyntheticSequence(n_frames=30, seed=13, n_markers=3, marker_size=0.5)
    frames = [seq.frame(i, device="cpu").markers for i in (0, 9)]
    corners = torch.from_numpy(np.stack([m.und_corners for m in frames]))
    valid = torch.from_numpy(np.stack([m.valid for m in frames]))
    sizes = torch.full((2, 16), 0.5)
    noise = torch.from_numpy(np.random.default_rng(5).normal(0.0, 1e-4, corners.shape).astype(np.float32))
    base = ippe_square_poses(corners, sizes, seq.cam)
    moved = ippe_square_poses(corners + noise, sizes, seq.cam)
    assert int(valid.sum()) >= 6 and base[0].dtype == torch.float32
    assert float((moved[0] - base[0])[valid].abs().max()) < 2e-4
