"""The port's marker init and marker fallback against the JAX package, on the
same seeded inputs:

- `marker_metric_scale` and the two-frame `initialize_from_markers` on the
  oracle frames (0, k) of the seed-13 scene (3 markers of 0.5 m): the same
  marker index, the metric baseline within 1e-4 relative, the marker's and
  the current camera's poses within 1e-4, the same marker slots and
  observations;
- `System._apply_marker_scale` (the hybrid init: keypoint geometry, marker
  scale): the reference's map just before its rescale is saved and loaded
  by the port, and both rescale it from the same frames: the scale within
  1e-4 relative, points within 1e-4 of their distance from the origin,
  keyframe and marker poses within 1e-4, the same marker bookkeeping;
- the marker fallback: both packages read one checkpoint of the reference's
  session after 15 frames of the seed-15 scene, then run frames 15-24 with
  the keypoints of 15-19 removed: the same frames posed, poses within 1e-4,
  the same keyframe count.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ucoslam_tpu.api import UcoSlam as RefSlam
from ucoslam_tpu.config import Params as RefParams
from ucoslam_tpu.io.serialize import save_map as ref_save_map
from ucoslam_tpu.io.synthetic import SyntheticSequence as RefSequence
from ucoslam_tpu.mapping.map import Map as RefMap
from ucoslam_tpu.slam import System as RefSystem
from ucoslam_tpu.slam.initializer import MapInitializer as RefInitializer
from ucoslam_tpu_torch.api import UcoSlam
from ucoslam_tpu_torch.config import Params
from ucoslam_tpu_torch.io.serialize import load_map
from ucoslam_tpu_torch.io.synthetic import SyntheticSequence
from ucoslam_tpu_torch.mapping.map import Map
from ucoslam_tpu_torch.slam.initializer import MapInitializer
from ucoslam_tpu_torch.slam.system import System

torch.set_num_threads(2)

PARAMS = Params().replace(maxMapPoints=4096, maxKeyFrames=32, maxKeyPointsPerFrame=512, maxDescDistance=60.0,
                          aruco_markerSize=0.5)
REF_PARAMS = RefParams.from_dict(PARAMS.to_dict())
SCENE13 = dict(n_frames=30, seed=13, n_markers=3, marker_size=0.5)
MARKER_KEYS = ("mk_id", "mk_pose_valid", "kf_mk_slot")


@pytest.fixture(scope="module")
def scene13():
    return SyntheticSequence(**SCENE13), RefSequence(**SCENE13)


@pytest.mark.parametrize("k", [1, 5, 10])
def test_marker_metric_scale_and_two_frame_init(scene13, k):
    seq, ref_seq = scene13
    f0, fk = seq.frame(0, device="cpu"), seq.frame(k, device="cpu")
    r0, rk = ref_seq.frame(0), ref_seq.frame(k)
    got = MapInitializer(PARAMS, seq.cam).marker_metric_scale(f0.markers, fk.markers)
    want = RefInitializer(REF_PARAMS, ref_seq.cam).marker_metric_scale(r0.markers, rk.markers)
    assert got is not None and want is not None
    assert got[1] == want[1]
    assert abs(got[0] - want[0]) <= 1e-4 * want[0]
    assert np.abs(got[2] - want[2]).max() < 1e-4

    init = MapInitializer(PARAMS, seq.cam)
    init.set_reference_frame(f0)
    world_map = Map(PARAMS, device="cpu")
    ok, cur = init.initialize_from_markers(fk, world_map)
    ref_init = RefInitializer(REF_PARAMS, ref_seq.cam)
    ref_init.set_reference_frame(r0)
    ref_map = RefMap(REF_PARAMS)
    ref_ok, ref_cur = ref_init.initialize_from_markers(rk, ref_map)
    assert ok and ref_ok
    assert np.abs(cur.pose_f2g.numpy() - np.asarray(ref_cur.pose_f2g)).max() < 1e-4
    assert world_map.n_keyframes == ref_map.n_keyframes == 2
    st = ref_map.state
    for key in MARKER_KEYS:
        np.testing.assert_array_equal(world_map.h(key), np.asarray(getattr(st, key)), err_msg=key)
    for key in ("mk_pose", "kf_pose"):
        assert np.abs(world_map.h(key) - np.asarray(getattr(st, key))).max() < 1e-4, key


def test_apply_marker_scale_equals_reference(scene13, tmp_path):
    seq, ref_seq = scene13
    ref = RefSystem(REF_PARAMS, ref_seq.cam)
    seen = {}
    rescale = ref._apply_marker_scale

    def spy(ref_markers, cur):
        ref_save_map(ref.map, str(tmp_path / "pre_scale.slm"))
        seen["pose_in"] = np.asarray(cur.pose_f2g)
        out = rescale(ref_markers, cur)
        seen["pose_out"] = np.asarray(out.pose_f2g)
        return out

    ref._apply_marker_scale = spy
    for i in range(seq.n_frames):
        if ref.process_frame(ref_seq.frame(i)) is not None:
            break
    assert "pose_out" in seen, "the reference did not take the hybrid init"
    port = System(PARAMS, seq.cam, load_map(str(tmp_path / "pre_scale.slm"), "cpu"), device="cpu")
    kf_fseq = port.map.h("kf_fseq")[port.map.keyframes.active_slots()]
    ref_i, cur_i = int(kf_fseq[0]), int(kf_fseq[1])
    assert cur_i == i
    cur = seq.frame(cur_i, device="cpu").replace(pose_f2g=torch.from_numpy(seen["pose_in"].copy()))
    out = port._apply_marker_scale(seq.frame(ref_i, device="cpu").markers, cur)

    base_in = np.linalg.norm(seen["pose_in"][:3, 3])
    s_port = np.linalg.norm(out.pose_f2g.numpy()[:3, 3]) / base_in
    s_ref = np.linalg.norm(seen["pose_out"][:3, 3]) / base_in
    assert s_ref != 1.0 and abs(s_port - s_ref) <= 1e-4 * s_ref
    assert np.abs(out.pose_f2g.numpy() - seen["pose_out"]).max() < 1e-4
    assert port.manager.metric_locked and ref.manager.metric_locked
    st = ref.map.state
    ref_pos, pos = np.asarray(st.pt_pos), port.map.h("pt_pos")
    assert (np.linalg.norm(pos - ref_pos, axis=1) <= 1e-4 * np.maximum(np.linalg.norm(ref_pos, axis=1), 1.0)).all()
    for key in MARKER_KEYS:
        np.testing.assert_array_equal(port.map.h(key), np.asarray(getattr(st, key)), err_msg=key)
    for key in ("mk_pose", "kf_pose", "kf_mk_corners"):
        assert np.abs(port.map.h(key) - np.asarray(getattr(st, key))).max() < 1e-4, key


def test_marker_fallback_equals_reference(tmp_path):
    kw = dict(n_frames=25, seed=15, n_markers=3, marker_size=0.5)
    seq, ref_seq = SyntheticSequence(**kw), RefSequence(**kw)
    strip = set(range(15, 20))
    path = str(tmp_path / "after15.slm")
    ref = RefSlam()
    ref.setParams(None, REF_PARAMS, ref_seq.cam)
    for i in range(15):
        ref.process_frame(ref_seq.frame(i))
    ref.saveToFile(path)
    want = {}
    for i in range(15, seq.n_frames):
        f = ref_seq.frame(i)
        if i in strip:
            f = f._replace(valid=jnp.zeros_like(f.valid))
        pose = ref.process_frame(f)
        if pose is not None:
            want[i] = np.asarray(pose)
    port = UcoSlam(device="cpu")
    port.readFromFile(path, seq.cam)
    got = {}
    for i in range(15, seq.n_frames):
        f = seq.frame(i, device="cpu")
        if i in strip:
            f = f.replace(valid=torch.zeros_like(f.valid))
        pose = port.process_frame(f)
        if pose is not None:
            got[i] = pose
    assert sorted(got) == sorted(want)
    assert strip <= set(got)
    assert port._system.n_marker_poses == len(strip)  # every stripped frame took the marker fallback
    for i in got:
        assert np.abs(got[i] - want[i]).max() < 1e-4, i
    assert port.map.n_keyframes == ref.map.n_keyframes
