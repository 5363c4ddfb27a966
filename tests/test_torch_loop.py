"""The port's loop closure against the JAX package, on the CPU.

- `geometry/sim3` exp / log / inverse on the same tangents: within 1e-5;
- `optim/posegraph.pose_graph_solve` on tests/test_posegraph.py's ring and
  scale-drift problems: poses within 1e-4;
- `Map.essential_graph` on the drifted ring map of tests/test_loopclosure.py:
  equal edge lists;
- `LoopDetector.detect_from_keypoints` -> `correct_map` on that map, with
  the reference's own RANSAC draws handed to the port: the same loop, the
  expected pose and every keyframe pose within 1e-3, the same point count
  after the seam fusion; then `global_bundle_adjustment` settles the
  merged geometry, with the reference test's gate (chi2 under half the
  merged map's, or under 6). (The two packages' global BA on this poorly
  conditioned map part by ~5% in chi2; tests/test_torch_ba.py holds them
  within 1% on a map SLAM built.) Through the mapper
  (`MapManager._detect_and_close_loop`) both packages close the loop once
  and keep the same points;
- `LoopDetector.detect_from_markers` on the ring map with a marker of known
  pose seen by keyframe 0 and by the returning keyframe
  (chip_smoke.ring_marker): the same loop against keyframe 0, the expected
  pose within 1e-4 of the reference's and 0.05 of the truth, then
  `correct_map` on both, keyframe poses within 1e-3, the drift reduced.

The ring map is built once, by chip_smoke.ring_loop_scene (numpy and the
port's se3_exp, the reference test's draws in its order), and loaded into
both packages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from tests.test_posegraph import ring_problem
from ucoslam_tpu.config import Params
from ucoslam_tpu.geometry import sim3 as ref_sim3
from ucoslam_tpu.geometry.camera import CameraParams as RefCamera
from ucoslam_tpu.mapping import Map as RefMap
from ucoslam_tpu.mapping.frame import empty_frame as ref_empty_frame
from ucoslam_tpu.mapping.kfdatabase import KeyFrameDataBase as RefKFDB
from ucoslam_tpu.markers.ippe import ippe_square_poses as ref_ippe
from ucoslam_tpu.mapping.frame import empty_markers as ref_empty_markers
from ucoslam_tpu.optim.posegraph import pose_graph_solve as ref_pose_graph_solve
from ucoslam_tpu.slam.loopclosure import LoopDetector as RefLoopDetector
from ucoslam_tpu.slam.markermap import record_marker_observations as ref_record
from ucoslam_tpu.slam.mapmanager import MapManager as RefMapManager
from ucoslam_tpu_torch.config import Params as PortParams
from ucoslam_tpu_torch.geometry import sim3
from ucoslam_tpu_torch.optim import posegraph
from ucoslam_tpu_torch.optim.ba import global_bundle_adjustment
from ucoslam_tpu_torch.slam.mapmanager import MapManager

torch.set_num_threads(2)

PARAMS = Params().replace(
    maxMapPoints=2048, maxKeyFrames=16, maxKeyPointsPerFrame=256, maxDescDistance=60.0,
    detectMarkers=False, KFMinConfidence=0.4,
)


def ref_draw(key):
    """The port's `draw` giving the reference's rows: its detector splits
    its key once a query, then once per (padded) candidate, then once per
    hypothesis, and draws 6 rows by categorical over the valid ones."""
    keys = jax.random.split(key, 5)

    def draw(valid, n_hyp):
        out = []
        for c, v in enumerate(valid):
            logits = jnp.where(jnp.asarray(v), 0.0, -1e9)
            hk = jax.random.split(keys[c], n_hyp)
            out.append(np.asarray(jax.vmap(lambda k: jax.random.categorical(k, logits, shape=(6,)))(hk)))
        return np.stack(out).astype(np.int64)

    return draw


def test_sim3_exp_log_inverse():
    rng = np.random.default_rng(5)
    z = rng.normal(0, 0.5, (24, 7)).astype(np.float32)
    z[:6, 3:6] *= 1e-6  # the small-angle branch
    z[6:10, 6] *= 1e-7  # the small-scale branch
    T_ref = np.asarray(ref_sim3.sim3_exp(jnp.asarray(z)))
    T = sim3.sim3_exp(torch.from_numpy(z))
    np.testing.assert_allclose(T.numpy(), T_ref, atol=1e-5)
    Tt = torch.from_numpy(T_ref.copy())
    np.testing.assert_allclose(sim3.sim3_log(Tt).numpy(), np.asarray(ref_sim3.sim3_log(jnp.asarray(T_ref))), atol=1e-5)
    np.testing.assert_allclose(sim3.sim3_inverse(Tt).numpy(), np.asarray(ref_sim3.sim3_inverse(jnp.asarray(T_ref))),
                               atol=1e-5)


@pytest.mark.parametrize("scale_drift", [1.0, 1.03])
def test_pose_graph_solve(scale_drift):
    problem, _, _ = ring_problem(scale_drift=scale_drift)
    want = np.asarray(ref_pose_graph_solve(problem, iters=25))
    port = posegraph.PoseGraphProblem(*(torch.from_numpy(np.array(x)) for x in problem))
    got = posegraph.pose_graph_solve(port, iters=25)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def ref_ring_map(scene):
    """The reference's Map, database and detector over the same scene."""
    cam = RefCamera.create(500.0, 500.0, 320.0, 240.0)
    m = RefMap(PARAMS)
    n = m.state.N
    slots = m.add_points(scene["pts"], scene["normals"], scene["descs"], scene["min_dist"], scene["max_dist"],
                         np.zeros(len(scene["pts"]), np.int32), 0)

    def frame(uv, desc, ids, pose, fseq):
        k = len(uv)
        pad = lambda a, fill=0: np.concatenate([a, np.full((n - k,) + a.shape[1:], fill, a.dtype)])
        return ref_empty_frame(n)._replace(
            fseq=jnp.int32(fseq), und_xy=jnp.asarray(pad(uv)), desc=jnp.asarray(pad(desc)),
            valid=jnp.asarray(np.arange(n) < k), ids=jnp.asarray(pad(ids.astype(np.int32), -1)),
            pose_f2g=jnp.asarray(pose),
        )

    for kf in scene["kfs"]:
        m.add_keyframe(frame(kf["uv"], scene["descs"][kf["obs"]], slots[kf["obs"]], kf["pose"], kf["fseq"]))
    kfdb = RefKFDB(PARAMS.maxKeyFrames)
    st = m.state
    for s in range(len(scene["kfs"])):
        kfdb.add(s, st.kf_desc[s], st.kf_kpt_valid[s])
    lp = scene["loop"]
    dup = m.add_points(lp["dup"], lp["dup_normals"], lp["desc"], lp["dup_min_dist"], lp["dup_max_dist"],
                       np.zeros(len(lp["dup"]), np.int32), 0)
    f = frame(lp["uv"], lp["desc"], dup, lp["pose"], lp["fseq"])
    kf_slot = m.add_keyframe(f)
    kfdb.add(kf_slot, f.desc, f.valid)
    return m, RefLoopDetector(PARAMS, cam, kfdb), kf_slot, f, cam


@pytest.fixture(scope="module")
def ring():
    scene = chip_smoke.ring_loop_scene()
    m_ref, det_ref, slot_ref, f_ref, cam_ref = ref_ring_map(scene)
    m, det, slot, f = chip_smoke.ring_loop_map(scene, PortParams.from_dict(PARAMS.to_dict()), "cpu")
    assert slot == slot_ref
    return scene, (m_ref, det_ref, f_ref, cam_ref), (m, det, f), slot


def test_essential_graph(ring):
    _, (m_ref, *_), (m, *_), _ = ring
    want = m_ref.essential_graph()
    assert len(want) >= 10  # a tree over the 11 keyframes at least
    assert m.essential_graph() == want


def test_detect_correct_and_global_ba(ring):
    scene, (m_ref, det_ref, f_ref, cam_ref), (m, det, f), slot = ring
    _, sub = jax.random.split(det_ref._key)  # the key the reference's query will use
    det._draw = ref_draw(sub)
    info_ref = det_ref.detect_from_keypoints(m_ref, slot, f_ref)
    info = det.detect_from_keypoints(m, slot, f)
    assert info_ref.found and info.found
    assert info.matched_kf == info_ref.matched_kf == 0
    assert abs(info.n_matches - info_ref.n_matches) <= 1
    np.testing.assert_allclose(info.expected_pose, info_ref.expected_pose, atol=1e-3)
    assert np.linalg.norm(info.expected_pose - scene["true_poses"][0]) < 0.05

    n_before = m.n_points
    assert det_ref.correct_map(m_ref, info_ref) and det.correct_map(m, info)
    kfs = m.keyframes.active_slots()
    np.testing.assert_allclose(m.h("kf_pose")[kfs], np.asarray(m_ref.state.kf_pose)[kfs], atol=1e-3)
    assert m.n_points == m_ref.n_points <= n_before - 30  # the seam's duplicates fused
    drift = [np.linalg.norm(p - scene["true_poses"][9]) for p in (scene["drift_poses"][9], m.h("kf_pose")[9])]
    assert drift[1] < drift[0]
    m.check_consistency()

    chi_merged = m.global_reproj_chi2(det.cam)
    global_bundle_adjustment(m, det.cam, n_iters=15)
    chi = m.global_reproj_chi2(det.cam)
    assert np.isfinite(chi) and chi < max(0.5 * chi_merged, 6.0), (chi_merged, chi)


def test_detect_and_close_loop_through_the_mapper():
    scene = chip_smoke.ring_loop_scene()
    m_ref, det_ref, slot, f_ref, cam_ref = ref_ring_map(scene)
    port_params = PortParams.from_dict(PARAMS.to_dict())
    m, det, _, f = chip_smoke.ring_loop_map(scene, port_params, "cpu")
    ref_mgr = RefMapManager(PARAMS, cam_ref, kfdb=det_ref.kfdb)
    mgr = MapManager(port_params, det.cam, kfdb=det.kfdb, device="cpu")
    _, sub = jax.random.split(ref_mgr.loop_detector._key)
    mgr.loop_detector._draw = ref_draw(sub)
    ref_mgr._detect_and_close_loop(m_ref, slot, f_ref)
    mgr._detect_and_close_loop(m, slot, f)
    assert mgr.loop_closures == ref_mgr.loop_closures == 1
    assert m.n_points == m_ref.n_points
    m.check_consistency()


def ref_add_ring_marker(m, marker, kf_slot, f, cam):
    """chip_smoke.add_ring_marker for the reference's map."""
    st = m.state
    slot = m.markers.alloc()
    m.state = st._replace(
        mk_id=st.mk_id.at[slot].set(marker["id"]), mk_active=st.mk_active.at[slot].set(True),
        mk_size=st.mk_size.at[slot].set(marker["size"]), mk_pose=st.mk_pose.at[slot].set(jnp.asarray(marker["g2m"])),
        mk_pose_valid=st.mk_pose_valid.at[slot].set(True),
    )
    slots = np.full(16, -1, np.int32)
    slots[0] = slot
    for kf, key in ((0, "corners_kf0"), (kf_slot, "corners_loop")):
        corners = np.zeros((16, 4, 2), np.float32)
        corners[0] = marker[key]
        p1, p2, e1, e2 = (np.asarray(a) for a in ref_ippe(jnp.asarray(corners), jnp.full(16, marker["size"]), cam))
        valid = np.arange(16) < 1
        fm = ref_empty_markers()._replace(
            id=np.where(valid, marker["id"], -1).astype(np.int32), corners=corners, und_corners=corners,
            pose1=p1, pose2=p2, err_ratio=np.where(valid, e2 / np.clip(e1, 1e-9, None), 0.0).astype(np.float32),
            valid=valid,
        )
        ref_record(m, kf, fm, slots)
    return f._replace(markers=fm)


def test_detect_from_markers_and_correct(ring):
    scene, (m_ref, det_ref, f_ref, cam_ref), (m, det, f), slot = ring
    marker = chip_smoke.ring_marker(scene)
    # a fresh copy of each map: the ring fixture's maps are shared
    m_ref2, det_ref2, _, f_ref2, _ = ref_ring_map(scene)
    m2, det2, _, f2 = chip_smoke.ring_loop_map(scene, PortParams.from_dict(PARAMS.to_dict()), "cpu")
    f_ref2 = ref_add_ring_marker(m_ref2, marker, slot, f_ref2, cam_ref)
    f2 = chip_smoke.add_ring_marker(m2, marker, slot, f2, det2.cam)
    info_ref = det_ref2.detect_from_markers(m_ref2, slot, f_ref2)
    info = det2.detect_from_markers(m2, slot, f2)
    assert info_ref.found and info.found
    assert info.matched_kf == info_ref.matched_kf == 0
    assert info.n_matches == info_ref.n_matches == 4
    np.testing.assert_allclose(info.expected_pose, info_ref.expected_pose, atol=1e-4)
    assert np.abs(info.expected_pose - scene["true_poses"][0]).max() < 0.05
    assert det_ref2.correct_map(m_ref2, info_ref) and det2.correct_map(m2, info)
    kfs = m2.keyframes.active_slots()
    np.testing.assert_allclose(m2.h("kf_pose")[kfs], np.asarray(m_ref2.state.kf_pose)[kfs], atol=1e-3)
    drift = [np.linalg.norm(p - scene["true_poses"][9]) for p in (scene["drift_poses"][9], m2.h("kf_pose")[9])]
    assert drift[1] < drift[0]
