"""The port's MapState ops against the reference's, exactly, on a seeded
state: insertion, removal, observation counts, covisibility, the point
statistics (one point observed twice by one keyframe; descriptors compared
as uint32, normals and bounds within 1e-6), growth and scale."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucoslam_tpu.config import Params
from ucoslam_tpu.mapping import map as ref_map
from ucoslam_tpu.mapping.frame import empty_frame as ref_empty_frame
from ucoslam_tpu_torch.config import Params as PortParams
from ucoslam_tpu_torch.geometry.se3 import se3_exp
from ucoslam_tpu_torch.mapping import map as port_map
from ucoslam_tpu_torch.mapping.frame import frame_from_numpy

torch.set_num_threads(2)

PARAMS = Params().replace(maxMapPoints=512, maxKeyFrames=8, maxKeyPointsPerFrame=64, detectMarkers=False)
P, K, N = 512, 8, 64


def _seeded_state(seed=0):
    """A reference MapState with random content: 70% of the points and 6 of
    8 keyframes active, observations of active points only, and keyframe 1
    observing one point twice."""
    rng = np.random.default_rng(seed)
    st = ref_map.empty_map_state(PARAMS)
    pt_active = rng.random(P) < 0.7
    alive = np.nonzero(pt_active)[0]
    kf_active = np.zeros(K, bool)
    kf_active[[0, 1, 2, 4, 5, 7]] = True
    xi = np.c_[rng.normal(0, 0.5, (K, 3)), rng.normal(0, 0.2, (K, 3))].astype(np.float32)
    ids = np.where(rng.random((K, N)) < 0.7, rng.choice(alive, (K, N)), -1).astype(np.int32)
    ids[~kf_active] = -1
    ids[1, 5] = ids[1, 9] = alive[3]
    normal = rng.normal(0, 1, (P, 3)).astype(np.float32)
    arrays = dict(
        pt_pos=np.c_[rng.uniform(-3, 3, (P, 2)), rng.uniform(2, 8, P)].astype(np.float32),
        pt_normal=normal / np.linalg.norm(normal, axis=1, keepdims=True),
        pt_desc=rng.integers(0, 2**32, (P, 8), dtype=np.uint32),
        pt_min_dist=rng.uniform(0.5, 1.0, P).astype(np.float32),
        pt_max_dist=rng.uniform(5, 9, P).astype(np.float32),
        pt_n_seen=rng.integers(1, 5, P).astype(np.int32),
        pt_n_visible=rng.integers(5, 9, P).astype(np.int32),
        pt_creation_kf=rng.integers(0, 4, P).astype(np.int32),
        pt_active=pt_active,
        kf_pose=se3_exp(torch.from_numpy(xi)).numpy(),
        kf_fseq=rng.permutation(40)[:K].astype(np.int32),
        kf_active=kf_active,
        kf_xy=rng.uniform([0, 0], [640, 480], (K, N, 2)).astype(np.float32),
        kf_octave=rng.integers(0, 8, (K, N)).astype(np.int32),
        kf_desc=rng.integers(0, 2**32, (K, N, 8), dtype=np.uint32),
        kf_kpt_valid=(rng.random((K, N)) < 0.9) & kf_active[:, None],
        kf_ids=ids,
    )
    return st._replace(**{k: jnp.asarray(v) for k, v in arrays.items()})


def _port(st):
    return port_map.map_state_from_numpy({k: np.asarray(v) for k, v in st._asdict().items()}, "cpu")


def _assert_states(got, want, close=(), rtol=0.0):
    got = port_map.map_state_to_numpy(got)
    for k, w in want._asdict().items():
        w = np.asarray(w)
        assert got[k].dtype == w.dtype, k
        if k in close:
            np.testing.assert_allclose(got[k], w, rtol=rtol, atol=rtol, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.fixture(scope="module")
def state():
    return _seeded_state()


def _frame_arrays(seed):
    rng = np.random.default_rng(seed)
    return dict(
        fseq=np.int32(77), xy=rng.uniform(0, 400, (N, 2)).astype(np.float32),
        und_xy=rng.uniform(0, 400, (N, 2)).astype(np.float32),
        octave=rng.integers(0, 8, N).astype(np.int32), angle=np.zeros(N, np.float32),
        response=np.zeros(N, np.float32), desc=rng.integers(0, 2**32, (N, 8), dtype=np.uint32),
        depth=np.zeros(N, np.float32), valid=rng.random(N) < 0.8,
        ids=np.where(rng.random(N) < 0.5, rng.integers(0, P, N), -1).astype(np.int32),
        pose_f2g=se3_exp(torch.tensor([0.1, 0.2, -0.1, 0.05, 0.0, 0.1])).numpy(),
    )


def test_add_keyframe_equals_reference(state):
    a = _frame_arrays(1)
    ref_frame = ref_empty_frame(N)._replace(**{k: jnp.asarray(v) for k, v in a.items()})
    want = ref_map.op_add_keyframe(state, jnp.int32(3), ref_frame)
    got = port_map.op_add_keyframe(_port(state), 3, frame_from_numpy(a, "cpu"))
    _assert_states(got, want)


def test_add_points_and_observations_equal_reference(state):
    rng = np.random.default_rng(2)
    free = np.nonzero(~np.asarray(state.pt_active))[0]
    B = 40
    use = rng.random(B) < 0.75
    slots = np.where(use, free[:B], 0).astype(np.int32)
    rows = dict(
        pos=rng.normal(0, 2, (B, 3)).astype(np.float32), normal=rng.normal(0, 1, (B, 3)).astype(np.float32),
        desc=rng.integers(0, 2**32, (B, 8), dtype=np.uint32), min_dist=rng.uniform(0, 1, B).astype(np.float32),
        max_dist=rng.uniform(2, 9, B).astype(np.float32), flags=rng.integers(0, 4, B).astype(np.int32),
    )
    want = ref_map.op_add_points(state, jnp.asarray(slots), jnp.asarray(use),
                                 *(jnp.asarray(v) for v in rows.values()), jnp.int32(6))
    t = {k: port_map.tensor_from_numpy(v, "cpu") for k, v in rows.items()}
    got = port_map.op_add_points(_port(state), torch.from_numpy(slots), torch.from_numpy(use), *t.values(), 6)
    _assert_states(got, want)

    # keypoint 0 stays unassigned: the reference routes its -1 rows to
    # keypoint 0 with the old value, and a duplicate scatter there keeps
    # whichever write lands last (the port writes the real rows only)
    kpt = np.where(rng.random(B) < 0.8, 1 + rng.permutation(N - 1)[:B], -1).astype(np.int32)
    pid = free[:B].astype(np.int32)
    want = ref_map.op_set_observations(want, jnp.int32(2), jnp.asarray(kpt), jnp.asarray(pid))
    got = port_map.op_set_observations(got, 2, torch.from_numpy(kpt), torch.from_numpy(pid))
    _assert_states(got, want)


def test_remove_points_and_keyframes_equal_reference(state):
    rng = np.random.default_rng(3)
    mask = rng.random(P) < 0.2
    want = ref_map.op_remove_points(state, jnp.asarray(mask))
    got = port_map.op_remove_points(_port(state), torch.from_numpy(mask))
    _assert_states(got, want)
    kmask = np.zeros(K, bool)
    kmask[[1, 5]] = True
    want = ref_map.op_remove_keyframes(want, jnp.asarray(kmask))
    got = port_map.op_remove_keyframes(got, torch.from_numpy(kmask))
    _assert_states(got, want)


def test_counts_and_covisibility_equal_reference(state):
    st = _port(state)
    np.testing.assert_array_equal(port_map.op_point_observation_counts(st).numpy(),
                                  np.asarray(ref_map.op_point_observation_counts(state)))
    covis = port_map.op_covis_matrix(st).numpy()
    np.testing.assert_array_equal(covis, np.asarray(ref_map.op_covis_matrix(state)))
    assert covis.max() > 0


def test_update_point_stats_equals_reference(state):
    want = ref_map.op_update_point_stats(state, jnp.float32(1.2), jnp.int32(8))
    got = port_map.op_update_point_stats(_port(state), 1.2, 8)
    _assert_states(got, want, close=("pt_normal", "pt_min_dist", "pt_max_dist"), rtol=1e-6)
    # keyframe 1 holds one point twice: its descriptor is the unsigned
    # word-wise maximum of the two observations, when keyframe 1 is the
    # point's most recent observer
    p = int(np.asarray(state.kf_ids)[1, 5])
    desc = port_map.map_state_to_numpy(got)["pt_desc"][p]
    np.testing.assert_array_equal(desc, np.asarray(want.pt_desc)[p])


def test_update_point_stats_unsigned_max():
    """Two observations of one point from its latest keyframe: the
    descriptor words take the unsigned maximum (bits above 2^31 included)."""
    st = _seeded_state(1)
    kf_fseq = np.asarray(st.kf_fseq).copy()
    kf_fseq[1] = 1000  # keyframe 1 is every point's most recent observer
    kf_desc = np.asarray(st.kf_desc).copy()
    kf_desc[1, 5] = np.array([0x80000000, 1, 0xFFFFFFFF, 0, 5, 0x7FFFFFFF, 0x80000001, 2], np.uint32)
    kf_desc[1, 9] = np.array([0x7FFFFFFF, 2, 0x00000001, 1, 4, 0x80000000, 0x80000000, 3], np.uint32)
    st = st._replace(kf_fseq=jnp.asarray(kf_fseq), kf_desc=jnp.asarray(kf_desc))
    want = ref_map.op_update_point_stats(st, jnp.float32(1.2), jnp.int32(8))
    got = port_map.op_update_point_stats(_port(st), 1.2, 8)
    p = int(np.asarray(st.kf_ids)[1, 5])
    desc = port_map.map_state_to_numpy(got)["pt_desc"][p]
    np.testing.assert_array_equal(desc, np.maximum(kf_desc[1, 5], kf_desc[1, 9]))
    np.testing.assert_array_equal(desc, np.asarray(want.pt_desc)[p])


def test_scale_equals_reference(state):
    want = ref_map.op_scale_map(state, jnp.float32(1.7))
    got = port_map.op_scale_map(_port(state), 1.7)
    _assert_states(got, want)


def _maps(state):
    ref = ref_map.Map(PARAMS)
    ref.state = state
    ref.points.sync_from_mask(np.asarray(state.pt_active))
    ref.keyframes.sync_from_mask(np.asarray(state.kf_active))
    port = port_map.Map(PortParams.from_dict(PARAMS.to_dict()), _port(state))
    port.points.sync_from_mask(np.asarray(state.pt_active))
    port.keyframes.sync_from_mask(np.asarray(state.kf_active))
    return ref, port


def test_map_growth_equals_reference(state):
    ref, port = _maps(state)
    assert port.grow_points() == ref.grow_points() == 2 * P
    assert port.grow_keyframes(12) == ref.grow_keyframes(12) == 12
    _assert_states(port.state, ref.state)
    assert port.params.to_dict() == ref.params.to_dict()
    assert port.signature() == ref.signature()


def test_map_queries_equal_reference(state):
    ref, port = _maps(state)
    ref.check_consistency()
    port.check_consistency()
    for s in (0, 1, 4):
        assert port.frame_median_depth(s) == ref.frame_median_depth(s)
    np.testing.assert_array_equal(port.covis_matrix(), ref.covis_matrix())
    np.testing.assert_array_equal(port.point_observation_counts(), ref.point_observation_counts())
    # Map-level mutations keep the arenas and the signature in step
    ref.remove_keyframes([2])
    port.remove_keyframes([2])
    ref.remove_points(np.arange(0, P, 7))
    port.remove_points(np.arange(0, P, 7))
    slots_r = ref.add_points(np.ones((5, 3)), np.ones((5, 3)), np.ones((5, 8), np.uint32),
                             np.ones(5), np.ones(5), np.zeros(5, np.int32), creation_kf=3)
    slots_p = port.add_points(np.ones((5, 3)), np.ones((5, 3)), np.ones((5, 8), np.uint32),
                              np.ones(5), np.ones(5), np.zeros(5, np.int32), creation_kf=3)
    np.testing.assert_array_equal(slots_p, slots_r)
    _assert_states(port.state, ref.state)
    assert port.signature() == ref.signature()
    port.check_consistency()
