"""The port's candidate-keyframe verification and word-aligned matching
against the JAX package, on the CPU: `match_keyframe_points_pnp_batch` over the drifted ring map of
tests/test_torch_loop.py, for the returning camera's frame against five
candidates (two that see its points, three that do not), with the
reference's own RANSAC draws handed across: the same match counts and `ok`
flags, inlier counts within 1 and verified poses within 1e-3. The port's
batch is the five real candidates, one batched refine. And
`match_frames_bow` on two oracle frames of one scene: equal matches."""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_loop import PARAMS, ref_draw, ref_ring_map
from ucoslam_tpu.io import SyntheticSequence as RefSequence
from ucoslam_tpu.mapping.kfdatabase import make_vocabulary
from ucoslam_tpu.matching.kfmatch import match_keyframe_points_pnp_batch as ref_batch
from ucoslam_tpu.matching.matcher import match_frames_bow as ref_match_frames_bow
from ucoslam_tpu_torch.config import Params as PortParams
from ucoslam_tpu_torch.mapping.frame import frame_from_numpy
from ucoslam_tpu_torch.matching.kfmatch import match_keyframe_points_pnp, match_keyframe_points_pnp_batch
from ucoslam_tpu_torch.matching.matcher import match_frames_bow

torch.set_num_threads(2)


@pytest.mark.parametrize("cands,seed", [([0, 1, 9, 5, 3], 11), ([1, 0], 12)])
def test_batch_matches_reference(cands, seed):
    scene = chip_smoke.ring_loop_scene()
    m_ref, det_ref, _, f_ref, cam_ref = ref_ring_map(scene)
    m, det, _, f = chip_smoke.ring_loop_map(scene, PortParams.from_dict(PARAMS.to_dict()), "cpu")
    key = jax.random.PRNGKey(seed)
    want = ref_batch(m_ref, f_ref, cands, cam_ref, PARAMS, key)
    got = match_keyframe_points_pnp_batch(m, f, cands, det.cam, det.params, ref_draw(key))
    assert [c.n_matches for c in got] == [c.n_matches for c in want]
    assert [c.ok for c in got] == [c.ok for c in want]
    assert want[0].ok and want[1].ok  # keyframes 0 and 1 see the frame's points
    assert not any(c.ok for c in want[2:])
    for g, w in zip(got, want):
        assert abs(g.n_inliers - w.n_inliers) <= 1
        if w.ok:
            np.testing.assert_allclose(g.pose_f2g, w.pose_f2g, atol=1e-3)
    # one candidate alone: the batch of one, the same verdict
    one = match_keyframe_points_pnp(m, f, cands[0], det.cam, det.params, lambda v, h: ref_draw(key)(v, h))
    assert one.ok == want[0].ok and one.n_matches == want[0].n_matches


def test_match_frames_bow_equals_reference():
    seq = RefSequence(n_frames=20, seed=7)
    f1, f2 = seq.frame(3), seq.frame(6)
    vocab = make_vocabulary()
    want = ref_match_frames_bow(f1, f2, vocab, np.float32(60.0))

    def port(f):
        return frame_from_numpy({k: np.asarray(v) for k, v in f._asdict().items() if k != "markers"}, "cpu")

    got = match_frames_bow(port(f1), port(f2), torch.from_numpy(np.asarray(vocab).view(np.int32)), 60.0)
    assert int(want.n_matches) > 50
    np.testing.assert_array_equal(got.train_idx.numpy(), np.asarray(want.train_idx))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
