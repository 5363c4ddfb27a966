"""The port's frame matchers against the reference's, exactly, on seeded
frames built to tie: duplicated descriptors (equal best and second-best
distances, several rows claiming one column) and keypoint angles drawn
from a few values so that rotation-histogram bins tie."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucoslam_tpu.geometry.camera import CameraParams as RefCamera
from ucoslam_tpu.geometry.epipolar import fundamental_from_poses as ref_fundamental
from ucoslam_tpu.mapping.frame import empty_frame as ref_empty_frame
from ucoslam_tpu.matching import matcher as ref_matcher
from ucoslam_tpu_torch.geometry.se3 import se3_exp
from ucoslam_tpu_torch.mapping.frame import frame_from_numpy
from ucoslam_tpu_torch.matching import matcher

torch.set_num_threads(2)


def _frame_arrays(rng, n, base_desc, angles, n_valid):
    """Arrays of one frame: descriptors are noisy copies of base rows, and
    every fifth row repeats the one before it (ties)."""
    src = rng.integers(0, len(base_desc), n)
    desc = base_desc[src].copy()
    for _ in range(rng.integers(0, 6)):
        w, b = rng.integers(0, 8, n), rng.integers(0, 32, n).astype(np.uint32)
        desc[np.arange(n), w] ^= np.uint32(1) << b
    desc[4::5] = desc[3::5][: len(desc[4::5])]
    xy = rng.uniform([0, 0], [640, 480], (n, 2)).astype(np.float32)
    return dict(
        fseq=np.int32(0), xy=xy, und_xy=xy, octave=rng.integers(0, 4, n).astype(np.int32),
        angle=rng.choice(angles, n).astype(np.float32), response=np.zeros(n, np.float32),
        desc=desc, depth=np.zeros(n, np.float32), valid=np.arange(n) < n_valid,
        ids=np.where(rng.random(n) < 0.2, rng.integers(0, 50, n), -1).astype(np.int32),
        pose_f2g=np.eye(4, dtype=np.float32),
    )


def _both(arrays):
    ref = ref_empty_frame(len(arrays["xy"]))._replace(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return ref, frame_from_numpy(arrays, "cpu")


# seeds 3, 4 and 24 tie the 3rd and 4th rotation bins of match_frames'
# default call (counts 7/7, 5/5, 6/6/6), so the lowest bin must win there
@pytest.fixture(params=[0, 3, 4, 24])
def frames(request):
    rng = np.random.default_rng(request.param)
    base = rng.integers(0, 2**32, (120, 8), dtype=np.uint32)
    # angles on a few values: equal counts tie bins of the rotation histogram
    angles = np.array([0.1, 0.3, 2.0, 2.2, 4.0, 6.2])
    a = _frame_arrays(rng, 300, base, angles, 280)
    b = _frame_arrays(rng, 256, base, angles, 250)
    return _both(a), _both(b)


def _assert_equal(got, want):
    np.testing.assert_array_equal(got.train_idx.numpy(), np.asarray(want.train_idx))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(want.dist))
    assert int(got.n_matches) == int(want.n_matches)


@pytest.mark.parametrize("kw", [
    dict(), dict(nn_ratio=0.9), dict(only_unassigned_1=True, only_unassigned_2=True),
    dict(check_rotation=False, max_octave_diff=1),
])
def test_match_frames_equals_reference(frames, kw):
    (r1, p1), (r2, p2) = frames
    want = ref_matcher.match_frames(r1, r2, jnp.float32(60.0), **kw)
    got = matcher.match_frames(p1, p2, 60.0, **kw)
    assert int(want.n_matches) > 10
    _assert_equal(got, want)


def _fundamental():
    T1 = np.eye(4, dtype=np.float32)
    T2 = se3_exp(torch.tensor([-0.4, 0.1, 0.05, 0.02, 0.05, 0.0])).numpy()
    cam = RefCamera.create(500.0, 500.0, 320.0, 240.0)
    return ref_fundamental(jnp.asarray(T1), jnp.asarray(T2), cam, cam)


def test_match_frames_epipolar_equals_reference(frames):
    (r1, p1), (r2, p2) = frames
    F = _fundamental()
    sigma2 = jnp.exp(2.0 * r2.octave.astype(jnp.float32) * jnp.log(jnp.float32(1.2)))
    # a wide variance so the epipolar band admits many pairs of these random points
    sigma2 = sigma2 * 400.0
    want = ref_matcher.match_frames_epipolar(r1, r2, F, sigma2, jnp.float32(60.0))
    got = matcher.match_frames_epipolar(p1, p2, torch.from_numpy(np.asarray(F)),
                                        torch.from_numpy(np.asarray(sigma2)), 60.0)
    assert int(want.n_matches) > 5
    _assert_equal(got, want)


def test_match_frames_epipolar_batch_equals_pairs(frames):
    """The mapper's batch of train frames gives each pair's matches."""
    (_, p1), (_, p2) = frames
    F = torch.from_numpy(np.asarray(_fundamental()))
    sigma2 = torch.exp(2.0 * p2.octave.float() * torch.log(torch.tensor(1.2))) * 400.0
    p2b = p2.replace(**{k: torch.stack([getattr(p2, k), getattr(p2, k).flip(0)]) for k in (
        "xy", "und_xy", "octave", "angle", "desc", "valid", "ids")})
    got = matcher.match_frames_epipolar(p1, p2b, torch.stack([F, F.T]), torch.stack([sigma2, sigma2.flip(0)]), 60.0)
    for i, (Fi, s) in enumerate(((F, sigma2), (F.T, sigma2.flip(0)))):
        one = p2.replace(**{k: getattr(p2b, k)[i] for k in ("xy", "und_xy", "octave", "angle", "desc", "valid", "ids")})
        want = matcher.match_frames_epipolar(p1, one, Fi, s, 60.0)
        assert torch.equal(got.train_idx[i], want.train_idx)
        assert torch.equal(got.valid[i], want.valid)
