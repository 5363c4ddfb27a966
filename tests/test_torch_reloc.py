"""The port's relocalization and lost-segment re-seed, end to end on the
CPU over oracle frames (tests/test_slam_e2e.py's PARAMS):

- the counterparts of tests/test_slam_e2e.py::TestRecovery: tracking comes
  back after a gap of reset frames; with a keyframe database the brute
  force never runs; with a dummy database the brute force relocalizes;
- `_reloc_match` (the brute force's matching) equal to the reference's;
- the re-seed: frames 0-11 of one oracle scene, then frames 12-29 of
  another that relocalization cannot match; after reseedAfterLostFrames
  (6 here) lost frames both packages two-view initialize a new segment
  (two keyframes at once), and the port tracks at least the reference's
  frames after it, less 2, with a consistent map.
"""

import copy

import numpy as np
import pytest
import torch

from chip_smoke import reseed_frame
from ucoslam_tpu.config import Params
from ucoslam_tpu.io import SyntheticSequence as RefSequence
from ucoslam_tpu.slam import System as RefSystem
from ucoslam_tpu.slam.tracker import _reloc_match as ref_reloc_match
from ucoslam_tpu_torch.config import Params as PortParams
from ucoslam_tpu_torch.io.synthetic import SyntheticSequence
from ucoslam_tpu_torch.mapping.frame import frame_from_numpy
from ucoslam_tpu_torch.mapping.map import map_state_from_numpy
from ucoslam_tpu_torch.slam import tracker as tracker_mod
from ucoslam_tpu_torch.slam.system import System

torch.set_num_threads(2)

PARAMS = Params().replace(
    maxMapPoints=4096, maxKeyFrames=32, maxKeyPointsPerFrame=512, maxDescDistance=60.0, ransacIters=256,
    detectMarkers=False,
)
PORT_PARAMS = PortParams.from_dict(PARAMS.to_dict())


def run(sys_, seq, frames, lost=(), count_from=0):
    """Process `frames` of seq (reset_tracker in place of the `lost` ones);
    -> frames tracked from `count_from` on."""
    tracked = 0
    for i in frames:
        if i in lost:
            sys_.reset_tracker()
            continue
        if sys_.process_frame(seq.frame(i, device="cpu")) is not None and i >= count_from:
            tracked += 1
    return tracked


def test_relocalizes_after_gap():
    seq = SyntheticSequence(n_frames=40, seed=7)
    sys_ = System(PORT_PARAMS, seq.cam, device="cpu")
    after = run(sys_, seq, range(40), lost=set(range(18, 24)), count_from=24)
    assert after >= 0.8 * (40 - 24), f"only {after}"
    assert sys_.tracker.n_relocalizations >= 1


@pytest.fixture(scope="module")
def mapped():
    """The port's SLAM over frames 0-14 of a 30-frame sequence (both
    relocalization tests continue from a copy of it)."""
    seq = SyntheticSequence(n_frames=30, seed=7)
    sys_ = System(PORT_PARAMS, seq.cam, device="cpu")
    run(sys_, seq, range(15))
    return seq, sys_


def test_reloc_uses_bow_candidates_not_brute_force(mapped, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("brute-force relocalization ran despite the keyframe database")

    monkeypatch.setattr(tracker_mod, "_reloc_match", boom)
    seq, sys_ = mapped
    sys_ = copy.deepcopy(sys_)
    relocalized = run(sys_, seq, range(15, 30), lost={15, 16}, count_from=17)
    assert relocalized >= 0.8 * (30 - 17), f"only {relocalized}"
    assert sys_.tracker.n_relocalizations == 1


def test_reloc_brute_force_fallback_without_vocab(mapped, monkeypatch):
    calls, brute_force = [], tracker_mod._reloc_match
    monkeypatch.setattr(tracker_mod, "_reloc_match", lambda *a: calls.append(1) or brute_force(*a))
    seq, sys_ = mapped
    sys_ = copy.deepcopy(sys_)
    sys_.manager.kfdb.dummy = True
    relocalized = run(sys_, seq, range(15, 30), lost={15, 16}, count_from=17)
    assert relocalized >= 0.8 * (30 - 17), f"only {relocalized}"
    assert calls


def test_reloc_match_equals_reference():
    """On an arena of random descriptors (some rows inactive) and a frame
    holding noisy copies of some of them, duplicates included."""
    from ucoslam_tpu.mapping import Map as RefMap
    from ucoslam_tpu.mapping.frame import empty_frame as ref_empty_frame

    rng = np.random.default_rng(4)
    m = RefMap(PARAMS)
    n_pts, n_kpt = 3000, PARAMS.maxKeyPointsPerFrame
    desc = rng.integers(0, 2**32, (n_pts, 8), dtype=np.uint32)
    pos = rng.normal(0, 1, (n_pts, 3)).astype(np.float32)
    slots = m.add_points(pos, pos, desc, np.ones(n_pts, np.float32), np.ones(n_pts, np.float32),
                         np.zeros(n_pts, np.int32), 0)
    m.remove_points(slots[rng.random(n_pts) < 0.1])
    src = rng.choice(n_pts, 450, replace=False)
    kd = desc[np.r_[src, src[:20]]]  # 20 keypoints twice: one point per keypoint
    for _ in range(12):
        kd[np.arange(len(kd)), rng.integers(0, 8, len(kd))] ^= np.uint32(1) << rng.integers(0, 32, len(kd)).astype(
            np.uint32)
    kd = np.vstack([kd, np.zeros((n_kpt - len(kd), 8), np.uint32)])
    frame = ref_empty_frame(n_kpt)._replace(desc=kd, valid=np.arange(n_kpt) < 470)
    want_idx, want_ok = ref_reloc_match(m.state, frame, np.float32(60.0))
    port_state = map_state_from_numpy({k: np.asarray(v) for k, v in m.state._asdict().items()}, "cpu")
    port_frame = frame_from_numpy({k: np.asarray(v) for k, v in frame._asdict().items() if k != "markers"}, "cpu")
    idx, ok = tracker_mod._reloc_match(port_state, port_frame, 60.0)
    assert 300 < int(np.asarray(want_ok).sum()) < 450
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))


def test_reseed_on_splice():
    """Frames 0-11 of scene 7, then 12-29 of scene 8."""
    n, at, lost = 30, 12, 6
    ref_params = PARAMS.replace(reseedAfterLostFrames=lost)
    A, B = RefSequence(n_frames=n, seed=7), RefSequence(n_frames=n, seed=8)
    ref = RefSystem(ref_params, A.cam)
    ref_poses = {i: ref.process_frame((A if i < at else B).frame(i)) for i in range(n)}
    ref_at = reseed_frame(ref.stats_log, lost)
    assert ref_at is not None

    A, B = SyntheticSequence(n_frames=n, seed=7), SyntheticSequence(n_frames=n, seed=8)
    sys_ = System(PortParams.from_dict(ref_params.to_dict()), A.cam, device="cpu")
    poses = {i: sys_.process_frame((A if i < at else B).frame(i, device="cpu")) for i in range(n)}
    got_at = reseed_frame(sys_.stats_log, lost)
    assert got_at is not None, "the port did not re-seed"
    after = sum(p is not None for i, p in poses.items() if i > got_at)
    ref_after = sum(p is not None for i, p in ref_poses.items() if i > ref_at)
    assert after >= ref_after - 2, (got_at, after, ref_at, ref_after)
    sys_.map.check_consistency()
