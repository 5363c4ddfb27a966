"""The slice end to end: the reference maps a rendered sequence and saves it;
the reference and the port each load the file and localize the reverse
sweep. The port is held to the gates of chip_smoke.py's slice phase: at
least as many frames tracked, ATE <= 1.2 x the reference's + 0.002, every
camera centre within 2% of the scene's depth extent of the reference's,
and the loaded map's signature equal to the saved one.
"""

import numpy as np
import pytest
import torch

from tools.port.make_reference_map import camera_center, run
from ucoslam_tpu.config import Params
from ucoslam_tpu.geometry.camera import CameraParams as RefCamera
from ucoslam_tpu.io.synthetic import SyntheticSequence as RefSequence
from ucoslam_tpu_torch.api import UcoSlam
from ucoslam_tpu_torch.config import Mode
from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.geometry.horn import ate_rmse
from ucoslam_tpu_torch.io.synthetic import SyntheticSequence
from ucoslam_tpu_torch.utils.timers import timers, tracing

torch.set_num_threads(2)

SEQ = dict(n_frames=16, seed=13, n_points=700)
PARAMS = Params().replace(
    detectMarkers=False, maxDescDistance=60.0, maxKeyPointsPerFrame=512,
    nOctaveLevels=4, maxMapPoints=4096, maxKeyFrames=32,
)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("slice") / "map.slm")
    ref_cam = RefCamera.create(500.0, 500.0, 320.0, 240.0)
    summary, ref_poses = run(PARAMS, ref_cam, RefSequence(cam=ref_cam, **SEQ), path)

    cam = CameraParams.create(500.0, 500.0, 320.0, 240.0)
    seq = SyntheticSequence(cam=cam, **SEQ)
    slam = UcoSlam(device="cpu")
    slam.readFromFile(path, cam)
    loaded_signature = slam.map.signature()
    slam.setMode(Mode.LOCALIZATION)
    poses = {}
    with tracing():
        timers.drain()
        before = timers.counters()
        for i in reversed(range(seq.n_frames)):
            pose = slam.process(seq.render(i), fseq=i)
            if pose is not None:
                poses[i] = pose
        counted = (timers.counters() == before, timers.drain())
    return summary, ref_poses, poses, seq, loaded_signature, slam, counted


def test_loaded_signature_equals_saved(runs):
    summary, _, _, _, loaded_signature, _, _ = runs
    assert loaded_signature == summary["map_signature"]


def test_reverse_sweep_gates(runs):
    summary, ref_poses, poses, seq, _, _, _ = runs
    assert summary["pass2_tracked"] >= 0.9 * seq.n_frames, summary
    assert len(poses) >= summary["pass2_tracked"]
    idx = sorted(poses)
    for i in idx:
        assert poses[i].shape == (4, 4) and np.isfinite(poses[i]).all()
    est = np.stack([camera_center(poses[i]) for i in idx])
    ate = ate_rmse(est, seq.gt_positions()[idx], with_scale=True)
    assert ate <= 1.2 * summary["pass2_ate"] + 0.002, (ate, summary["pass2_ate"])
    tol = 0.02 * summary["depth_extent"]
    for i in idx:
        if i in ref_poses:
            dev = np.linalg.norm(camera_center(poses[i]) - camera_center(ref_poses[i]))
            assert dev <= tol, (i, dev, tol)


def test_session_state_after_sweep(runs):
    _, ref_poses, poses, seq, _, slam, (none_counted, spans) = runs
    np.testing.assert_array_equal(slam.getCurrentPose_f2g(), poses[0])
    assert len(slam.getSignatureStr()) == 16
    st = slam.map.state
    # every tracked frame bumped the visible counters of the points it searched
    assert int(st.pt_n_visible.sum()) > 0
    # the port ran on the CPU: the kernels' plain versions, no launches
    # counted in a sweep that traced a root span a frame
    assert sum(s.name == "slam.process" for s in spans) == seq.n_frames
    assert none_counted
    assert slam._system.tracker.n_attempts >= seq.n_frames
