"""FREAK and SURF monocular SLAM, the port against the reference, on the CPU.

The `mono` scene's first 20 frames at 4 levels, each family with its own
gate (`Params.setParams(True, FREAK or SURF)`: 35 and 18 bits); FREAK at
512 keypoints, SURF at 1024 (at 512 with its 18-bit gate the reference's
two-view init finds too few matches to start in 24 frames; at 1024 it
starts at frame 5). The reference runs pass 1 with `ucoslam_tpu.features.orb.DESC_BINS`
set to its tables' 64 bins through `monkeypatch` (its extractor raises
otherwise; ROADMAP.md, Queue 3) and saves a checkpoint of its two-view
init on the way; the port reads that checkpoint and maps the rest of the
frames, so that the init's RANSAC lottery is the same for both (as in
test_torch_slam.py), and is held to chip_smoke.py's phase-5 gates: tracked
>= the reference's - 2, ATE <= 1.2 x the reference's + 0.002. The reference
then reads the port's FREAK checkpoint with the port's signature and
rebuilds the family's extractor from it.

This file runs FREAK; `test_torch_descriptor_slam_surf.py` runs SURF through
the same helpers (about 60 s each alone on 2 threads).
"""

import numpy as np
import pytest
import torch

import ucoslam_tpu.features.orb as ref_orb
from tools.port.make_reference_map import ate_of
from ucoslam_tpu.api import UcoSlam as RefSlam
from ucoslam_tpu.config import DescriptorType as RefDescriptorType
from ucoslam_tpu.config import Params
from ucoslam_tpu.features import descriptors as ref_desc
from ucoslam_tpu.geometry.camera import CameraParams as RefCamera
from ucoslam_tpu.io.synthetic import SyntheticSequence as RefSequence
from ucoslam_tpu_torch.api import UcoSlam
from ucoslam_tpu_torch.config import DescriptorType
from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.io.synthetic import SyntheticSequence

torch.set_num_threads(2)

SEQ = dict(n_frames=20, n_points=1600, seed=5)  # the `mono` scene, cut to 20 frames
KEYPOINTS = {"freak": 512, "surf": 1024}


def params_for(family: str) -> Params:
    return Params().setParams(True, RefDescriptorType[family.upper()]).replace(
        detectMarkers=False, maxKeyPointsPerFrame=KEYPOINTS[family], nOctaveLevels=4, maxMapPoints=4096,
        maxKeyFrames=32)


def family_runs(family: str, tmp_path_factory):
    """The reference's pass 1 (its init saved), the port's pass 1 from that
    init -> (family, params, reference poses, port poses, port UcoSlam,
    sequence, directory)."""
    d = tmp_path_factory.mktemp(family)
    ref_cam = RefCamera.create(500.0, 500.0, 320.0, 240.0)
    ref_seq = RefSequence(cam=ref_cam, **SEQ)
    params = params_for(family)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_orb, "DESC_BINS", ref_desc.DESC_BINS)
        ref = RefSlam()
        ref.setParams(None, params, ref_cam)
        ref_poses, init_path = {}, str(d / "init.slm")
        for i in range(SEQ["n_frames"]):
            pose = ref.process(ref_seq.render(i), fseq=i)
            if pose is not None:
                if not ref_poses:  # the two-view init: carried across to the port
                    ref.saveToFile(init_path)
                ref_poses[i] = np.asarray(pose)
    cam = CameraParams.create(500.0, 500.0, 320.0, 240.0)
    seq = SyntheticSequence(cam=cam, **SEQ)
    slam = UcoSlam(device="cpu")
    slam.readFromFile(init_path, cam)
    assert slam._params.kpDescriptorType == DescriptorType[family.upper()]
    assert slam._extractor.orb.descriptor == family
    start = int(slam.map.h("kf_fseq").max())
    poses = {start: slam._system.pose.copy()}
    for i in range(start + 1, SEQ["n_frames"]):
        pose = slam.process(seq.render(i), fseq=i)
        if pose is not None:
            poses[i] = pose
    return family, params, ref_poses, poses, slam, seq, d


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return family_runs("freak", tmp_path_factory)


def test_pass1_held_to_reference(runs):
    family, _, ref_poses, poses, slam, seq, _ = runs
    ref_ate, ate = ate_of(ref_poses, seq), ate_of(poses, seq)
    assert len(poses) >= len(ref_poses) - 2, (family, len(poses), len(ref_poses))
    assert ate <= 1.2 * ref_ate + 0.002, (family, ate, ref_ate)
    slam.map.check_consistency()
    assert slam._system.manager.n_insertions >= 1
    assert slam._system.params.maxDescDistance == {"freak": 35.0, "surf": 18.0}[family]


def test_reference_reads_port_checkpoint(runs, monkeypatch):
    family, params, _, _, slam, _, d = runs
    path = str(d / "port.slm")
    slam.saveToFile(path)
    monkeypatch.setattr(ref_orb, "DESC_BINS", ref_desc.DESC_BINS)
    loc = RefSlam()
    loc.readFromFile(path, RefCamera.create(500.0, 500.0, 320.0, 240.0))
    assert (loc.map.signature(), loc.getSignatureStr()) == (slam.map.signature(), slam.getSignatureStr())
    assert loc._params.kpDescriptorType == params.kpDescriptorType
    assert loc._extractor.orb.descriptor == family
