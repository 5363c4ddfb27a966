"""The port's FREAK and SURF families and its grid extractor against the
reference on the same inputs.

The reference's FREAK and SURF tables have 64 rotation bins, but its
extractor quantizes angles to `ucoslam_tpu.features.orb.DESC_BINS` = 32, so
its first FREAK or SURF frame raises (`test_reference_fault_without_64_bins`;
ROADMAP.md, Queue 3). The comparisons set that module constant to the
tables' 64 through `monkeypatch`, for the test only; the port quantizes a
FREAK or SURF angle to 64 bins itself.

Measured here (CPU, frames 3, 17 and 31 of the `mono` scene, 640x480, 4
levels x 512 keypoints): keypoint sets agree 99.22-100% (the pyramid's
float32 sums run in another order, as for ORB in test_torch_frontend.py);
angles of the shared keypoints differ by at most 2.2e-5 rad (the IC
moments' float32 sums, an atan2 of nearly cancelling moments); descriptor
bits of the shared keypoints differ in 0 of ~131000 per frame (FREAK) and
at most 1 (SURF, 0.0008%). The floors: 99% of the keypoints, angles
within 5e-5, at most 0.1% of the bits (FREAK compares bf16 samples, each a
float32 sum over 961 pixels rounded to bf16, so a sum in another order can
round across a tie).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ucoslam_tpu.features.orb as ref_orb
from ucoslam_tpu.config import DescriptorType as RefDescriptorType
from ucoslam_tpu.config import Params
from ucoslam_tpu.features import descriptors as ref_desc
from ucoslam_tpu.features.grid_extractor import GridExtractor as RefGridExtractor
from ucoslam_tpu_torch.config import DescriptorType
from ucoslam_tpu_torch.config import Params as PortParams
from ucoslam_tpu_torch.features import descriptors
from ucoslam_tpu_torch.features.frame_extractor import FrameExtractor
from ucoslam_tpu_torch.features.grid_extractor import GridExtractor
from ucoslam_tpu_torch.features.orb import ORBExtractor
from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.io.synthetic import SyntheticSequence

torch.set_num_threads(2)

FRAMES = (3, 17, 31)
KP_FLOOR, ANGLE_TOL, BIT_SHARE_TOL = 0.99, 5e-5, 1e-3


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence(n_frames=40, n_points=1600, seed=5)  # the `mono` scene


@pytest.mark.parametrize("name", ["FREAK_POINTS", "FREAK_PAIRS", "freak_tables", "surf_tables",
                                  "surf_lsh_projection"])
def test_tables_equal_reference(name):
    got, want = getattr(descriptors, name), getattr(ref_desc, name)
    got, want = (got(), want()) if callable(got) else (got, want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert descriptors.DESC_BINS == ref_desc.DESC_BINS == 64


def shared_keypoints(port, ref):
    """-> (share of the union shared, port rows, reference rows) of the
    valid keypoints with equal (x, y, octave)."""
    def keyset(xy, octave, valid):
        return {(float(x), float(y), int(o)): k for k, ((x, y), o, v) in enumerate(zip(xy, octave, valid)) if v}

    a = keyset(port.xy.numpy(), port.octave.numpy(), port.valid.numpy())
    b = keyset(np.asarray(ref.xy), np.asarray(ref.octave), np.asarray(ref.valid))
    shared = sorted(a.keys() & b.keys())
    return (len(shared) / max(len(a.keys() | b.keys()), 1),
            np.array([a[k] for k in shared]), np.array([b[k] for k in shared]))


def differing_bits(d_port: np.ndarray, d_ref: np.ndarray) -> int:
    return int(np.unpackbits((d_port.view(np.uint32) ^ d_ref.view(np.uint32)).view(np.uint8)).sum())


@pytest.mark.parametrize("family", ["freak", "surf"])
def test_extractor_matches_reference(seq, family, monkeypatch):
    monkeypatch.setattr(ref_orb, "DESC_BINS", ref_desc.DESC_BINS)
    ref = ref_orb.ORBExtractor(max_features=512, n_levels=4, descriptor=family)
    port = ORBExtractor(max_features=512, n_levels=4, descriptor=family)
    for i in FRAMES:
        img = seq.render(i).astype(np.float32)
        kr = ref.detect_and_compute(jnp.asarray(img))
        kp = port.detect_and_compute(torch.from_numpy(img))
        assert kp.desc.shape == (512, 8) and kp.desc.dtype == torch.int32
        agree, ip, ir = shared_keypoints(kp, kr)
        assert agree >= KP_FLOOR, f"frame {i}: keypoint agreement {agree:.4f}"
        assert len(ip) > 400
        err = np.abs(kp.angle.numpy()[ip] - np.asarray(kr.angle)[ir]).max()
        assert err <= ANGLE_TOL, f"frame {i}: angles differ by {err}"
        share = differing_bits(kp.desc.numpy()[ip], np.asarray(kr.desc)[ir]) / (256 * len(ip))
        assert share <= BIT_SHARE_TOL, f"frame {i}: {100 * share:.3f}% of the descriptor bits differ"


@pytest.mark.parametrize("family", ["freak", "surf"])
def test_reference_fault_without_64_bins(seq, family):
    """The reference as it stands: its 32-bin one-hot meets the 64-bin
    tables and the einsum raises; the port describes the same frame."""
    img = seq.render(3).astype(np.float32)
    with pytest.raises(ValueError, match="64"):
        ref_orb.ORBExtractor(max_features=128, n_levels=2, descriptor=family).detect_and_compute(jnp.asarray(img))
    kp = ORBExtractor(max_features=128, n_levels=2, descriptor=family).detect_and_compute(torch.from_numpy(img))
    assert int(kp.valid.sum()) > 100


def test_orb_keeps_32_bins(seq):
    """ORB's rotation bins stay the reference's 32 beside the 64 of FREAK
    and SURF: a keypoint's ORB descriptor is the reference's."""
    img = seq.render(17).astype(np.float32)
    kr = ref_orb.ORBExtractor(max_features=512, n_levels=4).detect_and_compute(jnp.asarray(img))
    kp = ORBExtractor(max_features=512, n_levels=4).detect_and_compute(torch.from_numpy(img))
    _, ip, ir = shared_keypoints(kp, kr)
    assert differing_bits(kp.desc.numpy()[ip], np.asarray(kr.desc)[ir]) / (256 * len(ip)) <= 0.02


@pytest.mark.parametrize("desc", ["ORB", "FREAK", "SURF"])
def test_frame_extractor_constructs_device_families(seq, desc):
    """ORB, FREAK and SURF build an extractor on the device path and a
    frame, each family with its gate from Params.setParams."""
    params = PortParams().setParams(True, DescriptorType[desc]).replace(detectMarkers=False, maxKeyPointsPerFrame=512,
                                                                        nOctaveLevels=4)
    ext = FrameExtractor(params, CameraParams.create(500.0, 500.0, 320.0, 240.0), device="cpu")
    assert isinstance(ext.orb, ORBExtractor) and ext.orb.descriptor == desc.lower()
    f = ext.process(seq.render(5), 5)
    assert f.desc.shape == (512, 8) and int(f.valid.sum()) > 400
    assert params.maxDescDistance == {"ORB": 50.0, "FREAK": 35.0, "SURF": 18.0}[desc]


def grid_keypoints_equal(port, ref):
    assert int(port.valid.sum()) > 100
    for name in ("xy", "octave", "angle", "valid"):
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name)
    np.testing.assert_array_equal(port.desc.numpy().view(np.uint32), np.asarray(ref.desc).view(np.uint32))


@pytest.mark.parametrize("desc", ["ORB", "AKAZE", "BRISK"])
def test_grid_extractor_matches_reference(seq, desc):
    """The grid extractor on one image: the reference's keypoints and
    descriptors, exactly. OpenCV 5 moved AKAZE and BRISK out of the main
    module (cv2 5.0.0 has no AKAZE_create or BRISK_create): there both
    packages raise the same AttributeError at construction."""
    import cv2

    params = Params().setParams(True, RefDescriptorType[desc]).replace(maxKeyPointsPerFrame=512)
    port_params = PortParams.from_dict(params.to_dict())
    img = seq.render(9)
    if desc != "ORB" and not hasattr(cv2, f"{desc}_create"):
        for make in (lambda: RefGridExtractor(params), lambda: GridExtractor(port_params, device="cpu")):
            with pytest.raises(AttributeError, match=f"{desc}_create"):
                make()
        return
    ref = RefGridExtractor(params).detect_and_compute(img)
    port = GridExtractor(port_params, device="cpu").detect_and_compute(torch.from_numpy(img.astype(np.float32)))
    grid_keypoints_equal(port, ref)
    np.testing.assert_array_equal(port.response.numpy(), np.asarray(ref.response))


@pytest.mark.parametrize("desc", ["AKAZE", "BRISK"])
def test_frame_extractor_grid_route_matches_reference(seq, desc, monkeypatch):
    """AKAZE and BRISK route through the grid extractor in both packages'
    FrameExtractor (gray, grid selection, octave decoding, 256-bit packing,
    padding to the frame). cv2 5.0.0 lacks both detectors, so cv2's ORB
    stands behind cv2.<desc>_create for both packages alike."""
    import cv2

    from ucoslam_tpu.features.frame_extractor import FrameExtractor as RefExtractor
    from ucoslam_tpu.geometry.camera import CameraParams as RefCamera

    orb_create = cv2.ORB_create
    monkeypatch.setattr(cv2, f"{desc}_create", lambda: orb_create(nfeatures=1000), raising=False)
    params = Params().setParams(True, RefDescriptorType[desc]).replace(detectMarkers=False, maxKeyPointsPerFrame=640)
    ref = RefExtractor(params, RefCamera.create(500.0, 500.0, 320.0, 240.0))
    port = FrameExtractor(PortParams.from_dict(params.to_dict()), CameraParams.create(500.0, 500.0, 320.0, 240.0),
                          device="cpu")
    assert isinstance(port.orb, GridExtractor)
    img = seq.render(9)
    f_port, f_ref = port.process(img, 9), ref.process(img, 9)
    assert f_port.xy.shape == (640, 2)
    grid_keypoints_equal(f_port, f_ref)
    np.testing.assert_array_equal(f_port.und_xy.numpy(), np.asarray(f_ref.und_xy))
