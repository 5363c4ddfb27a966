"""The port's chessboard stereo calibration tool against the reference's, on
tests/test_apps.py's synthetic verged rig (8 chessboard poses seen by two
cameras 0.12 m apart, rendered by plane homographies). Both are cv2 on the
host: the calibration and the stereo YAML they write agree key for key,
values within 1e-9 (equal here). cv2 runs on one thread for these tests:
on several, its calibration is not reproducible from call to call (the
reference against itself: up to 2e-7 in M2 on this rig)."""

import cv2
import numpy as np
import pytest

from ucoslam_tpu.apps import stereo_calibrate as ref_tool
from ucoslam_tpu_torch.apps import stereo_calibrate

W, H, FX, BOARD, SQUARE, BASELINE = 640, 480, 500.0, (9, 6), 0.03, 0.12


def rig_pairs() -> list:
    """tests/test_apps.py::test_stereo_calibrate_synthetic_chessboard's pairs."""
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1]])
    rng = np.random.default_rng(2)
    pairs = []
    for _ in range(8):
        rvec = rng.uniform(-0.3, 0.3, 3)
        tvec = np.array([rng.uniform(-0.1, 0.1), rng.uniform(-0.05, 0.05), rng.uniform(0.6, 1.0)])
        px = 40
        bw, bh = BOARD
        ny, nx = bh + 1 + 4, bw + 1 + 4
        cells = (np.indices((ny, nx)).sum(0) % 2) * 255
        cells[:2, :] = cells[-2:, :] = 255
        cells[:, :2] = cells[:, -2:] = 255
        pattern = np.kron(cells, np.ones((px, px))).astype(np.uint8)
        src = np.float32([[3 * px, 3 * px], [(3 + bw - 1) * px, 3 * px], [(3 + bw - 1) * px, (3 + bh - 1) * px],
                          [3 * px, (3 + bh - 1) * px]])
        obj4 = np.float32([[0, 0, 0], [(bw - 1) * SQUARE, 0, 0], [(bw - 1) * SQUARE, (bh - 1) * SQUARE, 0],
                           [0, (bh - 1) * SQUARE, 0]])
        imgs = []
        for eye in range(2):
            uv, _ = cv2.projectPoints(obj4, rvec, tvec - np.array([BASELINE * eye, 0, 0]), K, None)
            Hm = cv2.getPerspectiveTransform(src, uv.reshape(4, 2).astype(np.float32))
            imgs.append(cv2.warpPerspective(pattern, Hm, (W, H), flags=cv2.INTER_LINEAR,
                                            borderMode=cv2.BORDER_CONSTANT, borderValue=255))
        pairs.append((imgs[0], imgs[1]))
    return pairs


@pytest.fixture(autouse=True)
def one_cv2_thread():
    n = cv2.getNumThreads()
    cv2.setNumThreads(1)
    yield
    cv2.setNumThreads(n)


YAML_KEYS = ("image_width", "image_height", "M1", "D1", "M2", "D2", "R", "T", "R1", "R2", "P1", "P2", "Q")


def read_yml(path: str) -> dict:
    fs = cv2.FileStorage(path, cv2.FILE_STORAGE_READ)
    out = {}
    for k in YAML_KEYS:
        node = fs.getNode(k)
        out[k] = node.real() if k.startswith("image_") else node.mat()
    fs.release()
    return out


def test_calibration_and_yaml_match_reference(tmp_path):
    pairs = rig_pairs()
    got = stereo_calibrate.calibrate_stereo_pairs(pairs, BOARD, SQUARE)
    want = ref_tool.calibrate_stereo_pairs(pairs, BOARD, SQUARE)
    assert got is not None and want is not None
    assert got.keys() == want.keys() and got["image_size"] == want["image_size"] == (W, H)
    for k in ("M1", "D1", "M2", "D2", "R", "T", "rms"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-9, err_msg=k)
    assert abs(np.linalg.norm(got["T"]) - BASELINE) < 0.01  # the reference test's own gate
    stereo_calibrate.write_stereo_yml(str(tmp_path / "port.yml"), got)
    ref_tool.write_stereo_yml(str(tmp_path / "ref.yml"), want)
    a, b = read_yml(str(tmp_path / "port.yml")), read_yml(str(tmp_path / "ref.yml"))
    for k in YAML_KEYS:
        assert a[k] is not None and np.shape(a[k]) == np.shape(b[k]), k
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-9, err_msg=k)


def test_main_on_an_image_directory(tmp_path):
    """The command line on left/right PNG pairs writes the reference's YAML."""
    d = tmp_path / "pairs"
    d.mkdir()
    for i, (left, right) in enumerate(rig_pairs()):
        cv2.imwrite(str(d / f"{i:02d}_left.png"), left)
        cv2.imwrite(str(d / f"{i:02d}_right.png"), right)
    assert stereo_calibrate.main([str(d), str(tmp_path / "port.yml"), "--square", str(SQUARE)]) == 0
    assert ref_tool.main([str(d), str(tmp_path / "ref.yml"), "--square", str(SQUARE)]) == 0
    a, b = read_yml(str(tmp_path / "port.yml")), read_yml(str(tmp_path / "ref.yml"))
    for k in YAML_KEYS:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-9, err_msg=k)
