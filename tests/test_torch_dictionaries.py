"""Every marker dictionary on the port's native detector, against the reference's cv2 backend.

The port reads cv2's predefined dictionaries from committed tables
(`ucoslam_tpu_torch/markers/predefined.py`, written by
`tools/port/make_dictionaries.py`) since the card's machine has no cv2; the
reference detects those dictionaries with cv2.aruco (`backend="cv2"`, which
"auto" picks for them where cv2 is installed). Held here:

- every committed table equals cv2's (words, digest, marker size,
  maxCorrectionBits), and each name corrects floor(0.6 x maxCorrectionBits)
  bits, as cv2's detector with default parameters;
- marker bitmaps equal `cv2.aruco.generateImageMarker`'s;
- names resolve as the reference resolves them (its aliases, every DICT_*
  name in both case spellings);
- on rendered frames of each of the 22 tables (`tools/port/marker_render.py`:
  the port's renderer, the markers turned a quarter at a time and tilted up
  to 40 degrees, two views at 640x480), the port's ids equal the reference's
  cv2 ids, its corners lie within 1.5 px of cv2's (measured 1.037 px when
  this was written: cv2's subpixel refinement lands up to 1.01 px from the
  projected corners) and within 0.25 px of the projected corners (measured
  0.193); a code equal to its own half-turn (ARUCO_ORIGINAL 1023) is
  compared up to that turn;
- a marker with one flipped bit: rejected by both packages on 4X4_1000
  (no correction), accepted with its id by both on TAG36h11 (3 bits).
"""

import math

import cv2
import cv2.aruco as aruco
import numpy as np
import pytest
import torch

from tools.port.make_dictionaries import codewords, digest, table_key
from tools.port.marker_render import dictionary_frames
from ucoslam_tpu.geometry import CameraParams as RefCamera
from ucoslam_tpu.markers.detector import _DICT_MAP
from ucoslam_tpu.markers.detector import ArucoDetector as RefDetector
from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.markers import dictionary, predefined
from ucoslam_tpu_torch.markers.detector import ArucoDetector

torch.set_num_threads(2)

CV2_NAMES = sorted(n for n in dir(aruco) if n.startswith("DICT_"))
#: one name for each distinct table and size (22)
TABLE_NAMES = [f"DICT_{f}_{s}" for f in ("4X4", "5X5", "6X6", "7X7") for s in (50, 100, 250, 1000)] + [
    "DICT_APRILTAG_16h5", "DICT_APRILTAG_25h9", "DICT_APRILTAG_36h10", "DICT_APRILTAG_36h11", "DICT_ARUCO_ORIGINAL",
    "DICT_ARUCO_MIP_36h12"]
CAM = CameraParams.create(500.0, 500.0, 320.0, 240.0)
REF_CAM = RefCamera.create(500.0, 500.0, 320.0, 240.0)
CV2_BOUND, ORACLE_BOUND = 1.5, 0.25


def test_every_cv2_name_is_committed():
    assert predefined.CV2_VERSION == cv2.__version__
    assert sorted(predefined.DICTIONARIES) == CV2_NAMES
    assert len({(t, s) for t, s, _, _ in predefined.DICTIONARIES.values()}) == len(TABLE_NAMES) == 22
    assert predefined.ERROR_CORRECTION_RATE == aruco.DetectorParameters().errorCorrectionRate


@pytest.mark.parametrize("name", CV2_NAMES)
def test_table_equals_cv2(name):
    d = aruco.getPredefinedDictionary(getattr(aruco, name))
    words = codewords(d)
    got = dictionary.load_codewords(name)
    assert got.tolist() == words
    key = table_key(name)
    assert predefined.DIGESTS[key] == digest(dictionary._table_words("cv2", key).tolist())
    spec = dictionary.resolve(name)
    assert (spec.bits, spec.size) == (d.markerSize, len(words))
    assert spec.max_correction == math.floor(0.6 * d.maxCorrectionBits)


def test_mip_36h12_table_equals_native_header():
    np.testing.assert_array_equal(dictionary.load_codewords("DICT_ARUCO_MIP_36h12"),
                                  dictionary.load_codewords("ARUCO_MIP_36h12"))
    assert dictionary.resolve("ARUCO_MIP_36h12").max_correction == 1  # the native backend's
    assert dictionary.resolve("DICT_ARUCO_MIP_36h12").max_correction == 3  # cv2's


@pytest.mark.parametrize("name", TABLE_NAMES)
def test_bitmaps_equal_cv2(name):
    d = aruco.getPredefinedDictionary(getattr(aruco, name))
    n = d.markerSize + 2
    for mid in sorted({0, dictionary.resolve(name).size // 2, dictionary.resolve(name).size - 1}):
        img = aruco.generateImageMarker(d, mid, n * 10, borderBits=1)
        cells = (img.reshape(n, 10, n, 10)[:, 5, :, 5] > 127).astype(np.uint8)
        np.testing.assert_array_equal(dictionary.marker_bitmap(mid, name), cells)


def test_names_resolve_as_the_reference():
    for alias, cv2_name in _DICT_MAP.items():
        if alias in dictionary.NATIVE:
            continue  # the reference's native backend takes these
        assert dictionary.resolve(alias) == dictionary.resolve(cv2_name)
        np.testing.assert_array_equal(dictionary.load_codewords(alias), codewords(
            aruco.getPredefinedDictionary(getattr(aruco, cv2_name))))
    for lower, upper in (("DICT_APRILTAG_36h11", "DICT_APRILTAG_36H11"), ("DICT_APRILTAG_16h5", "DICT_APRILTAG_16H5")):
        assert dictionary.resolve(lower) == dictionary.resolve(upper)
    assert dictionary.resolve("ARUCO").size == 1024 and dictionary.resolve("ARUCO").max_correction == 0
    assert dictionary.resolve("TAG36h11").max_correction == 3
    assert dictionary.resolve("4X4_250").max_correction == 0
    assert dictionary.resolve("DICT_5X5_250").max_correction == 1


def _corner_gap(a: np.ndarray, b: np.ndarray, symmetric: bool) -> float:
    """Largest corner distance; up to a half-turn for a symmetric code."""
    gap = np.abs(a - b).max()
    return min(gap, np.abs(np.roll(a, 2, 0) - b).max()) if symmetric else gap


def _symmetric(name: str, mid: int) -> bool:
    bm = dictionary.marker_bitmap(mid, name)
    return bool((np.rot90(bm, 2) == bm).all())


@pytest.mark.parametrize("name", TABLE_NAMES)
def test_detection_equals_cv2_backend(name):
    port, ref = ArucoDetector(name, marker_size=0.6, device="cpu"), RefDetector(name, marker_size=0.6, backend="cv2")
    assert ref._native is False and ref.available
    for gray, oracle in dictionary_frames(name):
        ids, corners = port._detect_raw(gray)
        ref_ids, ref_corners = ref._detect_raw(gray)
        assert sorted(ids.tolist()) == sorted(ref_ids) == sorted(oracle), (name, ids, ref_ids, sorted(oracle))
        want = dict(zip(ref_ids, ref_corners))
        for i, c in zip(ids.tolist(), corners):
            sym = _symmetric(name, i)
            assert _corner_gap(c, want[i], sym) < CV2_BOUND, (name, i, c, want[i])
            assert _corner_gap(c, oracle[i], sym) < ORACLE_BOUND, (name, i, c, oracle[i])


def test_full_detect_on_a_cv2_table():
    """ArucoDetector.detect (undistortion and IPPE included) on TAG36h11."""
    gray, oracle = dictionary_frames("TAG36h11")[0]
    got = ArucoDetector("TAG36h11", marker_size=0.6, device="cpu").detect(gray, CAM)
    want = RefDetector("TAG36h11", marker_size=0.6, backend="cv2").detect(gray, REF_CAM)
    assert sorted(got.id[got.valid].tolist()) == sorted(np.asarray(want.id)[np.asarray(want.valid)].tolist()) \
        == sorted(oracle)
    assert np.isfinite(got.pose1[got.valid]).all()


def _flip_cell(name: str, word: int):
    """A code cell whose inversion yields no codeword of the dictionary in
    any rotation (else the flipped marker would decode as another id)."""
    n = dictionary.dict_bits(name)
    codes = {int(w) for w in dictionary.load_codewords(name)}
    for r in range(n):
        for c in range(n):
            bm = dictionary.marker_bitmap(word, name)[1:-1, 1:-1].copy()
            bm[r, c] ^= 1
            rots = [np.rot90(bm, k) for k in range(4)]
            if not any(int("".join(map(str, x.ravel())), 2) in codes for x in rots):
                return r, c
    raise AssertionError(f"every flip of {word} lands on a codeword")


@pytest.mark.parametrize("name,accepted", [("DICT_4X4_1000", False), ("TAG36h11", True)])
def test_one_flipped_bit(name, accepted):
    word = 0
    r, c = _flip_cell(name, word)
    gray, oracle = dictionary_frames(name, flip=(word, r, c))[0]
    assert word in oracle
    port, ref = ArucoDetector(name, marker_size=0.6, device="cpu"), RefDetector(name, marker_size=0.6, backend="cv2")
    ids, ref_ids = port._detect_raw(gray)[0].tolist(), ref._detect_raw(gray)[0]
    others = sorted(set(oracle) - {word})
    assert sorted(ids) == sorted(ref_ids) == sorted(others + [word] * accepted), (ids, ref_ids)
