"""Marker SLAM with a dictionary the reference reads through cv2 (TAG36h11), on the CPU.

The `markers` parity scene (ten 0.6 m markers, tools/parity/run_parity.py)
with its markers drawn as TAG36h11 codewords by the port's renderer
(`tools/port/marker_render.py`), cut to 14 frames at 512 keypoints; the
same pixels through the JAX package (`aruco_Dictionary` TAG36h11: its cv2
backend, `tools/port/make_reference_map.marker_dictionary_run`) and through
the port (`UcoSlam(device="cpu")`: the native detector with cv2's table and
its 3-bit correction). Held as chip_smoke.py phase 8 holds the
ARUCO_MIP_36h12 pass: tracked >= JAX's - 2, metric ATE (no scale
alignment) <= 1.2 x JAX's + 0.002, markers with a map pose >= JAX's - 1;
and on every fourth frame the port's detector finds every id the
reference's cv2 backend finds, and none outside the scene.
"""

import numpy as np
import torch

from chip_smoke import marker_errors, metric_summary
from tools.port.make_reference_map import MARKER_PARAMS, marker_dictionary_run
from tools.port.marker_render import dictionary_scene
from ucoslam_tpu.markers.detector import ArucoDetector as RefDetector
from ucoslam_tpu_torch.api import UcoSlam
from ucoslam_tpu_torch.config import Params
from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.markers.detector import ArucoDetector

torch.set_num_threads(2)

FRAMES = 14
SMALL = MARKER_PARAMS.replace(maxKeyPointsPerFrame=512, maxMapPoints=4096, maxKeyFrames=32)


def test_tag36h11_slam_pass_against_reference():
    ref = marker_dictionary_run("TAG36h11", FRAMES, params=SMALL)
    assert ref["backend"] == "cv2"
    j1 = ref["pass1"]
    cam = CameraParams.create(500.0, 500.0, 320.0, 240.0)
    seq, ids, images, truth = dictionary_scene("TAG36h11", ref["sequence"], cam=cam)
    assert {str(k): v for k, v in ids.items()} == ref["ids"]
    slam = UcoSlam(device="cpu")
    slam.setParams(None, Params().replace(**ref["params"]), cam)
    assert slam._extractor.marker_detector.spec.max_correction == 3
    poses = {}
    for i, img in enumerate(images):
        pose = slam.process(img, fseq=i)
        if pose is not None:
            poses[i] = pose
    ms = metric_summary(poses, seq)
    me = marker_errors(*slam.map.h("mk_id", "mk_pose", "mk_pose_valid"), poses, seq, truth)
    assert len(poses) >= j1["tracked"] - 2, (len(poses), j1["tracked"])
    assert ms["metric_ate"] <= 1.2 * j1["metric_ate"] + 0.002, (ms["metric_ate"], j1["metric_ate"])
    assert me["markers_posed"] >= j1["markers_posed"] - 1, (me["markers_posed"], j1["markers_posed"])
    assert me["markers_posed"] >= 1 and slam._system.manager.metric_locked
    # frame by frame: every marker the reference's cv2 backend finds, and no
    # id that is not in the scene (on this scene the port also finds
    # markers cv2 rejects, near the image's edge: tests/test_torch_dictionaries.py
    # holds equal ids on frames where every marker is in full view)
    port, cv2_ref = ArucoDetector("TAG36h11", 0.6, device="cpu"), RefDetector("TAG36h11", 0.6, backend="cv2")
    for img in images[::4]:
        gray = np.clip(img, 0, 255).astype(np.uint8)
        got, want = set(port._detect_raw(gray)[0].tolist()), set(cv2_ref._detect_raw(gray)[0])
        assert want <= got <= set(truth), (sorted(got), sorted(want))
