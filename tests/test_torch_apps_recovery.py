"""The harness's recovery rollback, the port against the JAX package, on the CPU.

`apps.test_sequence --recovery --save-every 17` on a 34-frame TUM tree
written by the JAX package, whose last frame (33) is blank: a checkpoint
is saved at frame 17, tracking is lost at frame 33, more than 15 frames
after it, so the harness reloads the checkpoint, rewinds to frame 18 and
replays, three times (the reference's cap per checkpoint), then carries on.
Both packages' harnesses run in-process on the same tree and parameters,
from the same init: the JAX package's checkpoint of its two-view init,
which each harness's `setParams` loads (the init's outcome is a lottery
over the RANSAC draws, see tests/test_torch_slam.py). The port's
`recoveries=` and the frames it processes, rewinds included, equal the
JAX package's; its pass 1 tracks at least the JAX package's frames - 2.
"""

import contextlib
import io
import json
import os
import re

import numpy as np
import pytest
import torch

from ucoslam_tpu.api import UcoSlam as RefSlam
from ucoslam_tpu.apps import test_sequence as ref_test_sequence
from ucoslam_tpu.config import Params as RefParams
from ucoslam_tpu.geometry.camera import CameraParams as RefCamera
from ucoslam_tpu.io.datasets import TumSequence as RefTum
from ucoslam_tpu.io.datasets import write_synthetic_tum
from ucoslam_tpu.io.synthetic import SyntheticSequence as RefSequence
from ucoslam_tpu_torch.api import UcoSlam
from ucoslam_tpu_torch.apps import test_sequence
from ucoslam_tpu_torch.io import png

torch.set_num_threads(2)

N_FRAMES, BLANK, SAVE_EVERY = 34, 33, 17
CAM = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
PARAMS = RefParams().replace(
    detectMarkers=False, maxDescDistance=60.0, maxKeyPointsPerFrame=256,
    nOctaveLevels=3, maxMapPoints=4096, maxKeyFrames=32,
)


def _carried(cls, init_path: str):
    """cls.setParams, then the checkpoint of the init read in its place."""
    inner = cls.setParams

    def set_params(self, world_map, params, cam, *args, **kwargs):
        inner(self, world_map, params, cam, *args, **kwargs)
        self.readFromFile(init_path, cam)

    return set_params


def _harness(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("recovery")
    root = str(d / "tree")
    cam = RefCamera.create(CAM["fx"], CAM["fy"], CAM["cx"], CAM["cy"], width=CAM["width"], height=CAM["height"])
    write_synthetic_tum(RefSequence(cam=cam, n_frames=N_FRAMES, seed=13, n_points=700), root)
    tum = RefTum.open(root)
    png.imwrite(os.path.join(root, tum.rgb[BLANK][1]), np.full((CAM["height"], CAM["width"]), 40, np.uint8))
    PARAMS.save_yml(str(d / "params.yml"))
    (d / "cam.yml").write_text("".join(f"{k}: {v}\n" for k, v in CAM.items()) + "bl: 0.0\n")
    # the JAX package's two-view init, saved
    init = RefSlam()
    init.setParams(None, PARAMS, cam)
    for i in range(N_FRAMES):
        if init.process(tum.read_rgb(i), fseq=i) is not None:
            break
    init_path = str(d / "init.slm")
    init.saveToFile(init_path)
    args = ["--dataset", root, "--params", str(d / "params.yml"), "--camera", str(d / "cam.yml"), "--voc", "none",
            "--recovery", "--save-every", str(SAVE_EVERY)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(RefSlam, "setParams", _carried(RefSlam, init_path))
        mp.setattr(UcoSlam, "setParams", _carried(UcoSlam, init_path))
        jax_text = _harness(ref_test_sequence.main, args + ["--out-dir", str(d / "jax")])
        port_text = _harness(test_sequence.main, args + ["--out-dir", str(d / "port"), "--device", "cpu"])
    with open(d / "port" / "summary.json") as f:
        summary = json.load(f)
    return jax_text, port_text, summary


def _processed(text: str) -> list:
    """The frames pass 1 processed, in order, as the |@# lines number them."""
    return [int(i) for i in re.findall(r"^\|@# Image (\d+)/\d+ ", text, re.M)]


def _line(text: str) -> dict:
    m = re.search(r"tracked=(\d+)/\d+ pass1_tracked=(\d+)/\d+ recoveries=(\d+)", text)
    return dict(tracked=int(m.group(1)), pass1_tracked=int(m.group(2)), recoveries=int(m.group(3)))


def test_recovery_rollback_equals_reference(runs):
    jax_text, port_text, summary = runs
    got, want = _line(port_text), _line(jax_text)
    assert want["recoveries"] == 3, "the tree is built so that the reference rolls back three times"
    assert got["recoveries"] == want["recoveries"]
    assert _processed(port_text) == _processed(jax_text)
    rewind = SAVE_EVERY + 1  # max(checkpoint frame, lost frame - 15)
    assert [tuple(r) for r in summary["rewinds"]] == [(BLANK, rewind)] * 3
    assert got["pass1_tracked"] >= want["pass1_tracked"] - 2
    assert got["tracked"] >= want["tracked"] - 2
