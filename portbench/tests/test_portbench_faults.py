"""The comparison that decides `correct` fails a broken timed path.

Each test skips the harness's look for a card and drives the rest of a run
on the CPU (`run.execute` with device "cpu": the program's plain paths) at
a size a test run holds, first as it is (`correct` true), then with one
planted fault of `portbench/core/controls.py` underneath (`correct`
false). At this size the limits are the test size's own, set from its
sound readings on 320x240 clips of 24 frames.

    python -m pytest portbench/tests/test_portbench_faults.py -q   (about 4 minutes)
"""

from __future__ import annotations

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import run  # noqa: E402
from portbench.core import manifest  # noqa: E402

#: the fleet's limits at the test's size
FLEET_LIMITS = {"ate_max": 0.2, "pre_init_max": 12, "lost_share": 0.1, "angle_gap_p99": 1e-4,
                "desc_bit_share": 0.01, "keypoint_gap": 0.05}


def small_context(workload: str, root: str, control: str | None) -> run.Context:
    man = manifest.manifest()
    cell = manifest.cell(man, workload)
    cfg = copy.deepcopy(manifest.config(cell["config"]))
    trf = copy.deepcopy(manifest.traffic(cell["traffic"]))
    cfg["camera"] = {"fx": 517.3 / 2, "fy": 516.5 / 2, "cx": 318.6 / 2, "cy": 255.3 / 2, "width": 320,
                     "height": 240}
    cfg["scene"].update(n_frames=24, n_points=800)
    cfg["params"].update(maxKeyPointsPerFrame=512, maxMapPoints=4096, maxKeyFrames=32, nOctaveLevels=4)
    trf.update(mode="slam", streams=2, warm_frames=3, stagger_frames=3, sample_every=3, min_session_poses=3)
    return run.Context(workload=workload, config=cfg, traffic=trf, seed=2**31 + 7, seconds=12.0, trace=False,
                       device="cpu", root=root, control=control, limits=FLEET_LIMITS)


@pytest.fixture(scope="module")
def scratch(tmp_path_factory):
    return str(tmp_path_factory.mktemp("portbench_root"))


@pytest.mark.parametrize("control", [None, "stale_state", "half_batch", "altered_pose", "altered_desc", "late_init",
                                     "lost_frames"])
def test_fleet_faults_fail(control, scratch):
    out = run.execute(small_context("mono_fleet_explore", scratch, control))
    assert out["failed"] == 0
    assert out["correct"] is (control is None), out["checks"]
