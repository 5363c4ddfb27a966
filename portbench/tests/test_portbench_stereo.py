"""The stereo cell's comparison fails a broken timed path.

As `test_portbench_faults.py`, on the stereo fleet generator
(`portbench/core/stereo_fleet.py`): a run of `stereo_fleet_explore` driven
on the CPU (device "cpu": the program's plain paths) at a size a test run
holds, first as it is (`correct` true), then with one planted fault of
`portbench/core/stereo_controls.py` underneath (`correct` false). At this
size the limits are the test size's own, set from its sound readings on
376x240 pairs of 24 frames (the EuRoC rig at half its focal length).

    python -m pytest portbench/tests/test_portbench_stereo.py -q   (about 4 minutes)
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

#: the stereo fleet's limits at the test's size (sound: ate_metric_max
#: 0.0071, depth_gap 0; a 5% baseline error reads 0.0162)
STEREO_LIMITS = {"ate_max": 0.2, "pre_init_max": 12, "lost_share": 0.1, "angle_gap_p99": 1e-4,
                 "desc_bit_share": 0.01, "keypoint_gap": 0.05, "ate_metric_max": 0.0105, "depth_gap": 0.01}


def small_context(root: str, control: str | None) -> run.Context:
    cell = manifest.cell(manifest.manifest(), "stereo_fleet_explore")
    cfg = copy.deepcopy(manifest.config(cell["config"]))
    trf = copy.deepcopy(manifest.traffic(cell["traffic"]))
    c = cfg["camera"]
    cfg["camera"] = dict(c, fx=c["fx"] / 2, fy=c["fy"] / 2, cx=c["cx"] / 2, cy=c["cy"] / 2, width=376, height=240)
    cfg["scene"].update(n_frames=24, n_points=800)
    cfg["params"].update(maxKeyPointsPerFrame=512, maxMapPoints=4096, maxKeyFrames=32, nOctaveLevels=4)
    trf.update(streams=2, warm_frames=3, stagger_frames=3, sample_every=3, min_session_poses=3)
    return run.Context(workload=cell["name"], config=cfg, traffic=trf, seed=2**31 + 7, seconds=12.0, trace=False,
                       device="cpu", root=root, control=control, limits=STEREO_LIMITS)


@pytest.fixture(scope="module")
def scratch(tmp_path_factory):
    return str(tmp_path_factory.mktemp("portbench_root"))


@pytest.mark.parametrize("control", [None, "depth_scaled", "depth_dropped", "altered_right", "stale_state",
                                     "altered_pose", "half_batch", "late_init", "lost_frames"])
def test_stereo_faults_fail(control, scratch):
    out = run.execute(small_context(scratch, control))
    assert out["failed"] == 0
    assert out["correct"] is (control is None), out["checks"]


def test_stereo_work_and_readers():
    """The stereo step's work follows from its inputs' valid counts, and the
    span readers read the stereo spans (nothing where none ran)."""
    import torch
    from types import SimpleNamespace

    from portbench.rooflines import peaks, stereo

    n, m = 6, 4
    f = SimpleNamespace(xy=torch.zeros(n, 2), octave=torch.zeros(n, dtype=torch.int32),
                        desc=torch.zeros(n, 8, dtype=torch.int32), valid=torch.tensor([True] * 5 + [False]))
    gray = torch.zeros(10, 20)
    right = (torch.zeros(m, 2), torch.zeros(m, 8, dtype=torch.int32), torch.zeros(m, dtype=torch.int32),
             torch.tensor([True, True, True, False]))
    w = stereo.work(stereo.capture(f, gray, gray, *right, 1.0, 2.0, 60.0))
    assert w["live_pairs"] == 15 and w["popc"] == 8 * 15 and w["int_ops"] == 15 * 15
    assert w["flops"] == 5 * ((121 + 9 * 121) * 13 + 9 * 121 * 3)
    assert w["bytes"] == n * (8 + 4 + 32 + 1) + 2 * 800 + m * (8 + 32 + 4 + 1) + 4 * n
    t, basis = stereo.least_seconds(w)
    assert basis == "float32" and t == pytest.approx(w["flops"] / peaks.FP32_FLOPS)
    tr = {"spans": [[("frontend.extract", 0.0, 0.01, 0), ("frontend.stereo", 0.005, 0.009, 1),
                     ("mapping.new_keyframe", 0.01, 0.1, 0), ("mapping.stereo_points", 0.02, 0.03, 1)]],
          "works": {"stereo": [(4e-6, "popcount")]}, "device_s": {"frontend.stereo": 0.002}}
    read = manifest.metric_reader
    assert read("frontend.stereo_ms")(tr) == pytest.approx(4.0)
    assert read("mapping.stereo_points_ms")(tr) == pytest.approx(10.0)
    assert read("frontend.stereo_roofline")(tr) == pytest.approx(0.2)
    mono = {"spans": [[("frontend.extract", 0.0, 0.01, 0)]], "works": {"B1": [], "B2": []}}
    assert all(read(name)(mono) is None for name in
               ("frontend.stereo_ms", "mapping.stereo_points_ms", "frontend.stereo_roofline"))


def test_stereo_device_time_counts_the_events_its_spans_started():
    """A process's device events are the stereo step's when they start
    inside one of its `frontend.stereo` spans, whatever span holds them."""
    from portbench.core import stereo_fleet

    spans = [("frontend.extract", 0.0, 1.0, 0), ("frontend.stereo", 0.2, 0.4, 1), ("frontend.stereo", 0.6, 0.7, 1)]
    events = [("a", 0.1, 0.3), ("b", 0.25, 0.3), ("c", 0.39, 0.45), ("d", 0.5, 0.55), ("e", 0.6, 0.61),
              ("f", 0.71, 0.8)]
    assert stereo_fleet.span_device_seconds(events, spans, "frontend.stereo") == pytest.approx(0.05 + 0.06 + 0.01)
    assert stereo_fleet.span_device_seconds(events, spans, "mapping.stereo_points") == 0.0
