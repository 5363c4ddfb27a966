"""The program's span tracer (`ucoslam_tpu_torch.utils.timers`) on the CPU.

- With tracing off, a SLAM run builds no span; with it on, the poses are
  the same, every frame has one `slam.process` root, every span lies inside
  its parent on the parent's thread and frame, and each local BA splits
  into `ba.build`, `ba.solve` (its LM steps below it) and `ba.apply`.
- In async mode the mapper's worker nests its spans under its own
  `mapping.new_keyframe` roots, which carry the keyframe's frame.
- Counters attach to the innermost open span; runtime calls of a device
  trace land in the innermost span of their thread (`attribute`); the
  clock's offset comes from marks; `profile_trace` writes the spans beside
  the profiler's events on one clock.
- `tools/port/trace_fleet.py`'s per-layer readings, on hand-made spans.
"""

import importlib
import json
import threading

import numpy as np
import pytest
import torch

from tools.port import trace_fleet
from ucoslam_tpu_torch.api import UcoSlam
from ucoslam_tpu_torch.config import Params
from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.io.synthetic import SyntheticSequence
from ucoslam_tpu_torch.utils.timers import DeviceEvents, StageTimers, attribute, timers, tracing

tm = importlib.import_module("ucoslam_tpu_torch.utils.timers")  # the module (`utils.timers` names the tracer)

torch.set_num_threads(2)

PARAMS = Params().replace(
    detectMarkers=False, maxDescDistance=60.0, maxKeyPointsPerFrame=512,
    nOctaveLevels=4, maxMapPoints=4096, maxKeyFrames=32,
)
CAM = CameraParams.create(500.0, 500.0, 320.0, 240.0)
N_FRAMES = 12
LAYER_SPANS = {
    "slam.process", "slam.initialize", "frontend.extract", "frontend.upload", "frontend.detect",
    "frontend.describe", "frontend.pack", "tracking.track", "tracking.project_match", "tracking.refine",
    "mapping.new_keyframe", "mapping.insert", "mapping.new_points", "mapping.stereo_points", "mapping.fuse", "mapping.cull",
    "mapping.kfdb", "mapping.loop", "ba.local_ba", "ba.build", "ba.solve", "ba.lm_step", "ba.apply",
}


@pytest.fixture(scope="module")
def images():
    seq = SyntheticSequence(cam=CAM, n_frames=N_FRAMES, seed=13, n_points=700)
    return [seq.render(i) for i in range(N_FRAMES)]


def run_slam(images, params=PARAMS):
    slam = UcoSlam(device="cpu")
    slam.setParams(None, params, CAM)
    poses = [slam.process(img, fseq=i) for i, img in enumerate(images)]
    slam.waitForFinished()
    return slam, poses


def _no_span(*args, **kwargs):
    raise AssertionError("a span was built while tracing was off")


@pytest.fixture(scope="module")
def runs(images):
    """The sequence with tracing off (building a span fails) and on."""
    assert not timers.enabled
    timers.drain()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tm, "Span", _no_span)
        off = run_slam(images)
    off_spans = timers.drain()
    with tracing():
        on = run_slam(images)
        spans = timers.drain()
    return off, off_spans, on, spans


def test_tracing_off_records_no_span(runs):
    (_, poses), off_spans, _, _ = runs
    assert off_spans == []
    assert sum(p is not None for p in poses) >= N_FRAMES - 2


def test_poses_equal_with_tracing_on_and_off(runs):
    (_, off), _, (_, on), _ = runs
    assert [p is None for p in off] == [p is None for p in on]
    for a, b in zip(off, on):
        if a is not None:
            np.testing.assert_array_equal(a, b)


def test_one_root_per_frame(runs):
    _, _, (slam, _), spans = runs
    roots = [s for s in spans if s.parent == 0]
    assert [s.name for s in roots] == ["slam.process"] * N_FRAMES
    assert sorted(s.frame for s in roots) == [(slam._session, i) for i in range(N_FRAMES)]
    assert LAYER_SPANS <= {s.name for s in spans}


def test_spans_lie_inside_their_parents(runs):
    _, _, _, spans = runs
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        assert s.start <= s.end
        if s.parent:
            p = by_id[s.parent]
            assert p.start <= s.start and s.end <= p.end, (s.name, p.name)
            assert s.frame == p.frame and s.thread == p.thread


def test_local_ba_splits_into_build_solve_apply(runs):
    _, _, _, spans = runs
    by_id = {s.id: s for s in spans}
    kids: dict[int, list] = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    calls = [s for s in spans if s.name == "ba.local_ba"]
    assert calls
    for ba in calls:
        names = [k.name for k in kids[ba.id]]
        assert names == ["ba.build", "ba.solve", "ba.apply"], names
        solve = kids[ba.id][1]
        assert [k.name for k in kids[solve.id]] == ["ba.lm_step"] * 20  # 2 stages x 10 steps
    assert all(by_id[s.parent].name == "ba.solve" for s in spans if s.name == "ba.lm_step")


def test_async_worker_spans_form_their_own_chain(images):
    with tracing():
        timers.drain()
        slam, _ = run_slam(images, PARAMS.replace(runSequential=False))
        spans = timers.drain()
    slam.clear()
    main = threading.get_ident()
    by_id = {s.id: s for s in spans}
    worker = [s for s in spans if s.thread != main]
    roots = [s for s in worker if s.parent == 0]
    assert roots and {s.name for s in roots} == {"mapping.new_keyframe"}
    processed = {s.frame for s in spans if s.name == "slam.process"}
    assert {s.frame for s in roots} <= processed
    for s in worker:
        if s.parent:
            assert by_id[s.parent].thread == s.thread and by_id[s.parent].frame == s.frame
    assert {"ba.local_ba", "mapping.insert"} <= {s.name for s in worker}
    assert not any(s.name.startswith("mapping.") for s in spans if s.thread == main)


def test_counters_attach_to_the_innermost_span():
    tr = StageTimers()
    tr.count("B1")  # off: not counted
    tr.start()
    with tr.span("outer", 3, 7):
        tr.count("B1")
        with tr.span("inner"):
            tr.count("B1")
            tr.count("B2")
        t = threading.Thread(target=lambda: tr.count("B2"))
        t.start()
        t.join()
    tr.count("B2")  # outside every span: the totals only
    spans = {s.name: s for s in tr.drain()}
    assert spans["outer"].counts == {"B1": 1} and spans["inner"].counts == {"B1": 1, "B2": 1}
    assert spans["inner"].frame == (3, 7) and spans["inner"].parent == spans["outer"].id
    assert tr.counters() == {"B1": 2, "B2": 3}
    assert tr.report() == "" and tr.drain() == []


def _span(name, start, end, sid, parent, thread=1, counts=None):
    return (name, start, end, sid, parent, 1, 0, thread, counts or {})


def test_attribute_runtime_calls_to_innermost_spans():
    spans = [_span("outer", 0, 100, 1, 0), _span("inner", 10, 40, 2, 1), _span("other", 0, 100, 3, 0, thread=2)]
    device = [("k1", 5, 6, 11), ("k2", 20, 25, 12), ("k3", 50, 51, 13), ("Memcpy HtoD (Pageable -> Device)", 60, 61, 14),
              ("k4", 200, 201, 15), ("k5", 90, 95, 16)]
    key1, key2 = tm.thread_key(1), tm.thread_key(2)
    runtime = [
        ("cudaLaunchKernel", 2, 3, 11, key1),  # outer
        ("cudaLaunchKernel", 12, 13, 12, key1),  # inner
        ("cudaStreamSynchronize", 30, 38, 99, key1),  # inner: a wait
        ("cudaLaunchKernel", 45, 46, 13, key1),  # outer again, after inner ended
        ("cudaLaunchKernelExC", 47, 48, 17, key1),  # outer: a launch whose kernel's record is lost
        ("cudaMemcpyAsync", 55, 58, 14, key1),  # outer: a pageable copy, a wait and no launch
        ("cudaLaunchKernel", 150, 151, 15, key1),  # outside every span
        ("cudaLaunchKernel", 20, 21, 16, key2),  # the other thread's span
    ]
    got = attribute(spans, DeviceEvents(device=device, runtime=runtime, clock_error_ns=0.0))
    assert got[1] == {"launches": 3, "wait_ns": 3, "kernel_ns": 2}
    assert got[2] == {"launches": 1, "wait_ns": 8, "kernel_ns": 5}
    assert got[3] == {"launches": 1, "wait_ns": 0.0, "kernel_ns": 5}
    assert got[0] == {"launches": 1, "wait_ns": 0.0, "kernel_ns": 1}
    # a trace that names threads by another id: the same calls, the same spans
    native = [c[:4] + ({key1: 501, key2: 502}[c[4]],) for c in runtime]
    again = attribute(spans, DeviceEvents(device=device, runtime=native, clock_error_ns=0.0, threads={1: 501, 2: 502}))
    assert again == got


def test_clock_offset_from_marks():
    """Marks pair in order with the events they made, past another
    session's events, one the trace lost is left out, a run of launches that
    does not share their gaps never pairs, and the pairs bound the offset."""
    off = 1_000_000_007
    marks = tm.Marks.__new__(tm.Marks)
    t, marks.marks = 0, []
    for i in range(8):
        t += i * tm.MARK_GAP_NS + 30
        marks.marks.append((t, t + 40))
    rng = np.random.default_rng(0)
    events = []
    for a, _ in marks.marks:
        s = a + int(rng.integers(1, 30))
        events.append((s + off, s + 5 + off))
    after = [(events[-1][0] + k * tm.MARK_GAP_NS, events[-1][0] + k * tm.MARK_GAP_NS + 5) for k in (1, 2)]
    before = [(events[0][0] - k * 1000, events[0][0] - k * 1000 + 5) for k in (9, 7, 5)]  # another session's
    assert marks.pair(before + events + after, first=True) == (marks.marks, events)
    assert marks.pair(before + events + after[:0], first=False) == (marks.marks, events)
    lost = before + events[:3] + events[4:] + after
    got_marks, got_events = marks.pair(lost, first=True)
    assert got_marks == marks.marks[:3] + marks.marks[4:] and got_events == events[:3] + events[4:]
    got, err = tm._offset(got_marks, got_events)
    assert abs(got - off) <= err <= 20
    with pytest.raises(RuntimeError, match="agrees with the 8 clock marks"):
        marks.pair([(off + k * tm.MARK_GAP_NS, off + k * tm.MARK_GAP_NS + 5) for k in range(10)], first=True)


def test_profile_trace_writes_spans_on_the_trace_clock(tmp_path):
    with tm.profile_trace(str(tmp_path)):
        with timers.span("outer"):
            torch.ones(4096).add_(1)
    assert not timers.enabled
    events = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    outer = [e for e in events if e.get("pid") == "program spans" and e.get("name") == "outer"]
    assert len(outer) == 1
    t0, t1 = outer[0]["ts"], outer[0]["ts"] + outer[0]["dur"]
    op = [e for e in events if e.get("name") == "aten::add_" and e.get("ph") == "X"]
    assert op and all(t0 - 20 <= e["ts"] and e["ts"] + e["dur"] <= t1 + 20 for e in op)


def test_trace_fleet_layer_readings():
    """Launches and waits inside a layer, less a child layer, per frame,
    keyframe or call; calls outside every span count nowhere; the launch
    counters a frame."""
    spans = [
        _span("frontend.extract", 0, 10, 1, 0), _span("frontend.detect", 1, 5, 2, 1, counts={"F1": 1, "F2": 1}),
        _span("tracking.track", 10, 20, 3, 0, counts={"B1": 2}),
        _span("mapping.new_keyframe", 20, 80, 4, 0), _span("mapping.fuse", 21, 30, 5, 4),
        _span("ba.local_ba", 30, 70, 6, 4), _span("ba.build", 30, 40, 7, 6), _span("ba.solve", 40, 60, 8, 6),
        _span("ba.lm_step", 41, 50, 9, 8),
        _span("frontend.extract", 80, 90, 10, 0), _span("frontend.detect", 81, 85, 11, 10, counts={"F1": 1, "F2": 1}),
    ]

    def row(n, w=0.0):
        return {"launches": n, "wait_ns": w, "kernel_ns": 0.0}

    stats = {1: row(3), 2: row(10, 2e6), 3: row(4, 1e6), 4: row(1), 5: row(2, 4e6), 6: row(1), 7: row(0, 3e6),
             9: row(20), 10: row(5), 0: row(100, 9e6)}
    got = trace_fleet.program_metrics([{"spans": spans, "stats": stats}])
    assert got["frontend.launches_per_frame"] == (3 + 10 + 5) / 2
    assert got["tracking.launches_per_frame"] == 4 / 2
    assert got["mapping.launches_per_keyframe"] == 1 + 2
    assert got["ba.launches_per_call"] == 1 + 20
    assert got["frontend.wait_ms"] == pytest.approx(1.0)
    assert got["tracking.wait_ms"] == pytest.approx(0.5)
    assert got["mapping.wait_ms"] == pytest.approx(4.0)
    assert got["ba.wait_ms"] == pytest.approx(3.0)
    assert got["ba.build_ms"] == pytest.approx(1e-5)
    assert (got["counter.F1_per_frame"], got["counter.F2_per_frame"], got["counter.B1_per_frame"]) == (1, 1, 1)
    # nothing to read: the keyframe and BA readings are left out
    got = trace_fleet.program_metrics([{"spans": spans[:3], "stats": stats}])
    assert set(got) == {"frontend.launches_per_frame", "tracking.launches_per_frame", "frontend.wait_ms",
                        "tracking.wait_ms", "counter.B1_per_frame", "counter.F1_per_frame", "counter.F2_per_frame"}
    assert [d for _, _, _, d in trace_fleet.depth_spans(spans)] == [0, 1, 0, 0, 1, 1, 2, 2, 3, 0, 1]


def test_trace_fleet_stereo_readings():
    """The stereo step's and the stereo points' launches and waits, per
    frame and per keyframe; left out where no span of theirs ran."""
    spans = [
        _span("frontend.extract", 0, 10, 1, 0), _span("frontend.stereo", 5, 9, 2, 1),
        _span("mapping.new_keyframe", 10, 40, 3, 0), _span("mapping.new_points", 11, 30, 4, 3),
        _span("mapping.stereo_points", 11, 20, 5, 4),
        _span("frontend.extract", 40, 50, 6, 0), _span("frontend.stereo", 45, 49, 7, 6),
    ]
    stats = {1: {"launches": 4, "wait_ns": 0.0, "kernel_ns": 0.0}, 2: {"launches": 30, "wait_ns": 1e6, "kernel_ns": 0.0},
             4: {"launches": 8, "wait_ns": 0.0, "kernel_ns": 0.0}, 5: {"launches": 6, "wait_ns": 3e6, "kernel_ns": 0.0},
             7: {"launches": 30, "wait_ns": 3e6, "kernel_ns": 0.0}}
    got = trace_fleet.program_metrics([{"spans": spans, "stats": stats}])
    assert got["frontend.stereo_launches_per_frame"] == 30 and got["frontend.launches_per_frame"] == 32
    assert got["frontend.stereo_wait_ms"] == pytest.approx(2.0)
    assert got["mapping.stereo_points_launches_per_keyframe"] == 6
    assert got["mapping.stereo_points_wait_ms"] == pytest.approx(3.0)
    mono = [s for s in spans if s[0] not in ("frontend.stereo", "mapping.stereo_points")]
    got = trace_fleet.program_metrics([{"spans": mono, "stats": stats}])
    assert not any("stereo" in k for k in got) and got["mapping.launches_per_keyframe"] == 8


def test_trace_fleet_idle_gaps_by_program_span():
    """The benchmark's idle arithmetic on the program's spans: an idle
    stretch goes to the innermost span at its middle; launches outside every
    span count in no layer's share."""
    sec = 1_000_000_000
    spans = [_span("frontend.extract", 0, sec, 1, 0), _span("frontend.detect", 0, sec // 2, 2, 1)]
    device = [("k", sec // 2, sec, 7), ("k", sec + 10, sec + 20, 8)]
    runtime = [("cudaLaunchKernel", 10, 20, 7, tm.thread_key(1)), ("cudaLaunchKernel", sec + 1, sec + 2, 8, tm.thread_key(1))]
    tr = {"program_spans": spans, "device": device, "runtime": runtime, "clock_error_ns": 5.0, "threads": {},
          "events": [("k", 0.5, 1.0)]}
    merged = {"frames": 1, "events_kernels": 2, "breakdown": {"idle_gaps": [["frontend.extract", 0.5]]}}
    got = trace_fleet.summarize([tr], merged, 0.0, 1.0)
    assert got["idle_gaps_program"] == [["frontend.detect", 0.5]]
    cov = got["coverage"]
    assert cov["launched_in_spans"] == 1 and cov["launched_outside"] == 1
    assert cov["launch_shares"]["frontend"] == 0.5 and cov["frontend_tracking_share"] == 0.5
    assert got["metrics"]["frontend.launches_per_frame"] == 1
