"""CPU tests of the benchmark's harness (no card needed):

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.core import fleet, guard, manifest, stats, trace  # noqa: E402
from portbench.rooflines import b1, b2, peaks  # noqa: E402


class FakeSlam:
    """A session that poses nothing for its first `init` frames, then loses
    every `lose_every`-th frame, taking `dt` seconds a frame."""

    def __init__(self, init=5, lose_every=7, dt=0.002):
        self.n, self.init, self.lose_every, self.dt = 0, init, lose_every, dt

    def process(self, img, fseq):
        time.sleep(self.dt)
        self.n += 1
        if self.n <= self.init or self.n % self.lose_every == 0:
            return None
        return np.eye(4, dtype=np.float32)

    def clear(self):
        pass


def fake_stream(dt: float, n_frames: int = 40) -> fleet.Stream:
    s = fleet.Stream.__new__(fleet.Stream)
    s.mode = "slam"
    s.image, s.n = np.zeros((n_frames, 4, 4), np.uint8), n_frames
    s.pos, s.direction, s.count, s.capture_next, s.captured = 0, 1, 0, False, []
    s.sessions = []

    def new_session():
        s.slam = FakeSlam(dt=dt)
        s.sessions.append({"poses": [], "pre_init": 0, "lost": 0, "ended": False})

    s.new_session = new_session
    new_session()
    return s


@pytest.mark.parametrize("dt", [0.002, 0.004])
def test_failures_do_not_move_with_speed(dt):
    """At two speeds: failed stays 0, attempted scales with the speed, and
    frames before a session's first pose or lost by the tracker are no
    failures."""
    s = fake_stream(dt)
    records, attempted, failed, errors = fleet.window_loop(s, time.perf_counter() + 0.6, np.random.default_rng(0), 4)
    assert failed == 0 and not errors
    assert attempted == len(records)
    expected = 0.6 / dt
    assert 0.4 * expected < attempted <= 1.05 * expected
    pre = sum(x["pre_init"] for x in s.sessions)
    lost = sum(x["lost"] for x in s.sessions)
    posed = sum(len(x["poses"]) for x in s.sessions)
    assert pre >= 5 and lost > 0 and pre + lost + posed == attempted
    assert all(x["ended"] for x in s.sessions[:-1]) and not s.sessions[-1]["ended"]


def test_a_short_session_fails_its_trajectory_only_when_it_ended():
    """A session cut short by the window is not judged; one that reached its
    clip's end with too few poses reads as a failed trajectory."""
    def session(poses, ended, ate=0.02):
        return {"poses": poses, "ended": ended, "ate": ate if poses >= 3 else None}

    assert fleet.session_ates([session(40, True), session(4, False, None)], 10) == [0.02]
    assert fleet.session_ates([session(40, True), session(4, True)], 10) == [0.02, float("inf")]
    assert fleet.session_ates([session(0, True)], 10) == [float("inf")]


def test_raised_and_malformed_frames_fail():
    s = fake_stream(0.0)

    class Broken(FakeSlam):
        def process(self, img, fseq):
            self.n += 1
            if self.n == 3:
                raise RuntimeError("boom")
            if self.n == 4:
                return np.full((4, 4), np.nan, np.float32)
            return np.eye(4, dtype=np.float32)

    s.slam = Broken()
    results = [s.step() for _ in range(3)]
    assert [r[0] for r in results] == [False, False, True]
    s.slam = Broken()
    s.slam.n = 3
    bad, err = s.step()
    assert bad and "malformed" in err


def test_end_to_end_arithmetic_over_the_whole_window():
    recs = [(0.0, 0.1), (0.1, 0.3), (0.3, 0.35), (0.35, 1.2), (1.2, 1.25)]
    assert stats.window_ops(recs, 0.0, 1.0) == recs[:3]
    assert stats.fps(recs, 0.0, 1.0) == pytest.approx(3.0)
    assert stats.p95_ms(recs, 0.0, 1.0) == pytest.approx(1e3 * float(np.percentile([0.1, 0.2, 0.05], 95)))
    with pytest.raises(ValueError):
        stats.p95_ms([(0.0, 2.0)], 0.0, 1.0)


def test_b1_work_follows_from_the_inputs():
    P, N = 6, 4
    desc_a, desc_b = torch.zeros(P, 8, dtype=torch.int32), torch.zeros(N, 8, dtype=torch.int32)
    uv_a = torch.tensor([[0.0, 0], [10, 0], [100, 100], [0, 1], [50, 50], [0, 0]])
    uv_b = torch.tensor([[0.0, 0], [10, 0], [300, 300], [0, 2]])
    oct_a, oct_b = torch.tensor([0, 0, 0, 3, 0, 0], dtype=torch.int32), torch.zeros(N, dtype=torch.int32)
    valid_a = torch.tensor([True, True, True, True, True, False])
    valid_b = torch.tensor([True, True, True, False])
    radius2 = torch.full((N,), 4.0)
    w = b1.work((desc_a, uv_a, oct_a, valid_a, desc_b, uv_b, oct_b, valid_b, radius2))
    assert w["live_pairs"] == 5 * 3
    assert w["gated_pairs"] == 2  # (0, 0) and (1, 1); row 3 is 3 octaves off
    assert w["popc"] == 8 * 2 and w["int_ops"] == 8 * 15 + 17 * 2
    assert w["bytes"] == P * (32 + 8 + 4 + 1) + N * (32 + 8 + 4 + 1 + 4) + 12 * P
    t, basis = b1.least_seconds(w)
    assert basis == "bytes" and t == pytest.approx(w["bytes"] / peaks.HBM_BYTES_PER_S)


def test_b2_work_follows_from_the_inputs():
    valid = torch.tensor([True] * 700 + [False] * 300)
    rec = b2.capture(torch.eye(4), torch.zeros(1000, 3), torch.zeros(1000, 2), torch.ones(1000), valid,
                     1.0, 1.0, 0.0, 0.0, iters=10, rounds=4)
    w = b2.work(rec)
    assert w["flops"] == 700 * 10 * 4 * 222 and w["rows"] == 700
    assert w["bytes"] == 128 + 1000 * 26
    t, basis = b2.least_seconds(w)
    assert basis == "float32" and t == pytest.approx(w["flops"] / peaks.FP32_FLOPS)


def test_manifest_names_and_units_hold_the_allowed_characters():
    man = manifest.manifest()
    assert manifest.check_names(man) == []
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    bad = json.loads(json.dumps(man))
    bad["per_layer"][0]["name"] = "bad name"
    bad["end_to_end"][0]["unit"] = "frames per second"
    faults = manifest.check_names(bad)
    assert any("bad name" in f for f in faults) and any("frames per second" in f for f in faults)


def test_every_cell_reports_what_its_metrics_move():
    man = manifest.manifest()
    for w in man["workloads"]:
        e2e = {m["name"] for m in manifest.metrics_of(man, "end_to_end", w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = manifest.metrics_of(man, "per_layer", w["name"])
        assert layers and all(m["moves"] in e2e for m in layers)
        assert os.path.exists(os.path.join(manifest.PORTBENCH, "limits", f"{w['name']}.json"))
    for m in man["per_layer"]:
        manifest.metric_reader(m["name"])  # every metric has its reader


def test_a_generator_dropped_into_core_is_found_by_name(tmp_path, monkeypatch):
    import portbench.core

    assert manifest.generator("fleet") is fleet
    (tmp_path / "new_gen.py").write_text("def run(ctx):\n    return {'ran': ctx}\n")
    monkeypatch.setattr(portbench.core, "__path__", [*portbench.core.__path__, str(tmp_path)])
    assert manifest.generator("new_gen").run(7) == {"ran": 7}
    with pytest.raises(ValueError):
        manifest.generator("core.fleet")


def test_files_dropped_into_their_folders_are_found_by_name(tmp_path):
    copy = tmp_path / "portbench"
    shutil.copytree(manifest.PORTBENCH, copy, ignore=shutil.ignore_patterns("__pycache__"))
    mod = manifest.load_module(str(copy / "core" / "manifest.py"), "portbench_manifest_copy")
    (copy / "configs" / "new_cfg.json").write_text(json.dumps({"name": "new_cfg", "sensor": "mono"}))
    (copy / "traffic" / "new_mix.json").write_text(json.dumps({"generator": "fleet", "streams": 2}))
    (copy / "limits" / "new_cell.json").write_text(json.dumps({"ate_max": 0.1}))
    (copy / "metrics" / "new.metric_ms.py").write_text("def read(trace):\n    return 1.5\n")
    assert mod.config("new_cfg")["sensor"] == "mono"
    assert mod.traffic("new_mix")["streams"] == 2
    assert mod.limits("new_cell") == {"ate_max": 0.1}
    assert mod.metric_reader("new.metric_ms")({}) == 1.5


def test_the_jax_check_compares_whole_top_level_names():
    mods = ["jax.numpy", "ucoslam_tpu.api", "ucoslam_tpu_torch.api", "jaxtyping", "flax", "numpy"]
    assert guard.forbidden_loaded(mods) == ["flax", "jax", "ucoslam_tpu"]
    assert guard.forbidden_loaded(["ucoslam_tpu_torch", "jaxlib_extra"]) == []


def test_trace_arithmetic_merges_processes_on_one_timeline():
    events = [("k1", 0.0, 1.0), ("k2", 0.5, 1.5), ("Memcpy HtoD", 3.0, 3.5), ("k3", 5.0, 6.0)]
    assert trace.busy_seconds(events, 0.0, 10.0) == pytest.approx(3.0)
    assert trace.idle_gaps(events, 0.0, 10.0) == [(1.5, 3.0), (3.5, 5.0), (6.0, 10.0)]
    spans = [[("frontend.extract", 1.0, 4.0, 0)], [("ba.local_ba", 0.0, 10.0, 0), ("mapping.new_keyframe", 0.0, 9.0, 1)]]
    gaps = dict(trace.gaps_by_span(events, spans, 0.0, 10.0))
    assert gaps["frontend.extract"] == pytest.approx(0.75)
    assert gaps["mapping.new_keyframe"] == pytest.approx(0.5 * 7.0)
    assert gaps["harness"] == pytest.approx(0.5 * 5.5)
    assert trace.is_kernel("k1") and not trace.is_kernel("Memset (Device)")
    table = trace.kernel_table(events, 0.0, 10.0)
    assert table["k1"] == {"count": 1, "seconds": 1.0}


def test_span_readers():
    tr = {"spans": [[("frontend.extract", 0.0, 0.02, 0), ("tracking.track", 0.02, 0.03, 0),
                     ("ba.local_ba", 0.05, 0.15, 1), ("mapping.new_keyframe", 0.03, 0.2, 0),
                     ("frontend.extract", 0.2, 0.22, 0)]],
          "kernels": {"void project_match_kernel(Inputs, int)": {"count": 2, "seconds": 4e-5}},
          "works": {"B1": [(1e-6, "bytes"), (3e-6, "bytes")], "B2": []}}
    read = manifest.metric_reader
    assert read("frontend.extract_ms")(tr) == pytest.approx(20.0)
    assert read("tracking.track_ms")(tr) == pytest.approx(5.0)
    assert read("mapping.keyframe_self_ms")(tr) == pytest.approx(70.0)
    assert read("ba.local_ba_ms")(tr) == pytest.approx(100.0)
    assert read("kernels.b1_roofline")(tr) == pytest.approx(10.0)
    assert read("kernels.b2_roofline")(tr) is None  # nothing to read: left out of the line


def test_a_streams_plan_deals_the_same_scenes_in_another_order():
    mix = manifest.traffic("fleet_explore")
    n = mix["streams"]
    a, b = fleet.plan(mix, 1, n, 150), fleet.plan(mix, 2**31 + 11, n, 150)
    assert sorted(p["scene_seed"] for p in a) == sorted(p["scene_seed"] for p in b) == sorted(mix["scene_seeds"])
    assert [p["warm"] for p in a] == [mix["warm_frames"] + i * mix["stagger_frames"] for i in range(n)]
    assert fleet.plan(mix, 1, n, 150) == a
    assert fleet.n_streams_for(mix, n + 2) == n and fleet.n_streams_for(mix, n + 1) == n - 1


def test_descriptor_judged_at_the_programs_bin_with_ties_either_side():
    """A keypoint whose angle sits on a bin boundary, to rounding, may carry
    either neighbouring bin's descriptor; off a boundary, only its own."""
    from portbench.reference import orb

    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (120, 160)).astype(np.uint8)
    xy = np.array([[60.0, 50.0], [80.0, 60.0]])
    octave = np.zeros(2, np.int64)
    step = 2 * np.pi / orb.DESC_BINS
    on_tie, off_tie = np.array([-7.5 * step] * 2), np.array([-7.2 * step] * 2)
    _, at7, at8 = orb.describe(img, xy, octave, 1, 1.2, angle_for_bins=on_tie)
    assert (np.unpackbits((at7 ^ at8).view(np.uint8), axis=1).sum(1) > 20).all()
    for words in (at7, at8):
        assert (orb.compare(img, xy, octave, on_tie, words, 1, 1.2)["bit_diffs"] == 0).all()
    _, own, alt = orb.describe(img, xy, octave, 1, 1.2, angle_for_bins=off_tie)
    assert (own == alt).all()
    assert (orb.compare(img, xy, octave, off_tie, at8, 1, 1.2)["bit_diffs"] > 20).all()


def test_keypoint_reference_finds_the_programs_keypoints():
    """The reference's detection agrees with the port's extractor on a
    rendered frame, up to rounding (a keypoint of a float level's plateau
    may sit a pixel over), and a shifted keypoint set does not."""
    from portbench.reference import orb
    from ucoslam_tpu_torch.features.orb import ORBExtractor

    cam = {"fx": 258.65, "fy": 258.25, "cx": 159.3, "cy": 127.65, "width": 320, "height": 240}
    sc = manifest.scene_module("quads").make({"renderer": "quads", "n_points": 800, "n_frames": 24,
                                              "trajectory": "arc"}, cam, 5)
    img = np.clip(np.rint(sc.render(3)), 0, 255).astype(np.uint8)
    k = ORBExtractor(max_features=512, n_levels=4, scale_factor=1.2).detect_and_compute(torch.from_numpy(img).float())
    v = k.valid.numpy()
    xy, octave = k.xy.numpy()[v], k.octave.numpy()[v]
    settings = dict(n_levels=4, scale_factor=1.2, max_features=512, cell=32, k_per_cell=4, threshold=7.0)
    diff, both = orb.keypoint_gap(img, xy, octave, **settings)
    assert both == 2 * 512 and diff / both < 0.01
    diff, _ = orb.keypoint_gap(img, xy + np.array([3.0, 0.0]) * 1.2 ** octave[:, None], octave, **settings)
    assert diff / both > 0.5
    diff, both = orb.keypoint_gap(img, xy[::2], octave[::2], **settings)
    assert both == 512 + 256 and diff == 256
