"""A traced run of a benchmark cell with the program's own spans.

Runs one cell of `BENCHMARK.json` through the generator its traffic mix
names (`portbench/core/fleet.py` or `stereo_fleet.py`, which share the
fleet's traces) as `portbench/run.py --trace 1` runs it, with two changes
made from here, in this process and in each stream's worker:
the device trace is the program's (`utils.timers.DeviceTrace`: the CUDA
runtime's calls beside the kernels, on the spans' clock by marker launches),
and, with `--program-spans 1`, the program's tracer records its spans over
the traced window. It prints one JSON line: the cell's end-to-end numbers,
its per-layer metrics as the benchmark reads them, and the readings of the
program's spans (`program_metrics`): launches and host waits per layer, the
hand-written kernels' launch counters a frame (`counter.<name>_per_frame`),
local BA's table build, the device's idle seconds by innermost program span
(`idle_gaps_program`, the arithmetic of the benchmark's `idle_gaps`), and
the share of the window's kernels that a program span launched.

    python3 tools/port/trace_fleet.py --workload mono_fleet_explore --seed 7 \\
        [--seconds 30] [--program-spans 1] [--out build/trace_fleet.jsonl]

Needs a CUDA card. `--program-spans 0` runs the same traced cell with the
program's tracer off: the pair gives the tracer's cost.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

#: set in the workers' environment when the program's tracer records spans
SPANS_ENV = "UCOSLAM_TRACE_FLEET_SPANS"
#: the marker launches' kernel, left out of the benchmark's view of the trace
MARK_KERNEL = "spin_kernel"

#: the per-layer readings: (layer spans, spans left out, what, per); a
#: reading whose spans never ran (the stereo step of a mono cell) is left out
LAYERS = {
    "frontend.launches_per_frame": (("frontend.extract",), (), "launches", "frame"),
    "tracking.launches_per_frame": (("tracking.track", "tracking.relocalize"), (), "launches", "frame"),
    "mapping.launches_per_keyframe": (("mapping.new_keyframe",), ("ba.local_ba",), "launches", "mapping.new_keyframe"),
    "ba.launches_per_call": (("ba.local_ba",), (), "launches", "ba.local_ba"),
    "frontend.wait_ms": (("frontend.extract",), (), "wait_ns", "frame"),
    "tracking.wait_ms": (("tracking.track", "tracking.relocalize"), (), "wait_ns", "frame"),
    "mapping.wait_ms": (("mapping.new_keyframe",), ("ba.local_ba",), "wait_ns", "mapping.new_keyframe"),
    "ba.wait_ms": (("ba.local_ba",), (), "wait_ns", "ba.local_ba"),
    "frontend.stereo_launches_per_frame": (("frontend.stereo",), (), "launches", "frame"),
    "frontend.stereo_wait_ms": (("frontend.stereo",), (), "wait_ns", "frame"),
    "mapping.stereo_points_launches_per_keyframe": (("mapping.stereo_points",), (), "launches",
                                                    "mapping.new_keyframe"),
    "mapping.stereo_points_wait_ms": (("mapping.stereo_points",), (), "wait_ns", "mapping.new_keyframe"),
}
#: the layers whose shares of the window's kernels a run reports
SHARES = {
    "frontend": (("frontend.extract",), ()), "tracking": (("tracking.track", "tracking.relocalize"), ()),
    "mapping": (("mapping.new_keyframe",), ("ba.local_ba",)), "ba": (("ba.local_ba",), ()),
    "initialize": (("slam.initialize",), ()),
}


# ---------------------------------------------------------------- readings


def layer_of(spans, names, excluded=()) -> dict[int, bool]:
    """span id -> whether the span lies inside a span named in `names` (or
    is one) and outside every span named in `excluded` below it. spans:
    `Span.as_tuple()` tuples of one process."""
    by_id = {s[3]: s for s in spans}
    memo: dict[int, bool] = {}

    def inside(sid: int):
        """True inside a layer span, False inside an excluded one below it
        (or outside every layer span), looked up the parent chain."""
        if sid in memo:
            return memo[sid]
        s = by_id.get(sid)
        if s is None or s[0] in excluded:
            out = False
        elif s[0] in names:
            out = True
        else:
            out = inside(s[4])
        memo[sid] = out
        return out

    return {sid: inside(sid) for sid in by_id}


def layer_totals(streams: list[dict], names, excluded=()) -> dict[str, float]:
    """Launches and host wait (ns) attributed to the spans inside the layer
    (`layer_of`), summed over the streams. streams: {"spans", "stats"}
    (stats: `timers.attribute`'s span id -> row)."""
    tot = {"launches": 0, "wait_ns": 0.0}
    for st in streams:
        inside = layer_of(st["spans"], names, excluded)
        for sid, row in st["stats"].items():
            if inside.get(sid):
                tot["launches"] += row["launches"]
                tot["wait_ns"] += row["wait_ns"]
    return tot


def count_spans(streams: list[dict], name: str) -> int:
    return sum(1 for st in streams for s in st["spans"] if s[0] == name)


def program_metrics(streams: list[dict]) -> dict[str, float]:
    """The readings of the program's spans over the streams (each a dict of
    its `spans` and their `stats`); a reading with nothing to read (no
    frame, keyframe or local BA in the window, or no span of its layer) is
    left out."""
    frames = count_spans(streams, "frontend.extract")
    out = {}
    for metric, (names, excluded, what, per) in LAYERS.items():
        n = frames if per == "frame" else count_spans(streams, per)
        if not n or not any(count_spans(streams, name) for name in names):
            continue
        tot = layer_totals(streams, names, excluded)[what]
        out[metric] = tot / n if what == "launches" else 1e-6 * tot / n
    builds = [s[2] - s[1] for st in streams for s in st["spans"] if s[0] == "ba.build"]
    if builds:
        out["ba.build_ms"] = 1e-6 * sum(builds) / len(builds)
    counts: dict[str, int] = {}
    for st in streams:
        for s in st["spans"]:
            for name, n_launch in s[8].items():
                counts[name] = counts.get(name, 0) + n_launch
    if frames:
        out.update({f"counter.{name}_per_frame": n_launch / frames for name, n_launch in sorted(counts.items())})
    return out


def depth_spans(spans) -> list[tuple[str, float, float, int]]:
    """Spans of one process as the benchmark's span lists hold them:
    (name, start s, end s, depth)."""
    by_id = {s[3]: s for s in spans}
    depth: dict[int, int] = {}

    def d(sid: int) -> int:
        if sid not in depth:
            s = by_id.get(sid)
            depth[sid] = -1 if s is None else d(s[4]) + 1
        return depth[sid]

    return [(s[0], 1e-9 * s[1], 1e-9 * s[2], d(s[3])) for s in spans]


def summarize(traces: list[dict], merged: dict, t_open: float, trace_seconds: float) -> dict:
    """What the program's spans add to the benchmark's merged trace:
    readings, idle seconds by innermost program span, and coverage."""
    from portbench.core import trace
    from ucoslam_tpu_torch.utils.timers import DeviceEvents, attribute

    streams = []
    for tr in traces:
        dev = DeviceEvents(device=tr["device"], runtime=tr["runtime"], clock_error_ns=tr["clock_error_ns"],
                           threads=tr["threads"])
        streams.append({"spans": tr["program_spans"], "stats": attribute(tr["program_spans"], dev)})
    t1 = t_open + trace_seconds
    events = [e for tr in traces for e in tr["events"]]
    span_lists = [depth_spans(st["spans"]) for st in streams]
    gaps = trace.gaps_by_span(events, span_lists, t_open, t1, top=10 ** 6)
    metrics = program_metrics(streams)
    launched = sum(row["launches"] for st in streams for sid, row in st["stats"].items() if sid != 0)
    outside = sum(st["stats"].get(0, {}).get("launches", 0) for st in streams)
    frames = merged.get("frames", 0)
    bench_ba_idle = dict(merged["breakdown"]["idle_gaps"]).get("ba.local_ba", 0.0)
    ba_idle = sum(v for k, v in gaps if k in ("ba.build", "ba.solve", "ba.apply", "ba.lm_step"))
    shares = {layer: layer_totals(streams, names, excluded)["launches"] / merged["events_kernels"]
              for layer, (names, excluded) in SHARES.items()} if merged["events_kernels"] else {}
    coverage = {
        "launch_shares": shares, "frames": count_spans(streams, "frontend.extract"),
        "keyframes": count_spans(streams, "mapping.new_keyframe"), "local_ba": count_spans(streams, "ba.local_ba"),
        "launched_in_spans": launched, "launched_outside": outside, "window_kernels": merged["events_kernels"],
        "in_spans_share": launched / merged["events_kernels"] if merged["events_kernels"] else None,
        "frontend_tracking_share": ((metrics.get("frontend.launches_per_frame", 0)
                                     + metrics.get("tracking.launches_per_frame", 0))
                                    / (merged["events_kernels"] / frames) if frames and merged["events_kernels"]
                                    else None),
        "ba_idle_bench_s": bench_ba_idle, "ba_idle_program_s": ba_idle,
        "ba_idle_share": ba_idle / bench_ba_idle if bench_ba_idle else None,
        "frontend_children_in_top10": sorted({k for k, _ in gaps[:10]
                                              if k.startswith("frontend.") and k != "frontend.extract"}),
        "clock_error_ns_max": max(tr["clock_error_ns"] for tr in traces),
    }
    return {"metrics": metrics, "idle_gaps_program": gaps[:10], "coverage": coverage}


# ---------------------------------------------------------------- workers


def _program_device_trace():
    """The benchmark's DeviceTrace, read through the program's: the same
    `events` (the marker kernels left out), and the runtime calls and
    spans kept for the record."""
    from ucoslam_tpu_torch.utils.timers import DeviceTrace, timers

    class ProgramDeviceTrace:
        last = None

        def __init__(self):
            self._inner = DeviceTrace()
            self.events: list = []
            self.program: dict = {}

        def start(self) -> None:
            self._inner.start()
            if os.environ.get(SPANS_ENV) == "1":
                timers.drain()
                timers.start()

        def stop(self):
            dev = self._inner.stop()
            timers.stop()
            spans = [s.as_tuple() for s in timers.drain()]
            device = [e for e in dev.device if MARK_KERNEL not in e[0]]
            self.events = [(name, 1e-9 * s, 1e-9 * e) for name, s, e, _ in device]
            self.program = {"program_spans": spans, "device": device, "runtime": dev.runtime,
                            "clock_error_ns": dev.clock_error_ns, "threads": dev.threads}
            ProgramDeviceTrace.last = self
            return self.events

    return ProgramDeviceTrace


def worker_main(conn, spec: dict) -> None:
    """A stream's worker (the generator's `worker_main`) with the program's
    device trace, whose runtime calls and spans go into the stream's record
    (the generators take both through `trace` and `fleet`)."""
    from portbench.core import fleet, manifest, trace

    dt = trace.DeviceTrace = _program_device_trace()
    record = fleet._trace_record

    def trace_record(*args, **kwargs):
        out = record(*args, **kwargs)
        out.update(dt.last.program)
        return out

    fleet._trace_record = trace_record
    manifest.generator(spec["traffic"]["generator"]).worker_main(conn, spec)


def run(workload: str, seed: int, seconds: float, spans: bool) -> dict:
    from portbench import run as bench
    from portbench.core import fleet, manifest

    man = manifest.manifest(REPO)
    cell = manifest.cell(man, workload)
    if not bench.cards_for(cell):
        raise SystemExit(2)
    os.environ[SPANS_ENV] = "1" if spans else "0"
    ctx = bench.context(cell, seed, seconds, True)
    merge, extra = fleet.merge_traces, {}

    def merge_traces(traces, records, t_open, trace_seconds):
        out = merge(traces, records, t_open, trace_seconds)
        if spans:
            extra.update(summarize(traces, out, t_open, trace_seconds))
        extra["clock_error_ns_max"] = max(tr["clock_error_ns"] for tr in traces)
        return out

    fleet.merge_traces = merge_traces
    manifest.generator(ctx.traffic["generator"]).worker_main = worker_main
    out = bench.execute(ctx)
    tr = out.get("trace")
    per_layer = {m["name"]: manifest.metric_reader(m["name"])(tr) for m in manifest.metrics_of(man, "per_layer", workload)} if tr else {}
    return {"workload": workload, "seed": seed, "program_spans": spans, "correct": out["correct"],
            "attempted": out["attempted"], "failed": out["failed"], "end_to_end": out["end_to_end"],
            "per_layer": per_layer, "idle_gaps": tr["breakdown"]["idle_gaps"] if tr else None,
            "busy_s": tr["busy_s"] if tr else None, "window_s": tr["window_s"] if tr else None, **extra}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--program-spans", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out", help="append the JSON line to this file too")
    args = ap.parse_args(argv)
    line = json.dumps(run(args.workload, args.seed, args.seconds, bool(args.program_spans)))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
