"""Spans around calls into the program's layers, and the device trace.

Spans come from the benchmark's own wrappers around the program's entry
points (`Recorder.wrap`), on the host clock (`time.perf_counter`), with a
device synchronize at both ends: they are installed only in a traced run.
Device activity comes from `torch.profiler` (CUDA activity alone), read as
raw kineto events; their timestamps are Unix nanoseconds, moved onto the
host clock of the spans, so the traces of several processes merge on one
timeline. The busy arithmetic (a union of the device intervals) is copied
from `tools/port/profile_slice.py::_device_busy_ms`.
"""

from __future__ import annotations

import datetime
import shutil
import subprocess
import time


class Recorder:
    """Spans (name, start, end, depth) in memory while `active`, and
    arbitrary launch records for the rooflines."""

    def __init__(self, sync=None):
        self.active = False
        self.spans: list[tuple[str, float, float, int]] = []
        self.launches: dict[str, list] = {}
        self._depth = 0
        self._sync = sync

    def wrap(self, name: str, fn):
        """fn wrapped in a span `name` (synchronized at both ends) while
        the recorder is active; fn itself otherwise."""

        def wrapper(*args, **kwargs):
            if not self.active:
                return fn(*args, **kwargs)
            if self._sync:
                self._sync()
            self._depth += 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                if self._sync:
                    self._sync()
                self._depth -= 1
                self.spans.append((name, t0, time.perf_counter(), self._depth))

        wrapper.__wrapped__ = fn
        return wrapper

    def record_launch(self, kernel: str, fn, capture):
        """fn wrapped so that, while active, capture(*args, **kwargs) (a
        small record of the launch's inputs) is kept under `kernel`."""

        def wrapper(*args, **kwargs):
            if self.active:
                self.launches.setdefault(kernel, []).append(capture(*args, **kwargs))
            return fn(*args, **kwargs)

        wrapper.__wrapped__ = fn
        return wrapper


class DeviceTrace:
    """A torch.profiler session over CUDA activity; `stop()` -> the device
    events [(name, start_s, end_s)] on the perf_counter clock."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._offset_ns = None
        self.events: list[tuple[str, float, float]] = []

    def start(self) -> None:
        self._offset_ns = time.time_ns() - time.perf_counter_ns()
        self._prof.__enter__()

    def stop(self) -> list[tuple[str, float, float]]:
        import torch

        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        out = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            s = (e.start_ns() - self._offset_ns) / 1e9
            out.append((e.name(), s, s + e.duration_ns() / 1e9))
        self.events = out
        return out


def warm_profiler() -> None:
    """Start and stop one short trace: the first start of the device
    tracer takes seconds, and belongs in set-up, not in the window."""
    import torch

    t = DeviceTrace()
    t.start()
    torch.ones(1, device="cuda").add_(1)
    t.stop()


class SmiSampler:
    """`nvidia-smi`'s utilization.gpu every 200 ms beside a traced window:
    a cross-check of the trace's busy share (the card's own utilization counter)."""

    def __init__(self):
        exe = shutil.which("nvidia-smi")
        self.proc = None if exe is None else subprocess.Popen(
            [exe, "--query-gpu=timestamp,utilization.gpu", "--format=csv,noheader,nounits", "-lms", "200"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def stop(self, t0: float, t1: float) -> float | None:
        """Mean utilization (%) of the samples in [t0, t1] (perf_counter
        clock); None without nvidia-smi or samples."""
        if self.proc is None:
            return None
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        shift = time.time() - time.perf_counter()
        vals = []
        for line in out.splitlines():
            try:
                ts, util = (x.strip() for x in line.split(","))
                t = datetime.datetime.strptime(ts, "%Y/%m/%d %H:%M:%S.%f").timestamp() - shift
                if t0 <= t <= t1:
                    vals.append(float(util))
            except ValueError:
                continue
        return sum(vals) / len(vals) if vals else None


def is_kernel(name: str) -> bool:
    """Device events that are kernels (not copies or memsets)."""
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def merge(intervals, t0: float, t1: float) -> list[tuple[float, float]]:
    """Union of the (start, end) intervals clipped to [t0, t1], sorted."""
    spans = sorted((max(s, t0), min(e, t1)) for s, e in intervals if e > t0 and s < t1)
    out: list[list[float]] = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_seconds(events, t0: float, t1: float) -> float:
    return sum(e - s for s, e in merge(((s, e) for _, s, e in events), t0, t1))


def idle_gaps(events, t0: float, t1: float) -> list[tuple[float, float]]:
    """The intervals of [t0, t1] in which no device event runs."""
    gaps, cur = [], t0
    for s, e in merge(((s, e) for _, s, e in events), t0, t1):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if cur < t1:
        gaps.append((cur, t1))
    return gaps


def innermost_span(spans, t: float) -> str:
    """The deepest span of one process that holds the instant t, or
    "harness" where none does."""
    best, depth = "harness", -1
    for name, s, e, d in spans:
        if s <= t <= e and d > depth:
            best, depth = name, d
    return best


def gaps_by_span(events, span_lists, t0: float, t1: float, top: int = 10) -> list[list]:
    """Idle seconds of the merged device timeline by what the host was
    doing: each gap is shared among the processes, each giving its share to
    the innermost span it was in at the gap's middle. -> [[name, s]], the
    `top` largest."""
    acc: dict[str, float] = {}
    n = max(1, len(span_lists))
    for s, e in idle_gaps(events, t0, t1):
        mid = 0.5 * (s + e)
        for spans in span_lists:
            name = innermost_span(spans, mid)
            acc[name] = acc.get(name, 0.0) + (e - s) / n
    return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:top]]


def kernel_table(events, t0: float, t1: float) -> dict[str, dict]:
    """name -> {"count", "seconds"} of the device events that start in [t0, t1]."""
    out: dict[str, dict] = {}
    for name, s, e in events:
        if t0 <= s <= t1:
            row = out.setdefault(name, {"count": 0, "seconds": 0.0})
            row["count"] += 1
            row["seconds"] += e - s
    return out


def top_ops(table: dict[str, dict], top: int = 10) -> list[list]:
    rows = sorted(table.items(), key=lambda kv: -kv[1]["seconds"])[:top]
    return [[name[:96], row["seconds"]] for name, row in rows]
