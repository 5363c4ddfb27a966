"""Per-stage wall-clock timers + leveled debug channel.

Counterpart of the reference's tracing subsystem (SURVEY §5):
`ScopedTimerEvents` prints per-stage ms deltas and `TimerAvrg` keeps
moving-average stage times (src/basictypes/timers.h:32-76), gated by the
`Debug` singleton (debug.h:30-46) with its string-registry side channel
(`Debug::addString`, the `-dbg_str` CLI flags).

Port of `ucoslam_tpu/utils/timers.py`, with the reference's host-clock
semantics: a stage's time is the host's time between entering and leaving
it, with no device synchronize (one per stage would stall the stream every
frame). On the card a stage's time is therefore its host time: the launches
it queued, plus any wait for the device that a host read inside it forced,
not the device time of its kernels. For device times use `profile_trace`,
a `torch.profiler` Chrome trace (the counterpart of a USE_TIMERS build).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict


class _TimerAvrg:
    """Moving average (reference TimerAvrg, timers.h)."""

    def __init__(self, window: int = 50):
        self.window = window
        self.total = 0.0
        self.n = 0
        self.last = 0.0

    def add(self, dt: float) -> None:
        self.last = dt
        # exponential window keeps O(1) state
        if self.n >= self.window:
            self.total -= self.total / self.window
        else:
            self.n += 1
        self.total += dt

    @property
    def avg(self) -> float:
        return self.total / max(self.n, 1)


class StageTimers:
    """Named stage timer registry; enabled cheaply (a perf_counter pair).

    Thread-safe: in async mode the mapping worker enters `localBA` and
    `loop` while the tracker's thread reports, so every insertion and every
    read of the registry holds one lock."""

    def __init__(self):
        self.stages: OrderedDict[str, _TimerAvrg] = OrderedDict()
        self.enabled = True
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, dt: float) -> None:
        with self._lock:
            self.stages.setdefault(name, _TimerAvrg()).add(dt)

    def report(self, last: bool = False) -> str:
        """One-line 'stage=ms' summary (the |@# per-frame suffix)."""
        with self._lock:
            items = [(k, v.last if last else v.avg) for k, v in self.stages.items()]
        return " ".join(f"{k}={1e3 * t:.1f}ms" for k, t in items)

    def averages(self) -> dict[str, float]:
        """Each stage's moving-average time, in seconds."""
        with self._lock:
            return {k: v.avg for k, v in self.stages.items()}

    def reset(self) -> None:
        with self._lock:
            self.stages.clear()


#: process-wide registry used by System/FrameExtractor/MapManager
timers = StageTimers()


class Debug:
    """Leveled debug singleton (reference debug.h:30-46)."""

    level = 0
    _strings: dict[str, str] = {}

    @classmethod
    def setLevel(cls, level: int) -> None:
        cls.level = level

    @classmethod
    def msg(cls, text: str, level: int = 5) -> None:
        if cls.level >= level:
            print(f"#DEBUG {text}", flush=True)

    @classmethod
    def addString(cls, key: str, value: str = "") -> None:
        """String-registry side channel (Debug::addString; -dbg_str)."""
        cls._strings[key] = value

    @classmethod
    def getString(cls, key: str, default: str = "") -> str:
        return cls._strings.get(key, default)

    @classmethod
    def isString(cls, key: str) -> bool:
        return key in cls._strings


@contextlib.contextmanager
def profile_trace(out_dir: str):
    """Trace the enclosed block with torch.profiler (host and, on the card,
    CUDA activity) and write `<out_dir>/trace.json`, a Chrome trace (open it
    in chrome://tracing or Perfetto)."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
