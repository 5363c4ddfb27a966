"""The program's span tracer, on one clock with the device trace, and the
leveled debug channel.

Counterpart of the reference's tracing subsystem (SURVEY §5):
`ScopedTimerEvents` prints per-stage ms deltas and `TimerAvrg` keeps
moving-average stage times (src/basictypes/timers.h:32-76), gated by the
`Debug` singleton (debug.h:30-46) with its string-registry side channel
(`Debug::addString`, the `-dbg_str` CLI flags).

A span is a named interval of host time on one thread: its start and end
in integer nanoseconds of `now_ns()`, its own id and its parent's (the
thread's innermost open span when it began; 0 for a root), the frame it
serves ((session, fseq): the `fseq` handed to `UcoSlam.process` and the
`UcoSlam`'s session number, inherited from the parent) and the thread.
Each thread keeps its own chain of open spans, so the async mapper's
worker nests its spans under its own roots. Counters (`count`: the hand-
written kernels' launches) attach to the innermost open span.

Tracing is off by default. Off, a span site costs one attribute check and
returns a shared no-op context manager; on, spans stay in memory until
`drain()` takes them. No span synchronizes the device: a span measures host
time, the launches it queued plus any wait a host read inside it forced.
Device time comes from a device trace (`DeviceTrace`, `profile_trace`),
whose timestamps this module moves onto `now_ns()`'s clock, so that each
CUDA runtime call (a launch, a synchronize, a blocking copy) lands in the
span that made it (`attribute`) and, through its correlation id, on the
kernel it started.

The `|@#` stage times of `apps/test_sequence.py` (extract, track, reloc,
mapping, localBA, loop) are read from the spans (`STAGES`, `report`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from collections import deque

#: the clock of every span, and the one the device trace is moved onto
now_ns = time.perf_counter_ns

#: the `|@#` stages and the span each is read from
STAGES = {
    "extract": "frontend.extract", "track": "tracking.track", "reloc": "tracking.relocalize",
    "mapping": "mapping.new_keyframe", "localBA": "ba.local_ba", "loop": "mapping.loop",
}
_STAGE_OF = {span: stage for stage, span in STAGES.items()}
#: a stage's time is the mean of its last STAGE_WINDOW spans
STAGE_WINDOW = 50


class _NoSpan:
    """The span of every site while tracing is off: it does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class Span:
    """One span (module docstring); its own context manager while open."""

    __slots__ = ("name", "start", "end", "id", "parent", "session", "fseq", "thread", "counts", "_tracer")

    def __init__(self, tracer: StageTimers, name: str, session, fseq):
        self._tracer = tracer
        self.name = name
        self.session, self.fseq = session, fseq
        self.counts = None

    def __enter__(self):
        tracer = self._tracer
        state = tracer._thread_state()
        stack = state.stack
        parent = stack[-1] if stack else None
        self.parent = parent.id if parent is not None else 0
        if self.session is None and parent is not None:
            self.session, self.fseq = parent.session, parent.fseq
        self.thread = state.thread
        self.id = next(tracer._ids)
        stack.append(self)
        self.start = now_ns()
        return self

    def __exit__(self, *exc):
        self.end = now_ns()
        tracer, self._tracer = self._tracer, None
        tracer._thread_state().stack.pop()
        with tracer._lock:
            tracer._spans.append(self)
        return False

    def as_tuple(self) -> tuple:
        """(name, start, end, id, parent, session, fseq, thread, counts),
        plain values a process can pickle; session and fseq -1 without a
        frame."""
        session, fseq = self.frame or (-1, -1)
        return (self.name, self.start, self.end, self.id, self.parent, session, fseq, self.thread,
                dict(self.counts) if self.counts else {})

    @property
    def frame(self) -> tuple[int, int] | None:
        """(session, fseq) of the frame the span serves, or None."""
        return None if self.session is None else (self.session, int(self.fseq))


class _ThreadState:
    __slots__ = ("stack", "totals", "thread", "native")

    def __init__(self):
        self.stack: list[Span] = []
        self.totals: dict[str, int] = {}
        self.thread = threading.get_ident()
        self.native = threading.get_native_id()


class StageTimers:
    """The process's span tracer (module docstring)."""

    def __init__(self):
        self.enabled = False
        self._lock = threading.Lock()  # the finished spans, the thread states, the stage windows
        self._spans: list[Span] = []
        self._local = threading.local()
        self._states: list[_ThreadState] = []
        self._ids = itertools.count(1)
        self._sessions = itertools.count(1)
        self._folded = 0  # spans of self._spans already in the stage windows
        self._stages: dict[str, deque] = {}

    # -- recording ------------------------------------------------------
    def start(self) -> None:
        """Turn tracing on."""
        self.enabled = True

    def stop(self) -> None:
        """Turn tracing off; spans still open finish as spans."""
        self.enabled = False

    def span(self, name: str, session: int | None = None, fseq: int | None = None):
        """A context manager that records a span `name` while tracing is on;
        a root gives the frame it serves (session, fseq), a child inherits
        its parent's."""
        if not self.enabled:
            return _NO_SPAN
        return Span(self, name, session, fseq)

    def count(self, name: str) -> None:
        """One more `name` (a kernel launch) in the innermost open span of
        this thread and in the thread's total, while tracing is on."""
        if not self.enabled:
            return
        state = self._thread_state()
        state.totals[name] = state.totals.get(name, 0) + 1
        if state.stack:
            top = state.stack[-1]
            if top.counts is None:
                top.counts = {}
            top.counts[name] = top.counts.get(name, 0) + 1

    def new_session(self) -> int:
        """A number for one `UcoSlam`: the first half of its frames' ids."""
        return next(self._sessions)

    def frame(self) -> tuple[int, int] | None:
        """The frame of this thread's innermost open span, or None."""
        stack = getattr(self._local, "state", None)
        return stack.stack[-1].frame if stack is not None and stack.stack else None

    def _thread_state(self) -> _ThreadState:
        try:
            return self._local.state
        except AttributeError:
            state = self._local.state = _ThreadState()
            with self._lock:
                self._states.append(state)
            return state

    # -- reading --------------------------------------------------------
    def drain(self) -> list[Span]:
        """The finished spans, in the order they ended; they leave the
        tracer (the stage times keep what they read of them)."""
        with self._lock:
            self._fold()
            spans, self._spans, self._folded = self._spans, [], 0
        return spans

    def counters(self) -> dict[str, int]:
        """Each counter's total over every thread, counted while tracing
        was on (`reset` leaves them: callers take differences)."""
        out: dict[str, int] = {}
        with self._lock:
            for state in self._states:
                for k, n in list(state.totals.items()):
                    out[k] = out.get(k, 0) + n
        return out

    def _fold(self) -> None:
        """Read the stage spans that ended since the last fold into the
        stage windows (under the lock)."""
        for s in itertools.islice(self._spans, self._folded, None):
            stage = _STAGE_OF.get(s.name)
            if stage is not None:
                self._stages.setdefault(stage, deque(maxlen=STAGE_WINDOW)).append(1e-9 * (s.end - s.start))
        self._folded = len(self._spans)

    def report(self, last: bool = False) -> str:
        """One-line 'stage=ms' summary (the |@# per-frame suffix): each
        stage's mean over its last spans, or its last span's."""
        with self._lock:
            self._fold()
            items = [(k, v[-1] if last else sum(v) / len(v)) for k, v in self._stages.items()]
        return " ".join(f"{k}={1e3 * t:.1f}ms" for k, t in items)

    def averages(self) -> dict[str, float]:
        """Each stage's mean time over its last spans, in seconds."""
        with self._lock:
            self._fold()
            return {k: sum(v) / len(v) for k, v in self._stages.items()}

    def reset(self) -> None:
        """Drop the finished spans and the stage times."""
        with self._lock:
            self._spans, self._folded = [], 0
            self._stages.clear()


#: process-wide tracer used by the program's layers
timers = StageTimers()


@contextlib.contextmanager
def tracing():
    """Tracing on for the enclosed block, and back to what it was after."""
    was = timers.enabled
    timers.start()
    try:
        yield timers
    finally:
        timers.enabled = was


# ---------------------------------------------------------------- device


#: the runtime calls that launch a kernel
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel", "cuLaunchKernel", "cuLaunchCooperativeKernel")
#: the CUDA runtime calls during which the host waits for the device
WAIT_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy",
              "cudaMemcpy2D", "cudaMemcpy3D")
#: the CPU annotation that marks the clock where no CUDA runtime is traced
CLOCK_MARK = "ucoslam_tpu_torch.clock_mark"
#: marker launches at each end of a device trace; the i-th waits i x MARK_GAP_NS
N_MARKS = 8
MARK_GAP_NS = 50_000


def thread_key(ident: int) -> int:
    """A thread's identity as the CUDA runtime events of a trace give it:
    its pthread id (`threading.get_ident()`) cut to a signed 32-bit int."""
    v = ident & 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def is_kernel(name: str) -> bool:
    """Device events that are kernels (not copies or memsets)."""
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


@dataclasses.dataclass
class DeviceEvents:
    """A device trace on now_ns()'s clock.

    device: (name, start, end, correlation) of each device activity;
    runtime: (name, start, end, correlation, thread) of each CUDA runtime
    call; clock_error_ns: the bound on the clock conversion's error the
    marks give (half the width of the offsets they allow); threads: a
    span's thread (`threading.get_ident()`) -> its id in the runtime calls,
    where it is not `thread_key` of it."""

    device: list
    runtime: list
    clock_error_ns: float
    threads: dict = dataclasses.field(default_factory=dict)


class Marks:
    """n clock marks: (now_ns before, now_ns after) one spin-kernel launch
    each (or one CPU annotation each, without CUDA), the i-th i x
    MARK_GAP_NS after the one before it: gaps that differ, so that no other
    run of launches lines up with them."""

    def __init__(self, n: int, cuda: bool):
        import torch

        self.marks = []
        for i in range(n):
            t = now_ns()
            while now_ns() - t < i * MARK_GAP_NS:
                pass
            a = now_ns()
            if cuda:
                torch.cuda._sleep(1)
            else:
                with torch.profiler.record_function(CLOCK_MARK):
                    pass
            self.marks.append((a, now_ns()))

    def pair(self, events, first: bool) -> tuple[list, list]:
        """The marks and the events ((start, end) in the trace's ns, in
        order) they made: the first run of the marking thread's events (the
        last, for marks at a trace's end) whose offsets agree with the marks
        one to one or, where the trace lost one record, with every mark but
        one. Events of another session before (or after) them are passed
        over. Raises where none agrees."""
        n = len(self.marks)
        anchors = range(len(events)) if first else range(len(events), 0, -1)
        for i in anchors:
            run = events[i:i + n] if first else events[max(0, i - n):i]
            fewer = run[:n - 1] if first else run[1:]
            tries = [(self.marks, run)] + [(self.marks[:k] + self.marks[k + 1:], fewer) for k in range(n)]
            for marks, evs in tries:
                if len(evs) == len(marks) > 0:
                    lo, hi = _bounds(marks, evs)
                    if lo <= hi:
                        return marks, evs
        raise RuntimeError(f"no run of the {len(events)} launches of the marking thread agrees with the "
                           f"{n} clock marks at the trace's {'start' if first else 'end'}")


def _bounds(marks, events) -> tuple[int, int]:
    """The (trace - now_ns) offsets that marks paired with the events they
    made allow: each pair [end - after, start - before], intersected."""
    lo = max(e - b for (_, b), (_, e) in zip(marks, events))
    hi = min(s - a for (a, _), (s, _) in zip(marks, events))
    return lo, hi


def _offset(marks, events) -> tuple[float, float]:
    """(trace - now_ns offset, its error bound): the middle and the half
    width of the offsets the marks allow."""
    lo, hi = _bounds(marks, events)
    return 0.5 * (lo + hi), 0.5 * (hi - lo)


class Clock:
    """The conversion of one profiler session's timestamps onto now_ns():
    offsets read at its start and its end from marker launches made between
    two now_ns() readings (`Marks`), linear between them."""

    def __init__(self, start: Marks, stop: Marks, events, cuda: bool):
        """events: the session's kineto events. The marks' launches are
        runtime launch calls of the one thread whose calls agree with the
        marks (this thread's ids first: a trace names threads by their
        pthread or by their native id); `thread` is that thread's id in the
        trace (None without CUDA)."""
        import torch

        groups: dict = {}
        if cuda:
            for e in events:
                if e.device_type() != torch.autograd.DeviceType.CUDA and e.name().startswith(LAUNCH_CALLS):
                    groups.setdefault(e.device_resource_id(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
            mine = (thread_key(threading.get_ident()), threading.get_native_id())
            groups = dict(sorted(groups.items(), key=lambda kv: kv[0] not in mine))
        else:
            groups[None] = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events if e.name() == CLOCK_MARK]
        for thread, found in groups.items():
            found.sort()
            try:
                pairs = start.pair(found, first=True), stop.pair(found, first=False)
            except RuntimeError:
                continue
            (self.off0, err0), (self.off1, err1) = (_offset(*p) for p in pairs)
            self.thread, self.error_ns = thread, max(err0, err1)
            self.t0, self.t1 = start.marks[0][0], stop.marks[-1][1]
            return
        raise RuntimeError(f"no thread's launches in the device trace agree with its clock marks "
                           f"({ {k: len(v) for k, v in groups.items()} } launches by thread)")

    def offset(self, t_now: float) -> float:
        """trace time - now_ns() time at now_ns() time t_now."""
        span = max(1, self.t1 - self.t0)
        return self.off0 + (self.off1 - self.off0) * (t_now - self.t0) / span

    def to_now(self, t_trace: int) -> float:
        return t_trace - self.offset(t_trace - self.off0)


def read_events(events, clock: Clock) -> DeviceEvents:
    """A session's kineto events on now_ns()'s clock: its device activity
    and its CUDA runtime calls."""
    import torch

    device, runtime = [], []
    for e in events:
        s = clock.to_now(e.start_ns())
        end = s + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device.append((e.name(), s, end, e.correlation_id()))
        elif e.name().startswith("cu"):
            runtime.append((e.name(), s, end, e.correlation_id(), e.device_resource_id()))
    return DeviceEvents(device=device, runtime=runtime, clock_error_ns=clock.error_ns,
                        threads=runtime_threads(clock.thread))


def runtime_threads(marking: int | None) -> dict[int, int]:
    """Each traced thread's id in a trace's runtime calls, from the marking
    (this) thread's: its pthread id cut to 32 bits (`thread_key`) or its
    native id, the same rule for every thread; where the marking thread's
    id follows neither, that thread alone."""
    me = threading.get_ident()
    with timers._lock:
        known = {st.thread: st.native for st in timers._states}
    known[me] = threading.get_native_id()
    if marking is None or marking == thread_key(me):
        return {}
    if marking == known[me]:
        return known
    return {me: marking}


class DeviceTrace:
    """A torch.profiler session over CUDA activity alone, read back on
    now_ns()'s clock (`stop` -> DeviceEvents). The session holds the CUDA
    runtime's calls beside the kernels, each with the correlation id of the
    activity it started."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._start: Marks | None = None

    def start(self) -> None:
        self._prof.__enter__()
        self._start = Marks(N_MARKS, cuda=True)

    def stop(self) -> DeviceEvents:
        import torch

        stop = Marks(N_MARKS, cuda=True)
        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        events = list(self._prof.profiler.kineto_results.events())
        return read_events(events, Clock(self._start, stop, events, cuda=True))


def _is_wait(name: str, copy: str | None) -> bool:
    """A runtime call during which the host waits for the device: a
    synchronize, a blocking copy, or an async copy to or from pageable
    memory (which the host stages itself)."""
    return name in WAIT_CALLS or (name.startswith("cudaMemcpy") and copy is not None and "Pageable" in copy)


def attribute(spans, trace: DeviceEvents) -> dict[int, dict]:
    """Each CUDA runtime call to the innermost span of its thread that holds
    its start, and through its correlation id to what it started on the
    device. -> span id -> {"launches": launch calls, "wait_ns": host time in
    waiting calls, "kernel_ns": device time of the kernels launched (of
    those whose record the trace holds)}; id 0 gathers the calls outside
    every span. spans: Span objects or `Span.as_tuple()` tuples."""
    kernels, copies = {}, {}
    for name, s, e, corr in trace.device:
        if is_kernel(name):
            kernels[corr] = kernels.get(corr, 0) + (e - s)
        else:
            copies[corr] = name
    by_thread: dict[int, list] = {}
    for sp in spans:
        t = sp if isinstance(sp, tuple) else sp.as_tuple()
        by_thread.setdefault(trace.threads.get(t[7], thread_key(t[7])), []).append((t[1], t[2], t[3]))
    calls: dict[int, list] = {}
    for call in trace.runtime:
        calls.setdefault(call[4], []).append(call)
    out: dict[int, dict] = {}
    for thread, cs in calls.items():
        order = sorted(by_thread.get(thread, []), key=lambda x: (x[0], -x[1]))
        stack, j = [], 0
        for name, s, e, corr, _ in sorted(cs, key=lambda c: c[1]):
            while j < len(order) and order[j][0] <= s:
                while stack and stack[-1][1] < order[j][0]:
                    stack.pop()
                stack.append(order[j])
                j += 1
            while stack and stack[-1][1] < s:
                stack.pop()
            row = out.setdefault(stack[-1][2] if stack else 0, {"launches": 0, "wait_ns": 0.0, "kernel_ns": 0.0})
            if name.startswith(LAUNCH_CALLS):
                row["launches"] += 1
                row["kernel_ns"] += kernels.get(corr, 0)
            if _is_wait(name, copies.get(corr)):
                row["wait_ns"] += e - s
    return out


@contextlib.contextmanager
def profile_trace(out_dir: str):
    """Trace the enclosed block with torch.profiler (host and, on the card,
    CUDA activity) and the program's spans, and write
    `<out_dir>/trace.json`, a Chrome trace (open it in chrome://tracing or
    Perfetto) in which the spans are a process of their own, "program
    spans", one track a thread, on the trace's clock."""
    import json
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    with tracing():
        timers.drain()
        with profile(activities=activities) as prof:
            start = Marks(N_MARKS, cuda)
            yield
            stop = Marks(N_MARKS, cuda)
            if cuda:
                torch.cuda.synchronize()
        spans = timers.drain()
    clock = Clock(start, stop, list(prof.profiler.kineto_results.events()), cuda)
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    pid = "program spans"
    doc["traceEvents"].append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0, "args": {"name": pid}})
    for s in spans:
        session, fseq = s.frame or (-1, -1)
        doc["traceEvents"].append({
            "ph": "X", "name": s.name, "pid": pid, "tid": thread_key(s.thread),
            "ts": (s.start + clock.offset(s.start) - base) / 1e3, "dur": (s.end - s.start) / 1e3,
            "args": {"id": s.id, "parent": s.parent, "session": session, "fseq": fseq, **(s.counts or {})},
        })
    with open(path, "w") as f:
        json.dump(doc, f)


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
