"""Mean ms a frame of tracking (`Tracker.track` and `Tracker.relocalize`:
slam/tracker.py, matching/*, optim/pnp.py), from the benchmark's
synchronized spans, over the frames of the traced window."""


def read(trace):
    from portbench.metrics import _spans

    frames = len(_spans.durations(trace, "frontend.extract"))
    d = _spans.durations(trace, "tracking.track")
    return 1e3 * sum(d) / frames if frames and d else None
