"""Mean ms a frame of the frontend (`FrameExtractor.process`: features/*,
ops/{image,fast}.py), from the benchmark's synchronized spans."""


def read(trace):
    from portbench.metrics import _spans

    d = _spans.durations(trace, "frontend.extract")
    return 1e3 * sum(d) / len(d) if d else None
