"""Mean ms a keyframe of its direct stereo points
(`MapManager._create_stereo_points`), from the benchmark's synchronized
spans."""


def read(trace):
    from portbench.metrics import _spans

    d = _spans.durations(trace, "mapping.stereo_points")
    return 1e3 * sum(d) / len(d) if d else None
