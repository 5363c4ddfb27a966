"""Mean ms a keyframe of keyframe mapping (`MapManager.new_keyframe`:
slam/mapmanager.py, mapping/*) less the local BA it runs, from the
benchmark's synchronized spans."""


def read(trace):
    from portbench.metrics import _spans

    d = _spans.self_times(trace, "mapping.new_keyframe", "ba.local_ba")
    return 1e3 * sum(d) / len(d) if d else None
