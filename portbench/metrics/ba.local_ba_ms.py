"""Mean ms of one local BA (`optim.ba.local_bundle_adjustment`), from the
benchmark's synchronized spans."""


def read(trace):
    from portbench.metrics import _spans

    d = _spans.durations(trace, "ba.local_ba")
    return 1e3 * sum(d) / len(d) if d else None
