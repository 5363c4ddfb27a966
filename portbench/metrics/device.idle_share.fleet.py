"""Share (%) of the traced window in which no stream's device operation
runs: the streams' traced intervals merged on one timeline."""


def read(trace):
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"]) if trace.get("window_s") else None
