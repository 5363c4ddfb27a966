"""Shared arithmetic of the span readers (not a metric: no manifest entry
names it)."""


def durations(trace: dict, name: str) -> list[float]:
    return [e - s for spans in trace["spans"] for n, s, e, _ in spans if n == name]


def self_times(trace: dict, name: str, child: str) -> list[float]:
    """Each `name` span's duration less the `child` spans inside it, in the
    same process."""
    out = []
    for spans in trace["spans"]:
        kids = [(s, e) for n, s, e, _ in spans if n == child]
        for n, s, e, _ in spans:
            if n == name:
                out.append((e - s) - sum(ke - ks for ks, ke in kids if ks >= s and ke <= e))
    return out


def roofline(trace: dict, kernel: str, substring: str):
    """100 x the mean least time of the launches recorded for `kernel` over
    the mean time of the device events whose name holds `substring`."""
    works = trace.get("works", {}).get(kernel, [])
    rows = [r for n, r in trace["kernels"].items() if substring in n]
    count = sum(r["count"] for r in rows)
    if not works or not count:
        return None
    least = sum(w[0] for w in works) / len(works)
    return 100.0 * least / (sum(r["seconds"] for r in rows) / count)
