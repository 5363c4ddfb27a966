"""The end-to-end metrics' arithmetic, over every operation of the window."""

from __future__ import annotations

import numpy as np


def window_ops(records: list[tuple[float, float]], t_open: float, t_close: float) -> list[tuple[float, float]]:
    """The (start, end) records of operations that completed inside the
    window [t_open, t_close]."""
    return [(s, e) for s, e in records if s >= t_open and e <= t_close]


def fps(records: list[tuple[float, float]], t_open: float, t_close: float) -> float:
    """Frames completed in the window, over the window's length (s)."""
    return len(window_ops(records, t_open, t_close)) / (t_close - t_open)


def p95_ms(records: list[tuple[float, float]], t_open: float, t_close: float) -> float:
    """95th percentile (numpy's linear rule) of every completed operation's
    time, in ms."""
    lat = [e - s for s, e in window_ops(records, t_open, t_close)]
    if not lat:
        raise ValueError("no operation completed in the window")
    return 1e3 * float(np.percentile(np.asarray(lat, np.float64), 95))

