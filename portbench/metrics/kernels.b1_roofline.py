"""Kernel B1's share of its roofline (%): the least time its launches'
inputs need (portbench/rooflines/b1.py) over its device time in the trace."""


def read(trace):
    from portbench.metrics import _spans

    return _spans.roofline(trace, "B1", "project_match_kernel")
