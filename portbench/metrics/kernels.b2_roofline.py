"""Kernel B2's share of its roofline (%): the least time its launches'
inputs need (portbench/rooflines/b2.py) over its device time in the trace."""


def read(trace):
    from portbench.metrics import _spans

    return _spans.roofline(trace, "B2", "motion_only_lm_kernel")
