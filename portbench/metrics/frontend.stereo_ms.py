"""Mean ms a frame of the stereo step (`frame_extractor.stereo_depth`: the
row match and subpixel refinement of `FrameExtractor.process_stereo`), from
the benchmark's synchronized spans."""


def read(trace):
    from portbench.metrics import _spans

    d = _spans.durations(trace, "frontend.stereo")
    return 1e3 * sum(d) / len(d) if d else None
