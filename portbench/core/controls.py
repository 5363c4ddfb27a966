"""Controls and planted faults for the comparison that decides `correct`.

Never used by `run.py`'s own runs. `portbench/readings.py` and the tests
under `portbench/tests/` run a cell with one of these switched on, to read
the upper end of each limit and to see `correct` come out false:

- `tf32`: the program's own lower-precision path, TF32 matmuls and
  convolutions (the configuration states float32 with TF32 off);
- `stale_state`: a step that returns its state unchanged (every frame
  answers the first pose its session returned);
- `half_batch`: half of the batch left out, the mean taken over the rest
  (every other keypoint of a frame dropped);
- `altered_pose`: one answer in four altered where it is produced (a pose's
  translation moved by 0.5, a wrong pose);
- `altered_desc`: one bit of every descriptor flipped in the frontend;
- `late_init`: a session's first pose comes late (the first 40 attempts of
  a session's two-view initialization, or of its relocalization against a
  saved map, fail);
- `lost_frames`: the tracker loses one frame in four (the track returns no
  pose; the next frame relocalizes).

One card holds every cell, so no exchange between chips can be left out.
"""

from __future__ import annotations

NAMES = ("tf32", "stale_state", "half_batch", "altered_pose", "altered_desc", "late_init", "lost_frames")
#: attempts that `late_init` fails at the start of each session
LATE_ATTEMPTS = 40


def apply(name: str | None) -> None:
    """Switch `name` on in this process, before the program runs."""
    if not name:
        return
    if name not in NAMES:
        raise ValueError(f"unknown control {name!r}")
    import numpy as np
    import torch

    from ucoslam_tpu_torch.api import UcoSlam
    from ucoslam_tpu_torch.features.frame_extractor import FrameExtractor
    from ucoslam_tpu_torch.slam import system
    from ucoslam_tpu_torch.slam.initializer import MapInitializer
    from ucoslam_tpu_torch.slam.tracker import Tracker, TrackResult

    if name == "tf32":
        def enable_tf32():
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True

        system.disable_tf32 = enable_tf32
        enable_tf32()
    elif name == "stale_state":
        def process(self, img, fseq=0, _inner=UcoSlam.process):
            pose = _inner(self, img, fseq)
            if pose is not None and getattr(self, "_first_pose", None) is None:
                self._first_pose = pose
            return self._first_pose if pose is not None else None

        UcoSlam.process = process
    elif name == "half_batch":
        def base_frame(self, img, fseq, _inner=FrameExtractor._base_frame_impl):
            f, gray = _inner(self, img, fseq)
            keep = torch.arange(f.valid.numel(), device=f.valid.device) % 2 == 0
            return f.replace(valid=f.valid & keep), gray

        FrameExtractor._base_frame_impl = base_frame
    elif name == "altered_pose":
        def process(self, img, fseq=0, _inner=UcoSlam.process):
            pose = _inner(self, img, fseq)
            if pose is not None and fseq % 4 == 0:
                pose = pose.copy()
                pose[0, 3] += 0.5
            return pose

        UcoSlam.process = process
    elif name == "altered_desc":
        def base_frame(self, img, fseq, _inner=FrameExtractor._base_frame_impl):
            f, gray = _inner(self, img, fseq)
            return f.replace(desc=f.desc ^ 1), gray

        FrameExtractor._base_frame_impl = base_frame
    elif name == "late_init":
        def late(inner, failed):
            def fn(self, *args, **kwargs):
                self._late_attempts = getattr(self, "_late_attempts", 0) + 1
                if self._late_attempts <= LATE_ATTEMPTS:
                    return failed(*args)
                return inner(self, *args, **kwargs)
            return fn

        MapInitializer.initialize_two_view = late(MapInitializer.initialize_two_view,
                                                  lambda frame, world_map: ("no_geometry", frame))
        Tracker.relocalize = late(Tracker.relocalize, lambda world_map, frame, kfdb=None: TrackResult(
            False, None, frame, 0, 0, np.zeros(0, np.int32)))
    elif name == "lost_frames":
        def track(self, world_map, frame, prior, _inner=Tracker.track):
            self._tracks = getattr(self, "_tracks", 0) + 1
            if self._tracks % 4 == 0:
                return TrackResult(False, None, frame, 0, 0, np.zeros(0, np.int32))
            return _inner(self, world_map, frame, prior)

        Tracker.track = track
