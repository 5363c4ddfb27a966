"""Controls and planted faults of a stereo cell (`portbench/core/stereo_fleet.py`).

Never used by `run.py`'s own runs; `portbench/readings.py` and the tests
under `portbench/tests/` switch one on. Two planted faults of the depth and
one of the right image:

- `depth_scaled`: every depth x 1.05, the rig's baseline 5% off (the map and
  every pose 5% too large: a metric trajectory error);
- `depth_dropped`: every other keypoint's depth set to 0;
- `altered_right`: the lowest bit of each word of every right-image
  descriptor flipped (8 bits of 256: a row match's Hamming distance moves
  by 8 at most, and the depths stay as they were in the CPU test; the right
  image's own readings catch it).

The controls of `portbench/core/controls.py` that act inside a session
apply as they are (`tf32`, `half_batch`, `altered_desc`, `lost_frames`);
those that act on the answer (`stale_state`, `altered_pose`) act on
`processStereo`'s here, the entry point a stereo session is fed through; and
`late_init` fails a session's first 40 depth initializations, the init a
stereo session takes.
"""

from __future__ import annotations

from portbench.core import controls

NAMES = ("depth_scaled", "depth_dropped", "altered_right") + controls.NAMES
#: the baseline error `depth_scaled` plants
DEPTH_SCALE = 1.05


def apply(name: str | None) -> None:
    """Switch `name` on in this process, before the program runs."""
    if not name:
        return
    if name not in NAMES:
        raise ValueError(f"unknown control {name!r}")
    import dataclasses

    import torch

    from ucoslam_tpu_torch.api import UcoSlam
    from ucoslam_tpu_torch.features.frame_extractor import FrameExtractor
    from ucoslam_tpu_torch.features.orb import ORBExtractor
    from ucoslam_tpu_torch.slam.initializer import MapInitializer

    if name == "depth_scaled":
        def process_stereo(self, left, right, fseq=0, _inner=FrameExtractor.process_stereo):
            f = _inner(self, left, right, fseq)
            return f.replace(depth=f.depth * DEPTH_SCALE)

        FrameExtractor.process_stereo = process_stereo
    elif name == "depth_dropped":
        def process_stereo(self, left, right, fseq=0, _inner=FrameExtractor.process_stereo):
            f = _inner(self, left, right, fseq)
            odd = torch.arange(f.depth.numel(), device=f.depth.device) % 2 == 1
            return f.replace(depth=torch.where(odd, 0.0, f.depth))

        FrameExtractor.process_stereo = process_stereo
    elif name == "altered_right":
        def detect_and_compute(self, img, _inner=ORBExtractor.detect_and_compute):
            kps = _inner(self, img)
            self._detections = getattr(self, "_detections", 0) + 1
            if self._detections % 2 == 0:  # a stereo frame detects its left image, then its right
                kps = dataclasses.replace(kps, desc=kps.desc ^ 1)
            return kps

        ORBExtractor.detect_and_compute = detect_and_compute
    elif name == "stale_state":
        def process_stereo(self, left, right, fseq=0, _inner=UcoSlam.processStereo):
            pose = _inner(self, left, right, fseq)
            if pose is not None and getattr(self, "_first_pose", None) is None:
                self._first_pose = pose
            return self._first_pose if pose is not None else None

        UcoSlam.processStereo = process_stereo
    elif name == "altered_pose":
        def process_stereo(self, left, right, fseq=0, _inner=UcoSlam.processStereo):
            pose = _inner(self, left, right, fseq)
            if pose is not None and fseq % 4 == 0:
                pose = pose.copy()
                pose[0, 3] += 0.5
            return pose

        UcoSlam.processStereo = process_stereo
    elif name == "late_init":
        def initialize_from_depth(self, frame, world_map, _inner=MapInitializer.initialize_from_depth):
            self._late_attempts = getattr(self, "_late_attempts", 0) + 1
            return self._late_attempts > controls.LATE_ATTEMPTS and _inner(self, frame, world_map)

        MapInitializer.initialize_from_depth = initialize_from_depth
    else:
        controls.apply(name)
