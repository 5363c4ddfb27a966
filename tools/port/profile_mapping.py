"""Where a keyframe's mapping spends its time on the card.

Runs the 60-frame `mono` scene of chip_smoke.py's phase 12 sequentially
through `UcoSlam(device="cuda")` twice (the first pass warms the kernels
and the allocator), and in the second pass times every step of
`MapManager.new_keyframe` on the host clock to a synchronize, and profiles
the mapping with cProfile. Prints the steps' totals, then the functions with
the most own and cumulative time, and the count of device launches of the
mapping (torch.profiler).

    python3 tools/port/profile_mapping.py [--top 40]

Runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import collections
import cProfile
import io
import os
import pstats
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--frames", type=int, default=60, help="the scene's first frames to run")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from ucoslam_tpu_torch.api import UcoSlam
    from ucoslam_tpu_torch.config import Params
    from ucoslam_tpu_torch.io.serialize import load_map_meta
    from ucoslam_tpu_torch.slam import mapmanager as mm

    cuda = args.device == "cuda"
    if cuda:
        cs.phase_environment()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    _, cam, seq, images = cs.load_scene(cs.REF_PATH)
    images = images[:args.frames]
    params = Params.from_dict(load_map_meta(cs.MAP_PATH)["params"])
    steps = collections.defaultdict(float)
    on = {"timing": False}

    def timed(name, fn):
        def run(*a, **k):
            if not on["timing"]:
                return fn(*a, **k)
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync()
            steps[name] += 1e3 * (time.perf_counter() - t0)
            return out
        return run

    for name in ("_create_stereo_points", "_create_epipolar_points", "_fuse_duplicates", "_cull_recent_points",
                 "_cull_keyframes", "_detect_and_close_loop"):
        setattr(mm.MapManager, name, timed(name, getattr(mm.MapManager, name)))
    mm.ba.local_bundle_adjustment = timed("local_bundle_adjustment", mm.ba.local_bundle_adjustment)
    for name in ("build_ba_problem", "ba_solve", "apply_ba_result"):
        setattr(mm.ba, name, timed(name, getattr(mm.ba, name)))
    mm.op_update_point_stats = timed("op_update_point_stats", mm.op_update_point_stats)
    prof = cProfile.Profile()
    new_keyframe = mm.MapManager.new_keyframe
    counts = {"launches": 0, "n": 0}

    def profiled(self, *a, **k):
        if not on["timing"]:
            return new_keyframe(self, *a, **k)
        sync()
        t0 = time.perf_counter()
        acts = [torch.profiler.ProfilerActivity.CUDA if cuda else torch.profiler.ProfilerActivity.CPU]
        with torch.profiler.profile(activities=acts) as tp:
            out = prof.runcall(new_keyframe, self, *a, **k)
            sync()
        steps["new_keyframe"] += 1e3 * (time.perf_counter() - t0)
        counts["launches"] += sum(e.count for e in tp.key_averages() if e.device_type.name == "CUDA") if cuda else 0
        counts["n"] += 1
        return out

    mm.MapManager.new_keyframe = profiled
    for timing in (False, True):
        on["timing"] = timing
        slam = UcoSlam(device=args.device)
        slam.setParams(None, params, cam)
        for i, img in enumerate(images):
            slam.process(img, fseq=i)
        slam.clear()
    n = counts["n"]
    print(f"{n} mappings; per mapping, ms (host clock to a synchronize; new_keyframe under both profilers):")
    for name, ms in sorted(steps.items(), key=lambda kv: -kv[1]):
        print(f"  {name:28s} {ms / n:9.3f}")
    print(f"  device launches per mapping: {counts['launches'] / n:.1f}")
    for key in ("tottime", "cumulative"):
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats(key).print_stats(args.top)
        print(out.getvalue())


if __name__ == "__main__":
    main()
