"""Pass 2 of the two-pass harness (LOCALIZATION) on a saved map, in either package.

`apps.test_sequence` maps a tree in pass 1 and localizes it on the saved map
in pass 2; this replays pass 2 alone, so one package's pass 2 can run on the
other package's map (the `.slm` checkpoints are shared): `readFromFile` ->
`setMode(LOCALIZATION)` -> `resetTracker()` -> `process` of every frame of a
TUM tree, as the harness does. It prints the frames tracked; `--trace FILE`
writes, per frame, the tracker's calls (track / relocalize: ok, matches,
inliers) and, for the port, the relocalization's BoW candidates and each
candidate's PnP verification (ok, matches, inliers).

    python3 tools/port/pass2_replay.py --package port --map MAP --tree TREE [--device cuda] [--trace FILE]
    JAX_PLATFORMS=cpu python -m tools.port.pass2_replay --package jax --map MAP --tree TREE

Without `--tree`, the `loop` scenario's 150-frame tree is written first by
the port's writer (`chip_smoke.write_tree`). The camera is the parity
scenes' (fx = fy = 500, 640x480). The JAX package is imported only with
`--package jax`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)


def replay(package: str, map_path: str, tree: str, device: str = "cpu", trace: bool = False) -> dict:
    """-> {tracked: [frame, ...], trace: [per frame] or None}."""
    if package == "jax":
        from ucoslam_tpu.api import UcoSlam
        from ucoslam_tpu.config import Mode
        from ucoslam_tpu.geometry.camera import CameraParams
        from ucoslam_tpu.io.datasets import TumSequence

        slam = UcoSlam()
    else:
        from ucoslam_tpu_torch.api import UcoSlam
        from ucoslam_tpu_torch.config import Mode
        from ucoslam_tpu_torch.geometry.camera import CameraParams
        from ucoslam_tpu_torch.io.datasets import TumSequence
        from ucoslam_tpu_torch.slam.system import disable_tf32

        disable_tf32()
        slam = UcoSlam(device=device)
    ds = TumSequence.open(tree)
    slam.readFromFile(map_path, CameraParams.create(500.0, 500.0, 320.0, 240.0))
    slam.setMode(Mode.LOCALIZATION)
    slam.resetTracker()
    log = []
    if trace:
        _trace(package, slam, log)
    tracked = []
    for i in range(len(ds)):
        log.append(dict(frame=i, calls=[]))
        if slam.process(ds.read_rgb(i), fseq=i) is not None:
            tracked.append(i)
        log[-1]["ok"] = tracked[-1:] == [i]
    return dict(tracked=tracked, trace=log if trace else None)


def _trace(package: str, slam, log: list) -> None:
    """Wrap the tracker (and, in the port, the relocalization's candidate
    search and verification) to append what they did to log[-1]."""
    tr = slam._system.tracker

    def wrap(name):
        inner = getattr(tr, name)

        def logged(*a, **k):
            r = inner(*a, **k)
            log[-1]["calls"].append([name, bool(r.ok), int(r.n_matches), int(r.n_inliers)])
            return r

        setattr(tr, name, logged)

    wrap("track")
    wrap("relocalize")
    if package == "jax":
        return
    from ucoslam_tpu_torch.slam import tracker as tracker_mod

    kfdb = slam._system.manager.kfdb
    cands, verify = kfdb.relocalization_candidates, tracker_mod.match_keyframe_points_pnp_batch

    def cands_logged(*a, **k):
        out = cands(*a, **k)
        log[-1]["candidates"] = [int(c) for c in out]
        return out

    def verify_logged(*a, **k):
        cms = verify(*a, **k)
        log[-1]["verified"] = [[bool(c.ok), int(c.n_matches), int(c.n_inliers)] for c in cms]
        return cms

    kfdb.relocalization_candidates = cands_logged
    tracker_mod.match_keyframe_points_pnp_batch = verify_logged


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", choices=("port", "jax"), required=True)
    ap.add_argument("--map", required=True)
    ap.add_argument("--tree", default=None, help="a TUM tree (default: write the loop scenario's)")
    ap.add_argument("--device", default="cpu", help="the port's device")
    ap.add_argument("--trace", default=None, help="write the per-frame trace here")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as d:
        tree = args.tree
        if tree is None:
            import chip_smoke

            tree = os.path.join(d, "loop")
            chip_smoke.write_tree("loop", 150, tree)
        t0 = time.perf_counter()
        out = replay(args.package, args.map, tree, args.device, trace=args.trace is not None)
    if args.trace:
        with open(args.trace, "w") as f:
            json.dump(out["trace"], f)
    print(json.dumps(dict(package=args.package, map=os.path.basename(args.map), device=args.device,
                          tracked=len(out["tracked"]), seconds=round(time.perf_counter() - t0, 1),
                          frames=out["tracked"])))


if __name__ == "__main__":
    main()
