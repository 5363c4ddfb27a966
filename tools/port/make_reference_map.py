"""Write the reference map and reverse-sweep trajectory the PyTorch port is held to.

Runs the JAX package (on any backend; the CPU is enough) through the two-pass
protocol on the rendered `mono` scenario:

- pass 1: SLAM over frames 0..F-1 from a fresh system, then `saveToFile`;
- pass 2: `readFromFile` -> `setMode(LOCALIZATION)` -> `process(render(i))`
  for i = F-1 .. 0 (the reverse sweep), starting from the pose the
  checkpoint restores.

The sequence is the `mono` parity scenario at the library's default widths
(the constants below), over `--frames` frames (default 60). Outputs, under
`--out-dir` (default `data/torch_port`): `mono_map.slm` (the checkpoint) and
`mono_reverse_jax.json` (pass-1/2 tracked counts, ATE, keyframe insertions,
the pass-2 poses, and the scene's depth extent used by the per-frame gate);
with another frame count F, `monoF_map.slm` and `monoF_reverse_jax.json`.

    JAX_PLATFORMS=cpu python -m tools.port.make_reference_map [--frames 150]

With `--init-seeds N`, runs only pass 1, once for each of N keys of the
two-view init's draws (0x1717, the package's own, then 1, 2, ...), and
writes `mono[F]_init_spread_jax.json` (per key: tracked frames, ATE,
keyframes, points), the JAX side of `tools/port/slam_spread.py`.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ucoslam_tpu.api import UcoSlam
from ucoslam_tpu.config import Mode, Params
from ucoslam_tpu.geometry.camera import CameraParams
from ucoslam_tpu.geometry.horn import ate_rmse
from ucoslam_tpu.io.synthetic import SyntheticSequence

SEQUENCE = dict(n_frames=60, n_points=1600, seed=5)  # tools/parity/run_parity.py `mono`
CAMERA = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480)
PARAMS = Params().replace(detectMarkers=False, maxDescDistance=60.0)


def camera_center(pose_f2g: np.ndarray) -> np.ndarray:
    pose = np.asarray(pose_f2g, np.float64)
    return -pose[:3, :3].T @ pose[:3, 3]


def ate_of(poses: dict[int, np.ndarray], seq: SyntheticSequence) -> float:
    idx = sorted(poses)
    if len(idx) < 3:
        return float("inf")
    est = np.stack([camera_center(poses[i]) for i in idx])
    return ate_rmse(est, seq.gt_positions()[idx], with_scale=True)


def map_depth_extent(slam: UcoSlam) -> float:
    """1st-99th percentile spread of the active map points' z (the map frame
    is the first keyframe's camera, so z is depth), in map units."""
    st = slam.map.state
    z = np.asarray(st.pt_pos)[np.asarray(st.pt_active), 2]
    lo, hi = np.percentile(z, [1.0, 99.0])
    return float(hi - lo)


def run(params: Params, cam: CameraParams, seq: SyntheticSequence, map_path: str):
    """-> (summary dict, reverse-sweep poses {frame: 4x4})."""
    frames = seq.n_frames
    slam = UcoSlam()
    slam.setParams(None, params, cam)
    fwd = {}
    for i in range(frames):
        pose = slam.process(seq.render(i), fseq=i)
        if pose is not None:
            fwd[i] = np.asarray(pose, np.float32)
    saved_signature = slam.map.signature()
    slam.saveToFile(map_path)
    extent = map_depth_extent(slam)

    loc = UcoSlam()
    loc.readFromFile(map_path, cam)
    loc.setMode(Mode.LOCALIZATION)
    rev = {}
    for i in reversed(range(frames)):
        pose = loc.process(seq.render(i), fseq=i)
        if pose is not None:
            rev[i] = np.asarray(pose, np.float32)
    summary = {
        "pass1_tracked": len(fwd),
        "pass1_ate": ate_of(fwd, seq),
        "pass2_tracked": len(rev),
        "pass2_ate": ate_of(rev, seq),
        "n_points": slam.map.n_points,
        "n_keyframes": slam.map.n_keyframes,
        "pass1_insertions": slam._system.manager.kf_counter - 2,  # after the two-view init
        "map_signature": saved_signature,
        "depth_extent": extent,
    }
    return summary, rev


def init_spread(params: Params, cam: CameraParams, seq: SyntheticSequence, n_keys: int) -> list[dict]:
    """Pass 1 once per PRNG key of the initializer's draws."""
    import jax

    runs = []
    for key in [0x1717] + list(range(1, n_keys)):
        slam = UcoSlam()
        slam.setParams(None, params, cam)
        slam._system.initializer._key = jax.random.PRNGKey(key)
        fwd = {}
        for i in range(seq.n_frames):
            pose = slam.process(seq.render(i), fseq=i)
            if pose is not None:
                fwd[i] = np.asarray(pose, np.float32)
        runs.append(dict(key=key, init_frame=min(fwd) if fwd else None, tracked=len(fwd), ate=ate_of(fwd, seq),
                         keyframes=slam.map.n_keyframes, points=slam.map.n_points))
        print(json.dumps(runs[-1]), flush=True)
    return runs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out-dir", default="data/torch_port")
    ap.add_argument("--frames", type=int, default=SEQUENCE["n_frames"])
    ap.add_argument("--init-seeds", type=int, default=0)
    args = ap.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    c = CAMERA
    cam = CameraParams.create(c["fx"], c["fy"], c["cx"], c["cy"], width=c["width"], height=c["height"])
    sequence = dict(SEQUENCE, n_frames=args.frames)
    seq = SyntheticSequence(cam=cam, **sequence)
    name = "mono" if args.frames == SEQUENCE["n_frames"] else f"mono{args.frames}"
    if args.init_seeds:
        runs = init_spread(PARAMS, cam, seq, args.init_seeds)
        with open(os.path.join(args.out_dir, f"{name}_init_spread_jax.json"), "w") as f:
            json.dump({"sequence": sequence, "runs": runs}, f, indent=1)
        return
    map_path = os.path.join(args.out_dir, f"{name}_map.slm")
    summary, rev = run(PARAMS, cam, seq, map_path)
    out = {
        "sequence": sequence,
        "camera": CAMERA,
        **summary,
        "slm_bytes": os.path.getsize(map_path),
        "reverse_poses": {str(i): rev[i].tolist() for i in sorted(rev)},
    }
    with open(os.path.join(args.out_dir, f"{name}_reverse_jax.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "reverse_poses"}))


if __name__ == "__main__":
    main()
