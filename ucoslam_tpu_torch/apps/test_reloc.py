"""Per-frame relocalization benchmark against a prebuilt map.

Counterpart of tests/test_reloc.cpp: load a map, then for every frame of
the sequence attempt relocalization from scratch (tracker reset before
each frame) and report the success rate and mean position error.

Port of `ucoslam_tpu/apps/test_reloc.py`; the engine runs on `--device`
(default `cuda`).

Usage:
  python -m ucoslam_tpu_torch.apps.test_reloc --map map.slm --synthetic 30
  python -m ucoslam_tpu_torch.apps.test_reloc --map map.slm --dataset tum_dir \\
      --camera cam.yml [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    from ucoslam_tpu_torch.api import UcoSlam
    from ucoslam_tpu_torch.config import Mode

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--map", required=True)
    ap.add_argument("--dataset")
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--camera")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--bruteforce",
        action="store_true",
        help="disable the BoW keyframe database (DummyDataBase path): "
        "relocalize by brute-force matching against the whole point arena",
    )
    ap.add_argument("--device", default="cuda", help="torch device the engine runs on (cuda, cpu)")
    args = ap.parse_args(argv)

    if args.synthetic:
        from ucoslam_tpu_torch.io.synthetic import SyntheticSequence

        seq = SyntheticSequence(n_frames=args.synthetic, seed=args.seed)
        cam = seq.cam
        n = seq.n_frames
        get_img = seq.render
        gt = seq.gt_positions()
    else:
        from ucoslam_tpu_torch.apps.run_slam import load_camera_yml
        from ucoslam_tpu_torch.io.datasets import TumSequence

        tum = TumSequence.open(args.dataset)
        cam = load_camera_yml(args.camera)
        n = len(tum)
        get_img = lambda i: tum.read_rgb(i)  # noqa: E731
        gt = None

    slam = UcoSlam(device=args.device)
    slam.readFromFile(args.map, cam)
    slam.setMode(Mode.LOCALIZATION)
    if args.bruteforce:
        slam._system.manager.kfdb.dummy = True

    ok, errs = 0, []
    for i in range(n):
        slam.resetTracker()  # force cold relocalization every frame
        pose = slam.process(get_img(i), fseq=i)
        if pose is not None:
            ok += 1
            if gt is not None:
                c = -pose[:3, :3].T @ pose[:3, 3]
                errs.append(np.linalg.norm(c - gt[i]))
        print(f"|@# Reloc {i + 1}/{n} ok={pose is not None}", flush=True)
    rate = ok / max(n, 1)
    line = f"relocRate={rate:.4f} ({ok}/{n})"
    if errs:
        line += f" meanPosErr={np.mean(errs):.4f}"
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
