"""Trajectory evaluation: ATE + tracked percentage vs ground truth.

Counterpart of tests/comparelogs.cpp (prints `ATE=` and tracked fraction,
:55-61) on top of tests/logtools.cpp's Horn-1987 alignment (:153,291).

Port of `ucoslam_tpu/apps/compare_logs.py`, over the port's
`geometry.horn.ate_rmse` and `io.datasets`.

Usage: python -m ucoslam_tpu_torch.apps.compare_logs est.txt groundtruth.txt
       [--no-scale] [--max-dt 0.02]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def evaluate(est_path: str, gt_path: str, with_scale: bool = True, max_dt: float = 0.02):
    from ucoslam_tpu_torch.geometry.horn import ate_rmse
    from ucoslam_tpu_torch.io.datasets import associate_trajectories, load_trajectory_tum

    st_e, c_e, _ = load_trajectory_tum(est_path)
    st_g, c_g, _ = load_trajectory_tum(gt_path)
    pairs = associate_trajectories(st_e, st_g, max_dt)
    if len(pairs) < 3:
        return None
    ei = np.asarray([p[0] for p in pairs])
    gi = np.asarray([p[1] for p in pairs])
    ate = ate_rmse(c_e[ei], c_g[gi], with_scale=with_scale)
    pct = len(pairs) / max(len(st_g), 1)
    return ate, pct, len(pairs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("est")
    ap.add_argument("gt")
    ap.add_argument("--no-scale", action="store_true")
    ap.add_argument("--max-dt", type=float, default=0.02)
    args = ap.parse_args(argv)
    out = evaluate(args.est, args.gt, not args.no_scale, args.max_dt)
    if out is None:
        print("ATE=nan matched=0")
        return 1
    ate, pct, n = out
    print(f"ATE={ate:.6f} perctFramesTracked={pct:.4f} matched={n}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
