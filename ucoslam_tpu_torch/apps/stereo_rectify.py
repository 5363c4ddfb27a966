"""Stereo rectification calibration tool.

Counterpart of tests/euroc_stereoRectification.cpp: consume a stereo
calibration (two pinhole cameras + extrinsics) and emit the rectified
camera file consumed by the stereo SLAM runner; optionally rectify a pair
of images as a visual check.

Calibration YAML keys: fx1 fy1 cx1 cy1 k1_1..k5_1, fx2 ... , and either
R (9 floats row-major) + T (3 floats) or rvec (3) + T.

Port of `ucoslam_tpu/apps/stereo_rectify.py`, over the port's
`io.stereorectify.StereoRectify` (on `--device`, default `cuda`) and its PNG
codec `io.png`.

Usage:
  python -m ucoslam_tpu_torch.apps.stereo_rectify calib.yml --out rect_cam.yml
      [--left l.png --right r.png --out-dir rectified/] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _parse_calib(path: str):
    import torch

    from ucoslam_tpu_torch.geometry.camera import CameraParams
    from ucoslam_tpu_torch.geometry.se3 import so3_exp

    vals = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if ":" in line and not line.startswith(("%", "#")):
                k, _, v = line.partition(":")
                try:
                    vals[k.strip()] = [float(x) for x in v.split()]
                except ValueError:
                    pass

    def cam(i):
        g = lambda k, d=0.0: vals.get(f"{k}{i}", [d])[0]  # noqa: E731
        return CameraParams.create(
            g("fx", 460), g("fy", 460), g("cx", 320), g("cy", 240),
            dist=[g("k1_"), g("k2_"), g("p1_"), g("p2_"), g("k3_")],
            width=int(g("width", 640)), height=int(g("height", 480)),
        )

    if "R" in vals and len(vals["R"]) == 9:
        R = np.asarray(vals["R"]).reshape(3, 3)
    elif "rvec" in vals:
        R = so3_exp(torch.from_numpy(np.asarray(vals["rvec"], np.float32))[None])[0].numpy()
    else:
        R = np.eye(3)
    T = np.asarray(vals.get("T", [-0.1, 0, 0]))
    return cam(1), cam(2), R, T


def main(argv=None) -> int:
    from ucoslam_tpu_torch.io.stereorectify import StereoRectify

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("calib")
    ap.add_argument("--out", default="rectified_camera.yml")
    ap.add_argument("--left")
    ap.add_argument("--right")
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--device", default="cuda", help="torch device of the remap (cuda, cpu)")
    args = ap.parse_args(argv)

    cam_l, cam_r, R, T = _parse_calib(args.calib)
    sr = StereoRectify(cam_l, cam_r, R, T, device=args.device)
    cam = sr.rectified_camera()
    with open(args.out, "w") as f:
        f.write("%YAML:1.0\n---\n")
        for k, v in (
            ("fx", float(cam.fx)), ("fy", float(cam.fy)),
            ("cx", float(cam.cx)), ("cy", float(cam.cy)),
            ("width", cam.width), ("height", cam.height), ("bl", cam.bl),
        ):
            f.write(f"{k}: {v}\n")
    print(f"rectified camera (f={float(cam.fx):.2f}, bl={cam.bl:.4f}) -> {args.out}")

    if args.left and args.right:
        import os

        from ucoslam_tpu_torch.io import png

        left = png.imread(args.left, gray=True)
        right = png.imread(args.right, gray=True)
        lr, rr = sr.rectify(left, right)
        png.imwrite(os.path.join(args.out_dir, "rect_left.png"), np.clip(lr, 0, 255).astype(np.uint8))
        png.imwrite(os.path.join(args.out_dir, "rect_right.png"), np.clip(rr, 0, 255).astype(np.uint8))
        print(f"rectified images -> {args.out_dir}/rect_*.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
