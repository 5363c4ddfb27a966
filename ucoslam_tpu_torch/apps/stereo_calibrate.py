"""Chessboard stereo calibration tool.

Port of `ucoslam_tpu/apps/stereo_calibrate.py` (the reference's
utils/ucoslam_stereocalibrate.cpp): detect chessboard corners in paired
L/R images, calibrate each camera, run stereo calibration, and write the
stereo YML (M1/D1/M2/D2/R/T/R1/R2/P1/P2/Q keys, the reference's FileStorage
layout, which `io.stereorectify` consumes).

A host tool on cv2, as the reference's: chessboard detection and
calibration have no other backend in the port. Without cv2 it raises
cv2's ImportError; the rest of the port needs no cv2.

Usage:
  python -m ucoslam_tpu_torch.apps.stereo_calibrate <image_dir> out_stereo.yml
      [--width 9] [--height 6] [--square 1.0]

The image dir holds alternating or suffixed pairs: *_left*/*_right*,
*_0*/*_1*, or sorted pairs (even=left, odd=right).
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np


def _pair_images(d: str) -> list[tuple[str, str]]:
    files = sorted(
        f for f in glob.glob(os.path.join(d, "*"))
        if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp", ".tif"))
    )
    lefts = [f for f in files if "left" in os.path.basename(f).lower()]
    rights = [f for f in files if "right" in os.path.basename(f).lower()]
    if lefts and len(lefts) == len(rights):
        return list(zip(sorted(lefts), sorted(rights)))
    return list(zip(files[0::2], files[1::2]))


def calibrate_stereo_pairs(
    pairs: list[tuple[np.ndarray, np.ndarray]],
    board=(9, 6),
    square: float = 1.0,
):
    """Corner detection + stereo calibration over L/R gray image pairs.

    Returns dict with M1 D1 M2 D2 R T rms image_size or None when too few
    boards are found.
    """
    import cv2

    objp = np.zeros((board[0] * board[1], 3), np.float32)
    objp[:, :2] = np.mgrid[0:board[0], 0:board[1]].T.reshape(-1, 2) * square
    obj_pts, l_pts, r_pts = [], [], []
    size = None
    crit = (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 1e-5)
    for L, R in pairs:
        size = (L.shape[1], L.shape[0])
        okl, cl = cv2.findChessboardCorners(L, board)
        okr, cr = cv2.findChessboardCorners(R, board)
        if not (okl and okr):
            continue
        cl = cv2.cornerSubPix(L, cl, (11, 11), (-1, -1), crit)
        cr = cv2.cornerSubPix(R, cr, (11, 11), (-1, -1), crit)
        obj_pts.append(objp)
        l_pts.append(cl)
        r_pts.append(cr)
    if len(obj_pts) < 3:
        return None
    _, M1, D1, _, _ = cv2.calibrateCamera(obj_pts, l_pts, size, None, None)
    _, M2, D2, _, _ = cv2.calibrateCamera(obj_pts, r_pts, size, None, None)
    rms, M1, D1, M2, D2, R, T, _, _ = cv2.stereoCalibrate(
        obj_pts, l_pts, r_pts, M1, D1, M2, D2, size,
        criteria=crit, flags=cv2.CALIB_FIX_INTRINSIC,
    )
    return dict(M1=M1, D1=D1, M2=M2, D2=D2, R=R, T=T, rms=rms, image_size=size)


def write_stereo_yml(path: str, calib: dict) -> None:
    """Write the reference's stereo YML layout
    (ucoslam_stereocalibrate.cpp:298-307)."""
    import cv2

    w, h = calib["image_size"]
    R1, R2, P1, P2, Q, _, _ = cv2.stereoRectify(
        calib["M1"], calib["D1"], calib["M2"], calib["D2"], (w, h),
        calib["R"], calib["T"],
    )
    fs = cv2.FileStorage(path, cv2.FILE_STORAGE_WRITE)
    fs.write("image_width", int(w))
    fs.write("image_height", int(h))
    for k in ("M1", "D1", "M2", "D2", "R", "T"):
        fs.write(k, np.asarray(calib[k], np.float64))
    fs.write("R1", R1)
    fs.write("R2", R2)
    fs.write("P1", P1)
    fs.write("P2", P2)
    fs.write("Q", Q)
    fs.release()


def main(argv=None) -> int:
    import cv2

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("image_dir")
    ap.add_argument("out_yml")
    ap.add_argument("--width", type=int, default=9)
    ap.add_argument("--height", type=int, default=6)
    ap.add_argument("--square", type=float, default=1.0)
    args = ap.parse_args(argv)

    pairs = []
    for lf, rf in _pair_images(args.image_dir):
        L = cv2.imread(lf, cv2.IMREAD_GRAYSCALE)
        R = cv2.imread(rf, cv2.IMREAD_GRAYSCALE)
        if L is not None and R is not None:
            pairs.append((L, R))
    if not pairs:
        print("no image pairs found", file=sys.stderr)
        return 1
    calib = calibrate_stereo_pairs(
        pairs, (args.width, args.height), args.square
    )
    if calib is None:
        print("chessboard not found in enough pairs (need >= 3)", file=sys.stderr)
        return 1
    write_stereo_yml(args.out_yml, calib)
    print(
        f"rms={calib['rms']:.4f} baseline={np.linalg.norm(calib['T']):.4f} "
        f"-> {args.out_yml}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
