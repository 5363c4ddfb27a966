"""SLAM/localization runner over a dataset directory or synthetic sequence.

Counterpart of the reference CLI apps utils/monocular_slam.cpp,
stereo_slam.cpp, rgbd_slam.cpp and monocular_tracking.cpp: consume an image
stream + camera parameters, run the engine, emit a TUM trajectory and
optionally save/load the map.

Port of `ucoslam_tpu/apps/run_slam.py`; the engine runs on `--device`
(default `cuda`), and images are decoded by the port's `io.png`.

Usage:
  python -m ucoslam_tpu_torch.apps.run_slam --dataset /path/to/tum_dir \\
      --camera cam.yml --out traj.txt [--mode slam|localization]
      [--in-map map.slm] [--out-map map.slm] [--params params.yml]
      [--synthetic N] [--rgbd] [--global-ba] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time



def load_camera_yml(path: str):
    """Minimal OpenCV-style camera YAML: fx fy cx cy k1..k5 width height bl."""
    from ucoslam_tpu_torch.geometry.camera import CameraParams

    vals = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if ":" in line and not line.startswith(("%", "#")):
                k, _, v = line.partition(":")
                try:
                    vals[k.strip()] = float(v.strip())
                except ValueError:
                    pass
    dist = [vals.get(k, 0.0) for k in ("k1", "k2", "p1", "p2", "k3")]
    return CameraParams.create(
        vals.get("fx", 500.0), vals.get("fy", 500.0),
        vals.get("cx", 320.0), vals.get("cy", 240.0),
        dist=dist,
        width=int(vals.get("width", 640)), height=int(vals.get("height", 480)),
        bl=vals.get("bl", 0.0),
        rgb_depthscale=vals.get("rgb_depthscale", 1.0 / 5000.0),
    )


def main(argv=None) -> int:
    from ucoslam_tpu_torch.api import UcoSlam
    from ucoslam_tpu_torch.config import Mode, Params
    from ucoslam_tpu_torch.io.datasets import TumSequence, save_trajectory_tum

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", help="dataset directory (TUM/EuRoC/KITTI)")
    ap.add_argument(
        "--format", choices=["tum", "euroc", "kitti"],
        help="dataset layout; sniffed from the directory when omitted",
    )
    ap.add_argument("--stereo", action="store_true")
    ap.add_argument("--synthetic", type=int, default=0, help="run N synthetic frames")
    ap.add_argument("--camera", help="camera YAML")
    ap.add_argument(
        "--voc", default="auto",
        help="vocabulary .fbow; 'auto' = bundled data/vocab.fbow, 'none' = off",
    )
    ap.add_argument("--params", help="params YAML")
    ap.add_argument("--out", default="trajectory.txt")
    ap.add_argument("--mode", choices=["slam", "localization"], default="slam")
    ap.add_argument("--in-map", dest="in_map")
    ap.add_argument("--out-map", dest="out_map")
    ap.add_argument("--rgbd", action="store_true")
    ap.add_argument("--global-ba", action="store_true")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--viewer", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device the engine runs on (cuda, cpu)")
    args = ap.parse_args(argv)

    params = Params.load_yml(args.params) if args.params else Params().replace(
        maxMapPoints=8192, maxKeyFrames=64, maxKeyPointsPerFrame=1024,
        maxDescDistance=60.0,
    )

    get_right = None
    if args.synthetic:
        from ucoslam_tpu_torch.io.synthetic import SyntheticSequence

        seq = SyntheticSequence(n_frames=args.synthetic)
        cam = seq.cam
        frames = [(i / 30.0, lambda i=i: seq.render(i), None) for i in range(seq.n_frames)]
    else:
        if not args.dataset:
            ap.error("--dataset or --synthetic required")
        from ucoslam_tpu_torch.geometry.camera import CameraParams
        from ucoslam_tpu_torch.io.datasets import (
            EurocSequence,
            KittiSequence,
            detect_dataset_format,
        )

        fmt = args.format or detect_dataset_format(args.dataset)
        if fmt == "euroc":
            ds = EurocSequence.open(args.dataset, stereo=args.stereo)
            cam = load_camera_yml(args.camera) if args.camera else ds.camera()
            frames = [
                (float(ds.stamps[i]), lambda i=i: ds.read(i), None)
                for i in range(len(ds))
            ]
            if args.stereo and ds.files1 is not None:
                get_right = lambda i: ds.read(i, 1)  # noqa: E731
        elif fmt == "kitti":
            ds = KittiSequence.open(args.dataset)
            cam = load_camera_yml(args.camera) if args.camera else ds.camera()
            frames = [
                (float(ds.stamps[i]), lambda i=i: ds.read(i), None)
                for i in range(len(ds))
            ]
            if args.stereo and ds.files1 is not None:
                get_right = lambda i: ds.read(i, 1)  # noqa: E731
        else:
            tum = TumSequence.open(args.dataset)
            cam = (
                load_camera_yml(args.camera)
                if args.camera
                else CameraParams.create(500.0, 500.0, 320.0, 240.0)
            )
            frames = [
                (tum.rgb[i][0], lambda i=i: tum.read_rgb(i),
                 (lambda i=i: tum.read_depth_for(i)) if args.rgbd else None)
                for i in range(len(tum))
            ]
    if args.max_frames:
        frames = frames[: args.max_frames]

    slam = UcoSlam(device=args.device)
    if args.in_map:
        slam.readFromFile(args.in_map, cam)
    else:
        from ucoslam_tpu_torch.io.fbow import default_vocab_path

        voc = args.voc if args.voc not in (None, "auto") else default_vocab_path()
        if args.voc == "none":
            voc = None
        slam.setParams(None, params, cam, vocabulary=voc)
    slam.setMode(Mode.LOCALIZATION if args.mode == "localization" else Mode.SLAM)

    viewer = None
    if args.viewer:
        from ucoslam_tpu_torch.viz.viewer import MapViewer

        viewer = MapViewer()

    stamps, poses = [], []
    t0 = time.time()
    for i, (stamp, get_img, get_depth) in enumerate(frames):
        img = get_img()
        if get_right is not None:
            pose = slam.processStereo(img, get_right(i), fseq=i)
        elif get_depth is not None:
            depth = get_depth()
            pose = slam.processRGBD(img, depth, fseq=i) if depth is not None else None
        else:
            pose = slam.process(img, fseq=i)
        if pose is not None:
            stamps.append(stamp)
            poses.append(pose)
        if viewer is not None:
            viewer.show(slam.map, img, pose)
        fps = (i + 1) / max(time.time() - t0, 1e-9)
        print(
            f"|@# Image {i + 1}/{len(frames)} fps={fps:.2f} "
            f"sig={slam.getSignatureStr()} tracked={pose is not None}",
            flush=True,
        )

    if args.mode == "slam":
        slam.waitForFinished()
        if args.global_ba:
            slam.globalOptimization()
    save_trajectory_tum(args.out, stamps, poses)
    print(f"tracked {len(poses)}/{len(frames)} frames -> {args.out}")
    if args.out_map:
        slam.saveToFile(args.out_map)
        print(f"map saved -> {args.out_map}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
