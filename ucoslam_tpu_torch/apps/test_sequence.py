"""Two-pass benchmark harness: map (SLAM) then evaluate (LOCALIZATION).

Port of `ucoslam_tpu/apps/test_sequence.py` (the counterpart of
tests/test_sequence.cpp :156-420): pass 1 runs full SLAM over the sequence
with per-frame `|@#` signature lines (and the stage timers: extract, track,
reloc, mapping, localBA, loop), then waitForFinished + globalOptimization
and a map save; pass 2 re-runs the same sequence in MODE_LOCALIZATION and
the pass-2 trajectory is what gets evaluated (the paper's protocol).
Supports the `-recovery` rollback: on tracking loss, reload the last
checkpoint, rewind 15 frames and temporarily tighten keyframe params
(test_sequence.cpp:268-296).

Images are read from disk with the port's own PNG decoder (`io.png`, no
cv2). The engine runs on `--device` (default `cuda`). Besides the
reference's lines it prints the median time to read and decode one frame
(`decodeMs=`) and writes `<out-dir>/summary.json` with every number of its
last lines.

Usage:
  python -m ucoslam_tpu_torch.apps.test_sequence --synthetic 60 --out-dir /tmp/run
  python -m ucoslam_tpu_torch.apps.test_sequence --dataset tum_dir --camera cam.yml \\
      --out-dir results [--recovery] [--save-every 100] [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time


def main(argv=None) -> int:
    from ucoslam_tpu_torch.api import UcoSlam
    from ucoslam_tpu_torch.apps.run_slam import load_camera_yml
    from ucoslam_tpu_torch.config import Mode, Params
    from ucoslam_tpu_torch.io.datasets import save_trajectory_tum

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset")
    ap.add_argument(
        "--format", choices=["tum", "euroc", "kitti"],
        help="dataset layout; sniffed from the directory when omitted",
    )
    ap.add_argument(
        "--preset",
        help="param preset (kitti/euroc/euroc_difficult/spm/tum); defaults "
        "to the detected format (test_generator_monocular.sh presets)",
    )
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--synthetic-traj", default="arc",
                    help="synthetic trajectory: arc|line|loop|orbit_out|sweep_back")
    ap.add_argument("--synthetic-points", type=int, default=1200)
    ap.add_argument("--synthetic-markers", type=int, default=0)
    ap.add_argument("--stereo", action="store_true")
    ap.add_argument("--rgbd", action="store_true",
                    help="TUM RGB-D: feed depth.txt frames through processRGBD")
    ap.add_argument("--gt", help="ground-truth file (KITTI poses.txt)")
    ap.add_argument("--camera")
    ap.add_argument(
        "--voc", default="auto",
        help="vocabulary .fbow; 'auto' = bundled data/vocab.fbow, 'none' = off",
    )
    ap.add_argument("--params")
    ap.add_argument("--out-dir", default="results")
    ap.add_argument("--recovery", action="store_true")
    ap.add_argument("--save-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device the engine runs on (cuda, cpu)")
    ap.add_argument(
        "--profile", action="store_true",
        help="write a torch.profiler Chrome trace of pass 1, the program's spans beside it, to "
             "<out-dir>/trace/trace.json",
    )
    ap.add_argument("--debug-level", type=int, default=0)
    ap.add_argument(
        "--dbg-str", action="append", default=[],
        help="debug string-registry entries key[=value] (Debug::addString)",
    )
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)

    from ucoslam_tpu_torch.utils import Debug, timers

    Debug.setLevel(args.debug_level)
    for s in args.dbg_str:
        k, _, v = s.partition("=")
        Debug.addString(k, v)

    params = Params.load_yml(args.params) if args.params else Params().replace(
        maxMapPoints=8192, maxKeyFrames=64, maxKeyPointsPerFrame=1024,
        maxDescDistance=60.0,
    )

    get_right = None
    get_depth = None
    if args.synthetic:
        from ucoslam_tpu_torch.io.synthetic import SyntheticSequence

        seq = SyntheticSequence(
            n_frames=args.synthetic, seed=args.seed,
            trajectory=args.synthetic_traj, n_points=args.synthetic_points,
            n_markers=args.synthetic_markers,
        )
        cam = seq.cam
        n = seq.n_frames
        get_img = seq.render
        if args.stereo:
            get_right = lambda i: seq.render_stereo(i)[1]  # noqa: E731
        stamps = [i / 30.0 for i in range(n)]
        gt_path = os.path.join(args.out_dir, "groundtruth.txt")
        save_trajectory_tum(gt_path, stamps, [seq.gt_pose(i) for i in range(n)])
    else:
        from ucoslam_tpu_torch.geometry.camera import CameraParams
        from ucoslam_tpu_torch.io.datasets import (
            EurocSequence,
            KittiSequence,
            TumSequence,
            dataset_preset,
            detect_dataset_format,
        )

        fmt = args.format or detect_dataset_format(args.dataset)
        over, harness = dataset_preset(args.preset or fmt)
        if over and not args.params:
            params = params.replace(**over)
        if harness.get("recovery"):
            args.recovery = True
        gt_tuple = None
        if fmt == "euroc":
            ds = EurocSequence.open(args.dataset, stereo=args.stereo)
            cam = load_camera_yml(args.camera) if args.camera else ds.camera()
            n = len(ds)
            get_img = lambda i: ds.read(i)  # noqa: E731
            if args.stereo and ds.files1 is not None:
                get_right = lambda i: ds.read(i, 1)  # noqa: E731
            stamps = list(ds.stamps)
            gt_tuple = ds.gt
            gt_path = os.path.join(args.out_dir, "groundtruth.txt")
        elif fmt == "kitti":
            gt_file = args.gt or os.path.join(args.dataset, "poses.txt")
            ds = KittiSequence.open(args.dataset, poses_file=gt_file)
            cam = load_camera_yml(args.camera) if args.camera else ds.camera()
            n = len(ds)
            get_img = lambda i: ds.read(i)  # noqa: E731
            if args.stereo and ds.files1 is not None:
                get_right = lambda i: ds.read(i, 1)  # noqa: E731
            stamps = list(ds.stamps)
            gt_tuple = ds.gt
            gt_path = os.path.join(args.out_dir, "groundtruth.txt")
        else:
            tum = TumSequence.open(args.dataset)
            cam = (
                load_camera_yml(args.camera)
                if args.camera
                else CameraParams.create(500.0, 500.0, 320.0, 240.0)
            )
            n = len(tum)
            get_img = lambda i: tum.read_rgb(i)  # noqa: E731
            if args.rgbd:
                # reference processRGBD ingest (ucoslam.cpp:23-27): raw
                # 16-bit TUM depth scaled by rgb_depthscale in the extractor
                get_depth = lambda i: tum.read_depth_for(i)  # noqa: E731
            stamps = [tum.rgb[i][0] for i in range(n)]
            gt_path = os.path.join(args.dataset, "groundtruth.txt")
        if gt_tuple is not None:
            # re-emit EuRoC/KITTI ground truth in the TUM evaluation format
            gs, gc, gq = gt_tuple
            with open(gt_path, "w") as f:
                for t, c, q in zip(gs, gc, gq):
                    f.write(
                        f"{t:.6f} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f} "
                        f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
                    )

    # each read of an image (left or only) timed: decode ms a frame
    decode_ms = []
    read_img = get_img

    def get_img(i):
        t = time.perf_counter()
        img = read_img(i)
        decode_ms.append(1e3 * (time.perf_counter() - t))
        return img

    map_path = os.path.join(args.out_dir, "map.slm")
    ckpt_path = os.path.join(args.out_dir, "lost_track.slm")

    # ---------------- pass 1: SLAM ----------------
    from ucoslam_tpu_torch.io.fbow import default_vocab_path
    from ucoslam_tpu_torch.utils.timers import profile_trace

    slam = UcoSlam(device=args.device)
    voc = args.voc if args.voc not in (None, "auto") else default_vocab_path()
    if args.voc == "none":
        voc = None
    slam.setParams(None, params, cam, vocabulary=voc)
    timers.reset()
    was_tracing = timers.enabled
    timers.start()  # the stage times of the |@# lines are read from the spans
    trace_cm = (
        profile_trace(os.path.join(args.out_dir, "trace"))
        if args.profile
        else contextlib.nullcontext()
    )
    t0 = time.time()
    i = 0
    last_ckpt_frame = 0
    p1_tracked = set()  # frame indices tracked at least once in pass 1
    frame_dt = []  # per-frame wall seconds (pass 1)
    recovered = 0
    rewinds = []  # (lost frame, frame rewound to) of each rollback
    recoveries_here = 0
    tightened_until = -1  # frame past which normal params are restored
    prefetched = (-1, None)
    with trace_cm:
        while i < n:
            t_frame = time.time()
            # overlap the next image's host->device upload with this
            # frame's host work (decode + device copy off the hot path)
            img_i = prefetched[1] if prefetched[0] == i else get_img(i)
            if i + 1 < n and get_right is None:
                nxt = get_img(i + 1)
                slam.prefetch(nxt)
                prefetched = (i + 1, nxt)
            if get_right is not None:
                pose = slam.processStereo(img_i, get_right(i), fseq=i)
            elif get_depth is not None:
                pose = slam.processRGBD(img_i, get_depth(i), fseq=i)
            else:
                pose = slam.process(img_i, fseq=i)
            if pose is not None:
                p1_tracked.add(i)
            if pose is not None and 0 <= tightened_until <= i:
                # re-acquired and past the loss point: restore normal KF
                # params (reference restores 5 frames past the loss,
                # tests/test_sequence.cpp:268-296)
                slam.updateParams(params)
                tightened_until = -1
            frame_dt.append(time.time() - t_frame)
            fps = (i + 1) / max(time.time() - t0, 1e-9)
            print(
                f"|@# Image {i + 1}/{n} fps={fps:.2f} "
                f"sig={slam.getSignatureStr()} {timers.report()}",
                flush=True,
            )
            if not args.profile:
                timers.drain()  # the stage times keep what they read
            if args.save_every and i > 0 and i % args.save_every == 0:
                slam.saveToFile(ckpt_path)
                last_ckpt_frame = i
                recoveries_here = 0
            if (
                args.recovery
                and pose is None
                and slam.map.n_keyframes > 2
                and os.path.exists(ckpt_path)
                and i - last_ckpt_frame > 15
                and recoveries_here < 3
            ):
                # rollback protocol: reload checkpoint, rewind 15 frames,
                # tighten KF params temporarily (test_sequence.cpp:268-296).
                # Deterministic replays re-lose identically, so at most 3
                # rollbacks per checkpoint region — then carry on forward
                # (reloc may still re-acquire the map later).
                slam.readFromFile(ckpt_path, cam)
                # the tightened params must reach the live System's copies
                # (updateParams): readFromFile just rebuilt it from the
                # checkpoint's params
                slam.updateParams(slam._params.replace(
                    KFMinConfidence=0.9, KFCulling=0.9,
                    projDistThr=1.5 * slam._params.projDistThr,
                ))
                tightened_until = i + 5
                rewinds.append((i, max(last_ckpt_frame, i - 15)))
                i = max(last_ckpt_frame, i - 15)
                recovered += 1
                recoveries_here += 1
                continue
            i += 1
    slam.waitForFinished()
    slam.globalOptimization()
    slam.saveToFile(map_path)
    t_map = time.time() - t0
    stages = {k: 1e3 * t for k, t in timers.averages().items()}
    timers.enabled = was_tracing

    # ---------------- pass 2: LOCALIZATION ----------------
    slam2 = UcoSlam(device=args.device)
    slam2.readFromFile(map_path, cam)
    slam2.setMode(Mode.LOCALIZATION)
    slam2.resetTracker()
    t1 = time.time()
    est_stamps, est_poses = [], []
    prefetched = (-1, None)
    for i in range(n):
        img_i = prefetched[1] if prefetched[0] == i else get_img(i)
        if i + 1 < n and get_right is None:
            nxt = get_img(i + 1)
            slam2.prefetch(nxt)
            prefetched = (i + 1, nxt)
        if get_right is not None:
            pose = slam2.processStereo(img_i, get_right(i), fseq=i)
        elif get_depth is not None:
            pose = slam2.processRGBD(img_i, get_depth(i), fseq=i)
        else:
            pose = slam2.process(img_i, fseq=i)
        if pose is not None:
            est_stamps.append(stamps[i])
            est_poses.append(pose)
    t_track = time.time() - t1

    est_path = os.path.join(args.out_dir, "trajectory.txt")
    save_trajectory_tum(est_path, est_stamps, est_poses)
    import resource

    maxrss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    # steady-state fps: median per-frame wall time once the session is warm
    # (the first frames pay one-time costs: the kernels' builds and the
    # allocator's first requests)
    warm = sorted(frame_dt[min(20, max(len(frame_dt) - 10, 0)):])
    steady = warm[len(warm) // 2] if warm else float("inf")
    decode = sorted(decode_ms)[len(decode_ms) // 2] if decode_ms else 0.0
    print(f"steadyFPS={1.0 / max(steady, 1e-9):.2f} (median frame {steady * 1e3:.1f}ms) decodeMs={decode:.3f}")
    print(
        f"mappingFPS={n / max(t_map, 1e-9):.2f} trackingFPS={n / max(t_track, 1e-9):.2f} "
        f"tracked={len(est_poses)}/{n} pass1_tracked={len(p1_tracked)}/{n} "
        f"recoveries={recovered} "
        f"keyframes={slam.map.n_keyframes} points={slam.map.n_points} "
        f"maxRSS={maxrss_mb:.0f}MB"
    )
    summary = dict(
        frames=n, pass1_tracked=len(p1_tracked), pass2_tracked=len(est_poses), recoveries=recovered,
        rewinds=rewinds, keyframes=slam.map.n_keyframes, points=slam.map.n_points,
        steady_fps=1.0 / max(steady, 1e-9), mapping_fps=n / max(t_map, 1e-9), tracking_fps=n / max(t_track, 1e-9),
        decode_ms_median=decode, stage_ms=stages, device=args.device, ate=None, perct_frames_tracked=None,
    )
    if os.path.exists(gt_path):
        from ucoslam_tpu_torch.apps.compare_logs import evaluate

        out = evaluate(est_path, gt_path)
        if out:
            ate, pct, _ = out
            summary.update(ate=ate, perct_frames_tracked=pct)
            print(f"ATE={ate:.6f} perctFramesTracked={pct:.4f}")
    with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
