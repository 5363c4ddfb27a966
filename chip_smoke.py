#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py [--frames 60|150]

Phases (each prints one line or more; any failure raises and exits non-zero):

1. environment: the card's name and power limit, TF32 off, both CUDA
   kernels built from `ucoslam_tpu_torch/csrc` with nvcc;
2. kernel B1 (projection matching) against its plain PyTorch version on the
   card at P=16384 map points x N=2048 keypoints, with 90% of the rows live
   and at the slice's live share (SLICE_LIVE_ROWS): idx, best and second
   must be exactly equal;
3. kernel B2 (motion-only LM) against its plain version at B=2112 rows, mono
   and with depth, at both (iters, rounds) of the slice's track, (10, 4) and
   (10, 2): pose max-abs difference < 1e-4 and the same inlier mask;
4. the LOCALIZATION slice: `UcoSlam(device="cuda").readFromFile(mono_map.slm)`
   -> `setMode(LOCALIZATION)` -> one frame at a time over the 60-frame
   sequence in reverse, held against the JAX package's run of the same sweep
   (`data/torch_port/mono_reverse_jax.json`): at least as many frames
   tracked, ATE <= 1.2 x JAX + 0.002, every camera centre within 2% of the
   scene's depth extent of JAX's, both kernels launched twice per track
   attempt, and B1's live rows on the first attempt within 10% of
   SLICE_LIVE_ROWS;
5. the SLAM slice: `UcoSlam(device="cuda").setParams(None, params, cam)`
   with the parameters the JAX package mapped with -> `process` over the
   rendered sequence (60 frames; `--frames 150` takes the 150-frame
   reference) -> `saveToFile`; held to the JAX package's pass 1 (tracked >=
   JAX - 2, ATE <= 1.2 x JAX + 0.002) and a consistent map. A second pass
   gives the same signature. A fresh `UcoSlam(device="cuda")` reads the
   checkpoint, with the same signature, and localizes the sequence in
   reverse (tracked >= JAX's pass 2 - 2, ATE <= 1.2 x JAX + 0.002). B1 is
   launched twice per track attempt and once per keyframe insertion (the
   duplicate fusion), B2 twice per track attempt; B1 at the last fusion's
   inputs is exactly equal to its plain version.

The kernels' times are medians of CUDA-event timings of single launches.
Each kernel's bound is the larger of its bytes (inputs read once, outputs
written once) over 3.35 TB/s and its operations on these inputs over the
card's peak rate for them: B2's float32 operations over 67 TFLOP/s, B1's
instructions (none a fused multiply-add) over the issue rate of 132 SMs x
128 lanes x 1.98 GHz and its popcounts over 16 a cycle an SM. Host times
(`process`, `new_keyframe` and its steps) end in a device synchronize.
The last lines are the kernels' JSON record, then `{"ok": true, ...}`.
It exits non-zero without a result when no CUDA device is present, and when
run outside the repository checkout.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def reference_paths(frames: int) -> tuple[str, str]:
    """-> (checkpoint, summary) of the JAX package's run over `frames`
    frames of the `mono` scenario (tools/port/make_reference_map.py)."""
    name = "mono" if frames == 60 else f"mono{frames}"
    d = os.path.join(HERE, "data", "torch_port")
    return os.path.join(d, f"{name}_map.slm"), os.path.join(d, f"{name}_reverse_jax.json")


MAP_PATH, REF_PATH = reference_paths(60)

#: B1's live rows (visible map points) on the slice's first track attempt,
#: of the 16384-slot arena, and the slots they lie in ([0, SLICE_LIVE_SPAN));
#: counted once by the port on that frame, and checked again by phase 4
SLICE_LIVE_ROWS, SLICE_LIVE_SPAN = 3154, 3556

#: peak rates of one H100 SXM (NVIDIA's data sheet): HBM bytes/s, float32 FLOP/s
#: (a fused multiply-add counted as 2)
HBM_BYTES_PER_S, FP32_OPS_PER_S = 3.35e12, 67e12
#: instructions a second of one H100 SXM at its 1.98 GHz boost clock: any
#: (132 SMs x 128 lanes a cycle), and 32-bit popcounts (16 a cycle an SM)
ISSUE_PER_S, POPC_PER_S = 132 * 128 * 1.98e9, 132 * 16 * 1.98e9
#: B1 instructions: the gate of a live pair (2 subtracts, 2 multiplies, an add
#: and a compare for the radius, a subtract and a compare for the octave),
#: and for a pair inside the gate the distance (8 XOR, 7 adds) and the best-2
#: update (2 compares), and its 8 popcounts
B1_GATE_OPS, B1_PASS_OPS, B1_PASS_POPC = 8, 17, 8
#: B2 floating-point operations per row and iteration: projection 25,
#: residual and chi2 6, Huber weight 5, Jacobian 18, the 21 + 6 weighted
#: normal-equation sums 135, the candidate's capped cost 33; with depth the
#: stereo row adds 81
B2_ROW_OPS, B2_ROW_OPS_DEPTH = 222, 303


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def median_ms(fn, reps: int) -> float:
    """Median device time of fn() over `reps` runs, from CUDA events. A spin
    kernel (~0.5 ms) holds the stream before each run, so that the run's
    launches queue behind it and the events time the device, not the host's
    launch path (a function that launches slower than the device runs is
    still timed at its launch rate)."""
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def b1_inputs(device, P=16384, N=2048, seed=0):
    """Matching inputs with gated rows, all-masked rows and duplicate
    descriptors (ties), made with numpy from a seed."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    desc_b = rng.integers(0, 2**32, (N, 8), dtype=np.uint32)
    dup = rng.choice(N, 2 * (N // 16), replace=False)  # pairs of columns
    desc_b[dup[1::2]] = desc_b[dup[0::2]]  # equal descriptors -> equal distances
    uv_b = rng.uniform([0, 0], [640, 480], (N, 2)).astype(np.float32)
    uv_b[dup[1::2]] = uv_b[dup[0::2]] + rng.normal(0, 1.0, (len(dup) // 2, 2)).astype(np.float32)
    oct_b = rng.integers(0, 8, N).astype(np.int32)
    valid_b = rng.random(N) < 0.95
    src = rng.integers(0, N, P)
    desc_a = desc_b[src].copy()
    flips = rng.integers(0, 256, (P, 12))
    for k in range(flips.shape[1]):
        desc_a[np.arange(P), flips[:, k] // 32] ^= (np.uint32(1) << (flips[:, k] % 32).astype(np.uint32))
    uv_a = (uv_b[src] + rng.normal(0, 4.0, (P, 2))).astype(np.float32)
    oct_a = np.clip(oct_b[src] + rng.integers(-1, 2, P), 0, 7).astype(np.int32)
    valid_a = rng.random(P) < 0.9
    uv_a[rng.random(P) < 0.05] = -500.0  # outside every radius: all-masked rows
    radius2 = ((15.0 * 1.2 ** oct_b) ** 2).astype(np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (
        t(desc_a.view(np.int32)), t(uv_a), t(oct_a), t(valid_a),
        t(desc_b.view(np.int32)), t(uv_b), t(oct_b), t(valid_b), t(radius2),
    )


def b1_slice_inputs(device, seed=1):
    """b1_inputs with the slice's live rows: SLICE_LIVE_ROWS of the 16384,
    all within the first SLICE_LIVE_SPAN slots, as in the map arena."""
    import numpy as np
    import torch

    args = list(b1_inputs(device, seed=seed))
    live = np.zeros(args[0].shape[0], bool)
    live[np.random.default_rng(seed).choice(SLICE_LIVE_SPAN, SLICE_LIVE_ROWS, replace=False)] = True
    args[3] = torch.from_numpy(live).to(device)
    return tuple(args)


def b1_bound(args) -> tuple[float, str, int]:
    """-> (bound ms, what bounds it, pairs inside the gate) for B1 on args."""
    desc_a, uv_a, oct_a, valid_a, desc_b, uv_b, oct_b, valid_b, radius2 = args
    du = uv_a[:, None, 0] - uv_b[None, :, 0]
    dv = uv_a[:, None, 1] - uv_b[None, :, 1]
    gate = ((du * du + dv * dv < radius2[None, :]) & ((oct_a[:, None] - oct_b[None, :]).abs() <= 1)
            & valid_a[:, None] & valid_b[None, :])
    passing = int(gate.sum())
    del du, dv, gate
    live_pairs = int(valid_a.sum()) * int(valid_b.sum())
    t_ops = (B1_GATE_OPS * live_pairs + B1_PASS_OPS * passing) / ISSUE_PER_S + B1_PASS_POPC * passing / POPC_PER_S
    nbytes = sum(t.numel() * t.element_size() for t in args) + 3 * 4 * desc_a.shape[0]
    return bound_of(nbytes, t_ops) + (passing,)


def b2_bound(B: int, iters: int, rounds: int, n_valid: int, n_inliers: int, depth: bool):
    """-> (bound ms, what bounds it) for B2: the valid rows in the first
    round, the final inliers in the later ones."""
    nbytes = 64 + B * (12 + 8 + 4 + 1 + (4 if depth else 0)) + 64 + B
    rows = iters * (n_valid + (rounds - 1) * n_inliers)
    return bound_of(nbytes, rows * (B2_ROW_OPS_DEPTH if depth else B2_ROW_OPS) / FP32_OPS_PER_S)


def bound_of(nbytes: int, t_ops: float) -> tuple[float, str]:
    """-> (ms, basis): the larger of the bytes' time and the operations' t_ops (s)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def b2_inputs(device, B=2112, seed=0, with_depth=False):
    """A pose problem at the slice's B (2048 keypoint rows + 64 zero marker
    rows), 20% outliers, a perturbed start pose; numpy from a seed."""
    import numpy as np
    import torch
    from ucoslam_tpu_torch.geometry.se3 import se3_exp

    rng = np.random.default_rng(seed)
    n = B - 64
    X = np.zeros((B, 3), np.float32)
    X[:n] = np.c_[rng.uniform(-3, 3, (n, 2)), rng.uniform(3, 10, n)]
    T_true = se3_exp(torch.tensor([0.1, -0.05, 0.02, 0.03, -0.02, 0.01])).numpy()
    q = X @ T_true[:3, :3].T + T_true[:3, 3]
    uv = np.c_[500 * q[:, 0] / q[:, 2] + 320, 500 * q[:, 1] / q[:, 2] + 240]
    uv += rng.normal(0, 0.4, uv.shape)
    out = rng.random(B) < 0.2
    uv[out] += rng.uniform(25, 90, (int(out.sum()), 2))
    octave = rng.integers(0, 8, B)
    sigma2 = (1.2 ** (2 * octave)).astype(np.float32)
    valid = np.r_[rng.random(n) < 0.9, np.zeros(64, bool)]
    T0 = se3_exp(torch.tensor([0.08, -0.03, 0.0, 0.02, 0.0, 0.0])).numpy()
    depth = None
    if with_depth:
        depth = np.where(rng.random(B) < 0.4, 0.0, q[:, 2]).astype(np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=a.dtype)).to(device)

    return dict(
        pose_init=t(T0.astype(np.float32)), pts3d=t(X), uv=t(uv.astype(np.float32)),
        sigma2=t(sigma2), valid=t(valid), depth=None if depth is None else t(depth),
    )


def phase_environment():
    import torch

    check(torch.cuda.is_available(), "no CUDA device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    from ucoslam_tpu_torch.ops import cuda
    from ucoslam_tpu_torch.ops.cuda import lm_kernel, match_kernel
    from ucoslam_tpu_torch.slam.system import disable_tf32

    disable_tf32()
    t0 = time.perf_counter()
    cuda.build("match_kernel", "lm_kernel")  # one nvcc each, in parallel
    match_kernel._library()
    lm_kernel._library()
    build_s = time.perf_counter() - t0
    print(f"[1 env] device={name} torch={torch.__version__} cuda={torch.version.cuda} "
          f"build_s={build_s:.2f} nvcc_s={json.dumps(cuda.build_seconds)}")
    print(smi.stdout.strip().splitlines()[0])
    return name


def phase_b1():
    import torch
    from ucoslam_tpu_torch.ops.cuda import match_kernel

    rec = dict(max_abs_err=0)
    for case, args in (("90% live", b1_inputs("cuda")), ("slice share", b1_slice_inputs("cuda"))):
        got = match_kernel.project_match(*args)
        want = match_kernel.project_match_plain(*args)
        torch.cuda.synchronize()
        err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
        idx, best, second = (a.cpu() for a in want)
        ties = int(((best == second) & (idx >= 0)).sum())
        masked = int((idx < 0).sum())
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"B1 differs from its plain version at {case} (max abs err {err})")
        ms = median_ms(lambda: match_kernel.project_match(*args), 50)
        plain_ms = median_ms(lambda: match_kernel.project_match_plain(*args), 5)
        bound_ms, bound_by, passing = b1_bound(args)
        P, N, live = args[0].shape[0], args[4].shape[0], int(args[3].sum())
        print(f"[2 B1] P={P} N={N} {case}: live_rows={live} exact idx/best/second: ties={ties} "
              f"masked_rows={masked} gated_pairs={passing} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bound_ms:.6f} ({bound_by})")
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if case == "slice share":  # the main path's share: its timing is the one recorded
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        else:
            rec.update(ms_90pct_live=ms, bound_ms_90pct_live=bound_ms)
    return rec


def phase_b2():
    import torch
    from ucoslam_tpu_torch.ops.cuda import lm_kernel

    rec = dict(max_abs_err=0.0)
    for with_depth in (False, True):
        kw = b2_inputs("cuda", with_depth=with_depth)
        extra = dict(bf=50.0, has_depth=True) if with_depth else {}
        call = [kw.pop(k) for k in ("pose_init", "pts3d", "uv", "sigma2", "valid")]
        args = (*call, 500.0, 500.0, 320.0, 240.0)
        for iters, rounds in ((10, 4), (10, 2)):  # the slice's two refines

            def kernel():
                return lm_kernel.motion_only_lm_fused(*args, **kw, **extra, iters=iters, rounds=rounds)

            def plain():
                return lm_kernel.motion_only_lm_plain(*args, **kw, **extra, iters=iters, rounds=rounds)

            (pose_k, mask_k), (pose_p, mask_p) = kernel(), plain()
            torch.cuda.synchronize()
            case = f"{'depth' if with_depth else 'mono'} {iters}x{rounds}"
            err = float((pose_k - pose_p).abs().max())
            check(err < 1e-4, f"B2 pose differs by {err} ({case})")
            check(torch.equal(mask_k, mask_p), f"B2 inlier mask differs ({case})")
            ms, plain_ms = median_ms(kernel, 50), median_ms(plain, 5)
            B, n_valid, n_inl = args[1].shape[0], int(call[4].sum()), int(mask_k.sum())
            bound_ms, bound_by = b2_bound(B, iters, rounds, n_valid, n_inl, with_depth)
            print(f"[3 B2] B={B} {case}: pose_max_abs_err={err:.3e} valid={n_valid} inliers={n_inl} "
                  f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.6f} ({bound_by})")
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            rec.setdefault("ms_by_case", {})[case] = ms
            if case == "mono 10x4":  # the slice's first refine: the timing recorded
                rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    return rec


def timed(obj, method: str) -> list:
    """Wrap obj.method so that each call is timed on the host clock up to a
    device synchronize; returns the list the times (ms) are appended to."""
    import torch

    inner, times = getattr(obj, method), []

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        return out

    setattr(obj, method, wrapper)
    return times


def camera_center(pose):
    import numpy as np

    pose = np.asarray(pose, np.float64)
    return -pose[:3, :3].T @ pose[:3, 3]


def load_scene(ref_path: str):
    """-> (the JAX package's summary, camera, sequence, rendered images)."""
    from ucoslam_tpu_torch.geometry.camera import CameraParams
    from ucoslam_tpu_torch.io.synthetic import SyntheticSequence

    with open(ref_path) as f:
        ref = json.load(f)
    c = ref["camera"]
    cam = CameraParams.create(c["fx"], c["fy"], c["cx"], c["cy"], width=c["width"], height=c["height"])
    seq = SyntheticSequence(cam=cam, **ref["sequence"])
    return ref, cam, seq, [seq.render(i) for i in range(seq.n_frames)]


def ate_of(poses: dict, seq) -> float:
    import numpy as np
    from ucoslam_tpu_torch.geometry.horn import ate_rmse

    idx = sorted(poses)
    return ate_rmse(np.stack([camera_center(poses[i]) for i in idx]), seq.gt_positions()[idx], with_scale=True)


def phase_slice(scene):
    import numpy as np
    import torch
    from ucoslam_tpu_torch import Mode
    from ucoslam_tpu_torch.api import UcoSlam
    from ucoslam_tpu_torch.matching import projection
    from ucoslam_tpu_torch.ops.cuda import lm_kernel, match_kernel

    ref, cam, seq, images = scene
    frames = list(reversed(range(seq.n_frames)))

    slam = UcoSlam(device="cuda")
    slam.readFromFile(MAP_PATH, cam)
    slam.setMode(Mode.LOCALIZATION)
    # B1's live-row mask on the first attempt, counted after the sweep (no
    # launch of its own inside the timed frames)
    first_valid, inner_match = [], projection.project_match

    def first_match(*args):
        first_valid.append(args[3])
        projection.project_match = inner_match
        return inner_match(*args)

    projection.project_match = first_match
    # process() is extract, then track: time each where process() calls it
    t_extract = timed(slam._extractor, "process")
    t_track = timed(slam._system, "process_frame")
    match_kernel.launches = 0
    lm_kernel.launches = 0
    poses, t_process = {}, []
    for i in frames:
        t0 = time.perf_counter()
        pose = slam.process(images[i], fseq=i)
        torch.cuda.synchronize()
        t_process.append(1e3 * (time.perf_counter() - t0))
        if pose is not None:
            poses[i] = pose
    launches = {"B1": match_kernel.launches, "B2": lm_kernel.launches}
    attempts = slam._system.tracker.n_attempts
    projection.project_match = inner_match
    first_live = int(first_valid[0].sum())

    ref_poses = {int(k): np.asarray(v) for k, v in ref["reverse_poses"].items()}
    idx = sorted(poses)
    check(len(idx) >= 3, f"tracked only {len(idx)} frames")
    for p in poses.values():
        check(p.shape == (4, 4) and np.isfinite(p).all(), "non-finite pose")
    ate = ate_of(poses, seq)
    dev = max(np.linalg.norm(camera_center(poses[i]) - camera_center(ref_poses[i]))
              for i in idx if i in ref_poses)
    tol = 0.02 * ref["depth_extent"]
    print(f"[4 slice] frames={len(frames)} tracked={len(idx)} (jax {ref['pass2_tracked']}) "
          f"ate={ate:.6f} (jax {ref['pass2_ate']:.6f}) max_centre_dev={dev:.6f} (tol {tol:.6f}) "
          f"process_ms_median={np.median(t_process):.3f} "
          f"extract_ms_median={np.median(t_extract):.3f} track_ms_median={np.median(t_track):.3f} "
          f"attempts={attempts} launches={launches} first_b1_live_rows={first_live}")
    check(len(idx) >= ref["pass2_tracked"], "tracked fewer frames than the JAX package")
    check(ate <= 1.2 * ref["pass2_ate"] + 0.002, f"ATE {ate} over the limit")
    check(dev <= tol, f"camera centre {dev} from the JAX pose (tol {tol})")
    for k, n in launches.items():
        check(n > 0 and n == 2 * attempts, f"{k} launched {n} times for {attempts} track attempts")
    check(abs(first_live - SLICE_LIVE_ROWS) <= 0.1 * SLICE_LIVE_ROWS,
          f"B1 had {first_live} live rows on the first attempt; SLICE_LIVE_ROWS is {SLICE_LIVE_ROWS}")
    return launches


#: the timed steps of MapManager.new_keyframe, by the method that runs each
KEYFRAME_STEPS = {"epipolar": "_create_epipolar_points", "fuse": "_fuse_duplicates",
                  "cull_points": "_cull_recent_points", "cull_keyframes": "_cull_keyframes"}


def slam_pass(params, cam, images) -> dict:
    """One forward SLAM pass of `UcoSlam(device="cuda")` over the images:
    each `process` timed and classed by what the frame did (init, track, or
    a keyframe insertion), `new_keyframe` and its steps timed, the kernels'
    launches counted, and the B1 inputs of the last duplicate fusion kept."""
    import torch
    from ucoslam_tpu_torch.api import UcoSlam
    from ucoslam_tpu_torch.matching import projection
    from ucoslam_tpu_torch.ops.cuda import lm_kernel, match_kernel
    from ucoslam_tpu_torch.optim import ba

    slam = UcoSlam(device="cuda")
    slam.setParams(None, params, cam)
    mgr = slam._system.manager
    steps = {"new_keyframe": timed(mgr, "new_keyframe")}
    steps.update({k: timed(mgr, m) for k, m in KEYFRAME_STEPS.items()})
    inner_ba, inner_match = ba.local_bundle_adjustment, projection.project_match
    steps["local_ba"] = timed(ba, "local_bundle_adjustment")
    timed_fuse, in_fuse, fuse_args = mgr._fuse_duplicates, [], []

    def fuse(*args):
        in_fuse.append(True)
        out = timed_fuse(*args)
        in_fuse.clear()
        return out

    def match(*args):
        if in_fuse:
            fuse_args[:] = [a.clone() for a in args]
        return inner_match(*args)

    mgr._fuse_duplicates, projection.project_match = fuse, match
    poses, t_frame = {}, {"init": [], "track": [], "keyframe": []}
    match_kernel.launches = 0
    lm_kernel.launches = 0
    for i, img in enumerate(images):
        mapped, inserted = slam.map.n_keyframes > 0, mgr.n_insertions
        t0 = time.perf_counter()
        pose = slam.process(img, fseq=i)
        torch.cuda.synchronize()
        kind = "keyframe" if mgr.n_insertions > inserted else "track" if mapped else "init"
        t_frame[kind].append(1e3 * (time.perf_counter() - t0))
        if pose is not None:
            poses[i] = pose
    launches = {"B1": match_kernel.launches, "B2": lm_kernel.launches}
    ba.local_bundle_adjustment, projection.project_match = inner_ba, inner_match
    return dict(slam=slam, poses=poses, t_frame=t_frame, steps=steps, launches=launches,
                attempts=slam._system.tracker.n_attempts, insertions=mgr.n_insertions,
                fuse_args=tuple(fuse_args))


def check_slam_launches(run: dict, what: str) -> None:
    n1, n2, a, k = run["launches"]["B1"], run["launches"]["B2"], run["attempts"], run["insertions"]
    check(a > 0 and k > 0, f"{what}: {a} track attempts and {k} keyframe insertions")
    check(n1 == 2 * a + k, f"{what}: B1 launched {n1} times for {a} track attempts and {k} insertions")
    check(n2 == 2 * a, f"{what}: B2 launched {n2} times for {a} track attempts")


def phase_slam(scene, map_path: str) -> dict:
    """Phase 5 -> the kernels' launches on its main path, and B1's record at
    the last fusion's inputs."""
    import numpy as np
    import torch
    from ucoslam_tpu_torch import Mode
    from ucoslam_tpu_torch.api import UcoSlam
    from ucoslam_tpu_torch.config import Params
    from ucoslam_tpu_torch.io.serialize import load_map_meta
    from ucoslam_tpu_torch.ops.cuda import lm_kernel, match_kernel

    ref, cam, seq, images = scene
    jax_meta = load_map_meta(map_path)
    params = Params.from_dict(jax_meta["params"])  # what the JAX package mapped with
    jax_insertions = jax_meta["extra"]["kf_counter"] - 2  # after its two-view init

    run = slam_pass(params, cam, images)
    slam, poses, t_frame, steps = run["slam"], run["poses"], run["t_frame"], run["steps"]
    check(len(poses) >= 3, f"pass 1 tracked only {len(poses)} frames")
    for p in poses.values():
        check(p.shape == (4, 4) and np.isfinite(p).all(), "non-finite pose in pass 1")
    ate = ate_of(poses, seq)
    slam.map.check_consistency()
    loops = slam._system.manager.loop_detector
    print(f"[5 slam] pass 1: frames={len(images)} tracked={len(poses)} (jax {ref['pass1_tracked']}) "
          f"ate={ate:.6f} (jax {ref['pass1_ate']:.6f}) keyframes={slam.map.n_keyframes} "
          f"(jax {ref['n_keyframes']}) points={slam.map.n_points} (jax {ref['n_points']}) "
          f"insertions={run['insertions']} (jax {jax_insertions}) loop_queries={loops.n_queries} "
          f"loop_candidates={loops.n_candidates} attempts={run['attempts']} launches={run['launches']}")
    check(len(poses) >= ref["pass1_tracked"] - 2, "pass 1 tracked over 2 frames fewer than the JAX package")
    check(ate <= 1.2 * ref["pass1_ate"] + 0.002, f"pass 1 ATE {ate} over the limit")
    check_slam_launches(run, "pass 1")
    # determinism: a second pass in the same process
    again = slam_pass(params, cam, images)
    check_slam_launches(again, "pass 1 again")
    sig, sig_again = slam.getSignatureStr(), again["slam"].getSignatureStr()
    print(f"[5 slam] determinism: signature={sig} again={sig_again} tracked_again={len(again['poses'])}")
    check(sig == sig_again, "a second pass 1 gave another signature")
    launches = {k: n + again["launches"][k] for k, n in run["launches"].items()}
    fuse_launches = run["insertions"] + again["insertions"]
    del again

    # B1 at the last duplicate fusion's inputs: the full arena at a 3 px radius
    args = run["fuse_args"]
    got, want = match_kernel.project_match(*args), match_kernel.project_match_plain(*args)
    torch.cuda.synchronize()
    err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          f"B1 differs from its plain version at the fusion's inputs (max abs err {err})")
    fuse_ms = median_ms(lambda: match_kernel.project_match(*args), 50)
    fuse_plain_ms = median_ms(lambda: match_kernel.project_match_plain(*args), 5)
    fuse_bound_ms, fuse_bound_by, passing = b1_bound(args)

    # save, reload in a fresh instance, localize the sequence in reverse
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "slam.slm")
        slam.saveToFile(path)
        loc = UcoSlam(device="cuda")
        loc.readFromFile(path, cam)
    check(loc.getSignatureStr() == slam.getSignatureStr(), "the reloaded checkpoint has another signature")
    loc.setMode(Mode.LOCALIZATION)
    match_kernel.launches = 0
    lm_kernel.launches = 0
    rev, t_rev = {}, []
    for i in reversed(range(len(images))):
        t0 = time.perf_counter()
        pose = loc.process(images[i], fseq=i)
        torch.cuda.synchronize()
        t_rev.append(1e3 * (time.perf_counter() - t0))
        if pose is not None:
            rev[i] = pose
    rev_launches = {"B1": match_kernel.launches, "B2": lm_kernel.launches}
    rev_attempts = loc._system.tracker.n_attempts
    check(len(rev) >= 3, f"the reverse sweep tracked only {len(rev)} frames")
    rev_ate = ate_of(rev, seq)
    print(f"[5 slam] reload + reverse sweep: tracked={len(rev)} (jax {ref['pass2_tracked']}) ate={rev_ate:.6f} "
          f"(jax {ref['pass2_ate']:.6f}) process_ms_median={np.median(t_rev):.3f} attempts={rev_attempts} "
          f"launches={rev_launches}")
    check(len(rev) >= ref["pass2_tracked"] - 2, "the reverse sweep tracked over 2 frames fewer than JAX's")
    check(rev_ate <= 1.2 * ref["pass2_ate"] + 0.002, f"reverse-sweep ATE {rev_ate} over the limit")
    for k, n in rev_launches.items():
        check(n > 0 and n == 2 * rev_attempts, f"{k} launched {n} times for {rev_attempts} track attempts")
        launches[k] += n

    def med(ts):
        return f"{np.median(ts):.3f}" if ts else "none"

    culling = [a + b for a, b in zip(steps["cull_points"], steps["cull_keyframes"])]
    print(f"[5 times] process_ms_median: track={med(t_frame['track'])} (n={len(t_frame['track'])}) "
          f"keyframe={med(t_frame['keyframe'])} (n={len(t_frame['keyframe'])}) "
          f"init={med(t_frame['init'])} (n={len(t_frame['init'])}); "
          f"new_keyframe_ms_median={med(steps['new_keyframe'])}: epipolar={med(steps['epipolar'])} "
          f"fuse={med(steps['fuse'])} local_ba={med(steps['local_ba'])} (n={len(steps['local_ba'])}) "
          f"culling={med(culling)}; b1_fuse: live_rows={int(args[3].sum())} of {args[0].shape[0]} "
          f"keypoints={int(args[7].sum())} gated_pairs={passing} exact kernel_ms={fuse_ms:.4f} "
          f"plain_ms={fuse_plain_ms:.4f} bound_ms={fuse_bound_ms:.6f} ({fuse_bound_by})")
    return dict(launches=launches, b1_fuse=dict(
        launches_fuse=fuse_launches, ms_fuse=fuse_ms,
        plain_ms_fuse=fuse_plain_ms, bound_ms_fuse=fuse_bound_ms, bound_by_fuse=fuse_bound_by))


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke test of the PyTorch/CUDA port on one GPU.")
    ap.add_argument("--frames", type=int, default=60, choices=(60, 150),
                    help="frames of the mono scenario that phase 5 maps (the JAX reference's length)")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import ucoslam_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}", file=sys.stderr)
        return 2
    if os.path.dirname(os.path.dirname(os.path.abspath(ucoslam_tpu_torch.__file__))) != HERE:
        print("chip_smoke: ucoslam_tpu_torch was imported from outside the checkout", file=sys.stderr)
        return 2

    name = phase_environment()
    b1 = phase_b1()
    b2 = phase_b2()
    scene = load_scene(REF_PATH)
    launches = phase_slice(scene)
    slam_map, slam_ref = reference_paths(args.frames)
    slam = phase_slam(scene if args.frames == 60 else load_scene(slam_ref), slam_map)
    launches = {k: n + slam["launches"][k] for k, n in launches.items()}
    b1.update(slam["b1_fuse"])
    check("jax" not in sys.modules, "jax was imported")
    check("ucoslam_tpu" not in sys.modules, "the JAX package ucoslam_tpu was imported")
    kernels = [
        dict(name="project_match", route="cuda", source="ucoslam_tpu_torch/csrc/match_kernel.cu",
             replaces="ucoslam_tpu/ops/pallas/match_kernel.py:105", launches=launches["B1"],
             library_ms=None, **b1),
        dict(name="motion_only_lm", route="cuda", source="ucoslam_tpu_torch/csrc/lm_kernel.cu",
             replaces="ucoslam_tpu/ops/pallas/lm_kernel.py:246", launches=launches["B2"],
             library_ms=None, **b2),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
