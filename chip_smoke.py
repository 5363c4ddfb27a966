#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):

1. environment: the card's name and power limit, TF32 off, both CUDA
   kernels built from `ucoslam_tpu_torch/csrc` with nvcc;
2. kernel B1 (projection matching) against its plain PyTorch version on the
   card at P=16384 map points x N=2048 keypoints: idx, best and second must
   be exactly equal;
3. kernel B2 (motion-only LM) against its plain version at B=2112 rows, mono
   and with depth: pose max-abs difference < 1e-4 and the same inlier mask;
4. the slice: `UcoSlam(device="cuda").readFromFile(mono_map.slm)` ->
   `setMode(LOCALIZATION)` -> one frame at a time over the 60-frame sequence
   in reverse, held against the JAX package's run of the same sweep
   (`data/torch_port/mono_reverse_jax.json`): at least as many frames
   tracked, ATE <= 1.2 x JAX + 0.002, every camera centre within 2% of the
   scene's depth extent of JAX's, and both kernels launched twice per track
   attempt.

The last lines are the kernels' JSON record, then `{"ok": true, ...}`.
It exits non-zero without a result when no CUDA device is present, and when
run outside the repository checkout.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
MAP_PATH = os.path.join(HERE, "data", "torch_port", "mono_map.slm")
REF_PATH = os.path.join(HERE, "data", "torch_port", "mono_reverse_jax.json")


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def median_ms(fn, reps: int) -> float:
    """Median device time of fn() over `reps` runs, from CUDA events."""
    import torch

    fn()  # warm-up
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
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

    args = b1_inputs("cuda")
    got = match_kernel.project_match(*args)
    want = match_kernel.project_match_plain(*args)
    torch.cuda.synchronize()
    err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
    idx, best, second = (a.cpu() for a in want)
    ties = int(((best == second) & (idx >= 0)).sum())
    masked = int((idx < 0).sum())
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          f"B1 differs from its plain version (max abs err {err})")
    ms = median_ms(lambda: match_kernel.project_match(*args), 20)
    plain_ms = median_ms(lambda: match_kernel.project_match_plain(*args), 5)
    P, N = args[0].shape[0], args[4].shape[0]
    print(f"[2 B1] P={P} N={N} exact idx/best/second: ties={ties} masked_rows={masked} "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def phase_b2():
    import torch
    from ucoslam_tpu_torch.ops.cuda import lm_kernel

    rec = dict(max_abs_err=0.0)
    for with_depth in (False, True):
        kw = b2_inputs("cuda", with_depth=with_depth)
        extra = dict(bf=50.0, has_depth=True) if with_depth else {}
        call = [kw.pop(k) for k in ("pose_init", "pts3d", "uv", "sigma2", "valid")]
        args = (*call, 500.0, 500.0, 320.0, 240.0)

        def kernel():
            return lm_kernel.motion_only_lm_fused(*args, **kw, **extra)

        def plain():
            return lm_kernel.motion_only_lm_plain(*args, **kw, **extra)

        (pose_k, mask_k), (pose_p, mask_p) = kernel(), plain()
        torch.cuda.synchronize()
        err = float((pose_k - pose_p).abs().max())
        check(err < 1e-4, f"B2 pose differs by {err} (depth={with_depth})")
        check(torch.equal(mask_k, mask_p), f"B2 inlier mask differs (depth={with_depth})")
        ms, plain_ms = median_ms(kernel, 20), median_ms(plain, 5)
        print(f"[3 B2] B={args[1].shape[0]} depth={with_depth} pose_max_abs_err={err:.3e} "
              f"inliers={int(mask_k.sum())} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if not with_depth:  # the slice runs mono: its timing is the one recorded
            rec.update(ms=ms, plain_ms=plain_ms)
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


def phase_slice():
    import numpy as np
    import torch
    from ucoslam_tpu_torch import Mode
    from ucoslam_tpu_torch.api import UcoSlam
    from ucoslam_tpu_torch.geometry.camera import CameraParams
    from ucoslam_tpu_torch.geometry.horn import ate_rmse
    from ucoslam_tpu_torch.io.synthetic import SyntheticSequence
    from ucoslam_tpu_torch.ops.cuda import lm_kernel, match_kernel

    with open(REF_PATH) as f:
        ref = json.load(f)
    c = ref["camera"]
    cam = CameraParams.create(c["fx"], c["fy"], c["cx"], c["cy"], width=c["width"], height=c["height"])
    seq = SyntheticSequence(cam=cam, **ref["sequence"])
    frames = list(reversed(range(seq.n_frames)))
    images = {i: seq.render(i) for i in frames}

    slam = UcoSlam(device="cuda")
    slam.readFromFile(MAP_PATH, cam)
    slam.setMode(Mode.LOCALIZATION)
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

    ref_poses = {int(k): np.asarray(v) for k, v in ref["reverse_poses"].items()}
    idx = sorted(poses)
    check(len(idx) >= 3, f"tracked only {len(idx)} frames")
    for p in poses.values():
        check(p.shape == (4, 4) and np.isfinite(p).all(), "non-finite pose")
    ate = ate_rmse(np.stack([camera_center(poses[i]) for i in idx]),
                   seq.gt_positions()[idx], with_scale=True)
    dev = max(np.linalg.norm(camera_center(poses[i]) - camera_center(ref_poses[i]))
              for i in idx if i in ref_poses)
    tol = 0.02 * ref["depth_extent"]
    print(f"[4 slice] frames={len(frames)} tracked={len(idx)} (jax {ref['pass2_tracked']}) "
          f"ate={ate:.6f} (jax {ref['pass2_ate']:.6f}) max_centre_dev={dev:.6f} (tol {tol:.6f}) "
          f"process_ms_median={np.median(t_process):.3f} "
          f"extract_ms_median={np.median(t_extract):.3f} track_ms_median={np.median(t_track):.3f} "
          f"attempts={attempts} launches={launches}")
    check(len(idx) >= ref["pass2_tracked"], "tracked fewer frames than the JAX package")
    check(ate <= 1.2 * ref["pass2_ate"] + 0.002, f"ATE {ate} over the limit")
    check(dev <= tol, f"camera centre {dev} from the JAX pose (tol {tol})")
    for k, n in launches.items():
        check(n > 0 and n == 2 * attempts, f"{k} launched {n} times for {attempts} track attempts")
    return launches


def main() -> int:
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
    launches = phase_slice()
    check("jax" not in sys.modules, "jax was imported")
    kernels = [
        dict(name="project_match", route="cuda", source="ucoslam_tpu_torch/csrc/match_kernel.cu",
             replaces="ucoslam_tpu/ops/pallas/match_kernel.py:105", launches=launches["B1"], **b1),
        dict(name="motion_only_lm", route="cuda", source="ucoslam_tpu_torch/csrc/lm_kernel.cu",
             replaces="ucoslam_tpu/ops/pallas/lm_kernel.py:246", launches=launches["B2"], **b2),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
