#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py [--frames 60|150]

Phases (each prints one line or more; any failure raises and exits non-zero):

1. environment: the card's name and power limit, TF32 off, the CUDA
   kernels built from `ucoslam_tpu_torch/csrc` with nvcc (all at once);
2. kernel B1 (projection matching) against its plain PyTorch version on the
   card at P=16384 map points x N=2048 keypoints, with 90% of the rows live
   and at the slice's live share (SLICE_LIVE_ROWS): idx, best and second
   must be exactly equal;
3. kernel B2 (motion-only LM) against its plain version at B=2112 rows, mono
   and with depth, at both (iters, rounds) of the slice's track, (10, 4) and
   (10, 2): pose max-abs difference < 1e-4 and the same inlier mask; then
   the batched launch (candidate verification's refines, (10, 2)) at C=5
   problems of B=2048, each its own pose and mask (pose < 1e-4 and the same
   masks as the plain version, each problem bit-equal to its own single
   launch, and C=1 bit-equal to the single launch), and at B=16384 (the
   brute-force relocalization's arena);
   Then kernels F1 and F2 (the detect stage over every pyramid level) on
   frame 0 of the phase-4 scene at the library's widths (640x480, 8
   levels, 2048 keypoints) against their plain versions on the card (the
   candidates and every keypoint slot bit-equal), and each launch's time
   beside the plain per-level chain's. From phase 4 on, every phase whose
   frames run the port's ORB-family detector checks F1 and F2 on its own
   main path: one launch each a `detect_and_compute` (two a stereo frame);
   the kernels' record gives phase 4's launches a frame and every phase's
   launches;
4. the LOCALIZATION slice: `UcoSlam(device="cuda").readFromFile(mono_map.slm)`
   -> `setMode(LOCALIZATION)` -> one frame at a time over the 60-frame
   sequence in reverse, held against the JAX package's run of the same sweep
   (`data/torch_port/mono_reverse_jax.json`): at least as many frames
   tracked, ATE <= 1.2 x JAX + 0.002, every camera centre within 2% of the
   scene's depth extent of JAX's, B1 and B2 launched twice per track
   attempt, F1 and F2 once a frame, and B1's live rows on the first attempt within 10% of
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
   inputs is exactly equal to its plain version;
6. recovery, each held to the JAX package's run of the same protocol
   (`data/torch_port/mono_{reloc,reloc_bf,gap,reseed}_jax.json`): (a) the
   JAX map localized in reverse with `resetTracker()` before each of the
   reference's reset frames, so they relocalize through the keyframe database
   (relocalized and tracked >= JAX's, ATE <= 1.2 x JAX + 0.002, centres
   within 2% of the depth extent; one batched B2 launch per relocalization
   with a candidate); (b) the same by brute force (a dummy database; B2 at
   B=16384); (c) SLAM with frames 30-33 replaced by `resetTracker()`, twice
   (tracked after the gap >= JAX - 2, one signature); (d) SLAM over the
   splice of two scenes, which re-seeds a new segment (re-seeded, tracked
   after it >= JAX - 2, a consistent map). `process` medians of
   relocalized and tracked frames are printed apart;
7. loop closure: the drifted ring map of tests/test_loopclosure.py
   (`ring_loop_scene`, at the library's default capacities) through
   `detect_from_keypoints` -> `correct_map` -> `global_bundle_adjustment`
   on the card and on the CPU: the loop found against keyframe 0, its pose
   within 0.05 of the truth, the drift reduced, >= 30 seam duplicates fused
   as on the CPU, card and CPU keyframe poses within 1e-3 after the
   correction, the global BA settling (the reference test's gate), one
   batched B2 launch and one B1 launch per seam fusion; then
   `globalOptimization` on phase 5's map on the card and on the CPU (chi2
   falls, within 1% of the CPU's, poses within 1e-3). Phases 6 and 7 run
   in the 60-frame run only;
8. markers, on the `markers` parity scene (ten 0.6 m ARUCO_MIP_36h12
   markers among the quads, rendered; the native detector built with g++),
   each held to the JAX package's run of the same protocol
   (`data/torch_port/markers_{map.slm,jax.json}`): (a) SLAM from nothing
   with the parameters the JAX package mapped with (tracked >= JAX - 2,
   metric ATE without scale alignment <= 1.2 x JAX + 0.002, markers with a
   map pose >= JAX - 1; the init kind, the Horn scale, the markers'
   position error, the detector's, IPPE's and local BA's times printed), a
   second pass with the same signature, save, reload with the same
   signature, the reverse sweep (tracked >= JAX's - 2, metric ATE <= 1.2 x
   JAX + 0.002); (b) the JAX package's marker map localized in reverse
   (tracked >= JAX's, metric ATE <= 1.2 x JAX + 0.002, centres within 2% of
   the depth extent of JAX's); (c) the same with `resetTracker()` at frame
   20 and the keypoints of frames 20-24 removed (the frames the markers
   pose >= JAX's, centres within (b)'s tolerance); (d) the drifted ring map
   of phase 7 with a marker of known pose (`ring_marker`) seen by keyframe 0
   and the returning keyframe: `detect_from_markers` finds the loop against
   keyframe 0, `correct_map` lowers the drift, card and CPU poses within
   1e-3; (e) kernel B2 against its plain version on the tracker's inputs of
   a phase-8 frame with >= 4 live markers in its corner rows (pose < 1e-4,
   the same mask), timed. B1 = 2 x track attempts + duplicate fusions and
   B2 = 2 x track attempts + batched verifications + marker pose refines in
   every run. With `--frames 150` only (a)'s first pass runs, against the
   150-frame reference; it runs even when phase 5 failed (the run then
   fails after phase 9);
9. stereo and RGB-D, on the `stereo` and `rgbd` parity scenes (the `mono`
   scene seen with a 0.25 m baseline; `processStereo` on the rendered pair,
   `processRGBD` on the render and its z-buffer in the TUM convention,
   `depth_input`), each held to the JAX package's run of the same protocol
   (`data/torch_port/{stereo,rgbd}_{map.slm,jax.json}`): (a) SLAM from
   nothing (a depth init at JAX's frame, tracked >= JAX - 2, metric ATE
   without scale alignment <= 1.2 x JAX + 0.002, keyframes and points
   printed beside JAX's), a second pass with the same signature, save,
   reload with the same signature, the reverse sweep (tracked >= JAX's - 2,
   metric ATE <= 1.2 x JAX + 0.002); (b) the JAX package's map localized in
   reverse (tracked >= JAX's, metric ATE as above, centres within 2% of the
   depth extent of JAX's); (c) the frontend on frame FRONTEND_FRAME, the
   card against the CPU on the same base frame and right keypoints (the
   keypoints with depth the same but for at most 1%, depth within 1e-4
   relative; the share with depth beside JAX's, the frontend's device
   launches); (d) kernel B2 against its plain version on a tracked frame's
   own inputs with live depth rows (pose < 1e-4, the same mask), timed.
   The launch rules of phase 8 hold in every run. With `--frames 150` only
   (a)'s first pass runs, against the 150-frame references. Phase 9 runs
   even when phase 5 or 8 failed, and each kind even when the other
   failed (the run then fails after them);
10. the `.fbow` vocabulary (`data/vocab.fbow`, 16384 words): its digest
   equal to the JAX package's reader's (`data/torch_port/vocab_jax.npz`);
   `quantize_words` (4096-word chunks) of the JAX frontend's frame-30
   descriptors equal on the card, on the CPU and to JAX's word ids, and of
   the port's own frame-30 descriptors equal on card and CPU, timed, its
   launches counted; the JAX package's mono map built with the vocabulary
   (`mono_voc_map.slm`) swept as phase 6 (a) (relocalized and tracked >=
   JAX's, ATE <= 1.2 x JAX + 0.002, centres within 2% of the depth extent);
   `saveToFile` / `readFromFile` keep the vocabulary and the signature;
11. global BA at scale on bench.py's synthetic problem (`ba_scale_problem`):
   (a) 128 keyframes x 16384 points x 131072 observations through
   `ba_solve(solver="auto")`: the point-major route, the cost never rising;
   against the JAX package's solve (`ba128_jax.json`), the final cost no
   more than 1% of the reference's cost reduction above it, nor that far
   below the lowest of its routes, and the solution within twice the widest
   gap between the reference's own routes in `ba_gap`'s measures (each
   observation's reprojection, the points after a similarity alignment,
   the rotations: with one camera fixed and little baseline per point, the
   scale is free and the routes end 8% apart in it); the same solve cut to
   half its LM steps must fail these gates (the control); ms per LM
   iteration as bench.py takes it ((t(24) - t(6)) / 18, one stage); (c)
   `solver="cg"` against the dense solve of the same problem (the cost
   within 1% of the dense solve's reduction, the same ba_gap limits), both
   timed; (b) 512 x 65536 x 524288: the point-major route, the cost falls,
   ms per LM iteration, peak card memory, and the same of the CG and the
   dense route; (d) the drifted ring map of
   `ring_loop_scene(n_kf=128)`, saved, read back by `UcoSlam` and
   `globalOptimization`: the point-major route, chi2 falls and ends no
   higher than the reference's worst route, the card's chi2 within 1% of
   the CPU's, and its poses and rotations within twice the gaps that two
   last-bit nudges of the start give on the CPU (the map is a chain of
   keyframes sharing points with their neighbours only: such a nudge
   moves its poses by ~0.03 and its chi2 by up to 10%);
12. the async mapper on the 60-frame mono scene, against the JAX package's
   runs of it (`mono_async_jax.json`): a sequential pass; a
   `runSequential=False` pass drained by `waitForFinished()` after every
   frame (the worker maps every keyframe the tracker asks for, so the map
   does not depend on the host's pace), held to JAX's drained pass
   (tracked >= JAX's - 2, ATE <= 1.2 x JAX's + 0.002, keyframes within one
   of JAX's, points within 10%); three free `runSequential=False` passes
   (tracked >= 0.85 x 58 and no more frames lost after the init than a JAX
   async run lost, ATE < 1.5 x JAX's sequential pass's + 0.01; after
   `waitForFinished` not busy, >= 3 keyframes, > 100 points, and, against
   JAX's free async passes, keyframes within one of theirs and points per
   keyframe within 20%: a frame that needs a keyframe waits for an idle
   worker, so the port's worker keeps pace as JAX's does on the CPU); a
   planted worker error raised by `waitForFinished`;
   `globalOptimization` drains the worker first; the launch rules of phase
   5 in each pass, `process` ms p50 / p99 of
   tracking frames in both modes. Phases 10-12 run in the 60-frame run
   only, each even when an earlier one failed;
13. the command-line harness from PNG trees on disk: the `mono`, `rgbd`
   (TUM, 16-bit depth) and `stereo` (EuRoC, both cameras) parity scenes,
   60 frames (`--frames 150`: 150), written by the port's writer
   (`write_tree`, renders made by 6 processes) into a temp dir; the first
   frame decoded (`io.png`) equal to the render quantised as the writer
   quantises; `apps.test_sequence.main` in-process on each tree with
   run_parity.py's camera file and switches, held to the JAX package's
   harness on the same trees (`data/torch_port/harness_jax.json`,
   tools/port/harness_reference.py): both passes tracked >= JAX's - 2, the
   pass-2 ATE <= 1.2 x JAX's + 0.002 and, for rgbd and stereo, the metric
   ATE too; B1 and B2 launched on the card on every tree, and held to
   their plain versions at the harness's shapes (8192 map points, 1024
   keypoints, 1088 B2 rows) on inputs captured in each tree's run: the
   tracker's HARNESS_CAPTURE_CALL-th B1 and B2 call and the last duplicate
   fusion's B1 (B1 exact; B2 pose < 1e-4 and the same mask), with ms,
   plain_ms and bound_ms; on the mono map,
   `run_slam --mode localization --in-map` tracked >= the harness's pass 2
   - 2, `test_reloc`'s success rate >= JAX's, and `map_export --ply --pcd
   --markermap --pmvs` writes its files; the frontend options
   (kptImageScaleFactor 0.5 with autoAdjustKpSensitivity) on the card and
   the CPU over the same seven images, two of them nearly flat: the same
   keypoints but for 1% and the same FAST thresholds. It prints the median
   PNG decode ms a frame, steadyFPS, mappingFPS, trackingFPS and the stage
   timers of each tree (none gated). It runs in every run, even when an
   earlier phase failed;
14. the descriptor families and the vocabulary trainer (60-frame run only):
   (a) for FREAK and SURF, frame FRONTEND_FRAME through a FrameExtractor on
   the card and on the CPU: the same keypoints but for 1%, descriptor bits
   of the shared keypoints differing in at most DESC_BIT_SHARE_TOL; the
   extract ms of ORB, FREAK and SURF (none gated); (b) for each family,
   `UcoSlam(device="cuda")` with `Params().setParams(True, FREAK or SURF)`
   (markers off) over the 60-frame `mono` scene -> `saveToFile` -> a fresh
   `UcoSlam` -> `readFromFile` -> `setMode(LOCALIZATION)` -> the reverse
   sweep, held to the JAX package's run (`data/torch_port/{freak,surf}_jax.json`):
   pass 1 tracked >= JAX's - 2, ATE <= 1.2 x JAX's + 0.002, keyframes
   within 1 of JAX's, the sweep tracked >= JAX's pass 2 - 2, phase 5's
   launch rules; B1 (exact) and B2 (pose < 1e-4, the same mask) held to
   their plain versions on inputs captured in pass 1 (the tracker's
   HARNESS_CAPTURE_CALL-th call to each, and the last fusion's B1); the
   `process` ms of tracking and keyframe frames; (c) `vocab_trainer.main`
   on the card at VOCAB_WORDS words over VOCAB_FRAMES frames (harvest
   seconds, descriptors, seconds an iteration); card and CPU train the same
   centroids and idf on a subset (VOCAB_SUBSET: words, frames, iterations);
   the card-trained vocabulary passes tests/test_fbow.py's revisit gate
   (top-1 >= the random default's and >= 0.8), `data/vocab.fbow`'s top-1
   printed beside it;
15. every marker dictionary and bundle adjustment across ranks (60-frame run
   only): (a) for each of the 22 committed dictionary tables, two views of
   DICT_VIEW markers rendered at 640x480 by the port's renderer with the
   texture replaced (`tools/port/marker_render.py`) through
   `ArucoDetector(name, device="cuda").detect`: exactly the rendered ids,
   corners within DICT_CORNER_BOUND px of the projected ones (the bound
   tests/test_torch_dictionaries.py holds); then one SLAM pass with
   `aruco_Dictionary` TAG36h11 over the `markers` scene (ten 0.6 m markers)
   cut to DICT_SLAM_FRAMES frames, held as phase 8 (a) to the JAX package's
   pass over the same pixels with its cv2 backend
   (`data/torch_port/markers_tag36h11_jax.json`): tracked >= JAX's - 2,
   metric ATE <= 1.2 x JAX's + 0.002, markers with a map pose >= JAX's - 1,
   phase 5's launch rules; B1 (the last fusion, exact) and B2 (the first
   call with 2 live markers: pose < 1e-4, the same mask) held to their plain versions on inputs
   captured in the pass; (b) the sharded solvers in worlds of ranks started
   by `parallel.distributed.spawn`: bench.py's problem (ba_scale_problem,
   128 x 16384 x 131072) point-major at world 1 on NCCL against the
   single-device solve in this process (cost histories within 1e-5
   relative, poses within 1e-4) and at world 2 on gloo with both ranks on
   cuda:0 (cost within 1e-4 relative, the CPU tests' tolerance; the
   solution, whose scale this problem leaves free, in phase 11's gauge-free
   ba_gap measures), their collectives (one a relinearization, two an LM step,
   none in PCG) and ms an LM step beside the single device's; the pass's
   marker map through `sharded_ba_solve` at world 2 against `ba_solve`
   (the same tolerance); a 128-keyframe ring's pose graph through
   `sharded_pose_graph_solve` at world 2 against `pose_graph_solve` (poses
   within 1e-4). A rank that fails fails the phase.

The kernels' times are medians of CUDA-event timings of single launches
(B2's batched record: of one batched launch, beside C single launches).
Each kernel's bound is the larger of its bytes (inputs read once, outputs
written once) over 3.35 TB/s and its operations on these inputs over the
card's peak rate for them: B2's float32 operations over 67 TFLOP/s, B1's
instructions (none a fused multiply-add) over the issue rate of 132 SMs x
128 lanes x 1.98 GHz and its popcounts over 16 a cycle an SM, F1's
instructions a level pixel (DETECT_OPS_PER_PIXEL) over the same issue rate. Host times
(`process`, `new_keyframe` and its steps) end in a device synchronize.
The last lines are the kernels' JSON record, then `{"ok": true, ...}`.
It exits non-zero without a result when no CUDA device is present, and when
run outside the repository checkout.
"""

from __future__ import annotations

import contextlib
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
#: F1 instructions a level pixel: FAST's 32 subtractions and 2 x 80 min / max
#: over the arcs, its threshold; the suppression's 7 maxima and 3 compares;
#: the cell's 4 rounds of a compare and a select
DETECT_OPS_PER_PIXEL = 32 + 160 + 3 + 10 + 8


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


def b2_marker_inputs(device, n_markers: int, seed=0):
    """b2_inputs with the corner rows of n_markers live markers (4 rows
    each, at most 16) in its 64 marker rows: 0.5 m markers 3-9 m ahead,
    their corners seen through the true pose with 0.3 px noise, weighted as
    the tracker weighs them (sigma2_mk: the markers carry 0.3 of the edge
    mass against the valid keypoint rows)."""
    import numpy as np
    import torch
    from ucoslam_tpu_torch.geometry.se3 import se3_exp
    from ucoslam_tpu_torch.markers.ippe import marker_object_points

    kw = b2_inputs("cpu", seed=seed)
    rng = np.random.default_rng(seed + 1000)
    B = kw["pts3d"].shape[0]
    T_true = se3_exp(torch.tensor([0.1, -0.05, 0.02, 0.03, -0.02, 0.01])).numpy()
    X, uv, valid, sigma2 = (kw[k].numpy().copy() for k in ("pts3d", "uv", "valid", "sigma2"))
    obj = marker_object_points(0.5).numpy()
    for m in range(n_markers):
        xi = np.r_[rng.uniform(-2, 2), rng.uniform(-1.5, 1.5), rng.uniform(3, 9), rng.uniform(-0.5, 0.5, 3)]
        g2m = se3_exp(torch.tensor(xi, dtype=torch.float32)).numpy() @ np.diag([1.0, -1.0, -1.0, 1.0])
        rows = slice(B - 64 + 4 * m, B - 60 + 4 * m)
        X[rows] = obj @ g2m[:3, :3].T + g2m[:3, 3]
        q = X[rows] @ T_true[:3, :3].T + T_true[:3, 3]
        uv[rows] = np.c_[500 * q[:, 0] / q[:, 2] + 320, 500 * q[:, 1] / q[:, 2] + 240] + rng.normal(0, 0.3, (4, 2))
        valid[rows] = True
    n_kp = int(valid[: B - 64].sum())
    kp_w = float((1.0 / sigma2[: B - 64])[valid[: B - 64]].sum())
    sigma2[B - 64:] = 1.0 / max((0.3 * (n_kp + n_markers) / 0.7) / max(kp_w, 1e-6), 1e-9)
    kw.update(pts3d=X, uv=uv.astype(np.float32), valid=valid, sigma2=sigma2.astype(np.float32))
    return {k: v if v is None else torch.as_tensor(np.ascontiguousarray(v)).to(device) for k, v in kw.items()}


def ring_loop_scene(n_kf=10, n_pt_per=60):
    """The drifted ring map of the loop-closure tests, as numpy arrays: a
    ring of n_kf outward-looking keyframes, each observing its own n_pt_per
    points and its predecessor's, poses carrying accumulated odometry drift
    (points stored where their owner's drifted pose puts them, pixels from
    the true geometry); then the returning camera, truly at keyframe 0's
    pose, believing the drifted estimate, with its own duplicate copies of
    keyframe 0's points. The same draws, in the same order, as the
    reference's tests/test_loopclosure.py. Frame rows are unpadded."""
    import numpy as np
    import torch
    from ucoslam_tpu_torch.geometry.se3 import se3_exp
    from ucoslam_tpu_torch.io.synthetic import _lookat

    def project(q):
        return np.stack([500.0 * q[:, 0] / q[:, 2] + 320.0, 500.0 * q[:, 1] / q[:, 2] + 240.0], -1)

    rng = np.random.default_rng(3)
    true_poses = []
    for k in range(n_kf):
        ang = 2 * np.pi * k / n_kf
        eye = np.asarray([1.5 * np.sin(ang), 0.0, 1.5 * np.cos(ang)])
        R, t = _lookat(eye, eye + np.asarray([4 * np.sin(ang), 0, 4 * np.cos(ang)]))
        true_poses.append(np.vstack([np.hstack([R, t[:, None]]), [0, 0, 0, 1]]).astype(np.float32))
    all_pts, all_desc, owner = [], [], []
    for k in range(n_kf):
        Tinv = np.linalg.inv(true_poses[k])
        local = np.stack([rng.uniform(-1.5, 1.5, n_pt_per), rng.uniform(-1, 1, n_pt_per),
                          rng.uniform(3, 6, n_pt_per)], -1)
        all_pts.append((local @ Tinv[:3, :3].T + Tinv[:3, 3]).astype(np.float32))
        all_desc.append(rng.integers(0, 2**32, (n_pt_per, 8), dtype=np.uint32))
        owner.append(np.full(n_pt_per, k))
    drift_poses = [true_poses[0]]
    for k in range(1, n_kf):
        rel = true_poses[k] @ np.linalg.inv(true_poses[k - 1])
        noise = se3_exp(torch.from_numpy(rng.normal(0, 0.015, 6).astype(np.float32))).numpy()
        drift_poses.append(noise @ rel @ drift_poses[-1])
    pts_true = np.concatenate(all_pts)
    owner = np.concatenate(owner)
    pts = pts_true.copy()
    for k in range(n_kf):
        sel = owner == k
        corr = np.linalg.inv(drift_poses[k]) @ true_poses[k]
        pts[sel] = pts_true[sel] @ corr[:3, :3].T + corr[:3, 3]
    descs = np.concatenate(all_desc)
    centers = np.stack([-T[:3, :3].T @ T[:3, 3] for T in true_poses])[owner]
    dist = np.linalg.norm(pts_true - centers, axis=1)
    kfs = []
    for k in range(n_kf):
        obs = np.concatenate([k * n_pt_per + np.arange(n_pt_per)]
                             + ([(k - 1) * n_pt_per + np.arange(n_pt_per)] if k > 0 else []))
        T = true_poses[k]
        uv = project(pts_true[obs] @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
        kfs.append(dict(obs=obs, uv=(uv + rng.normal(0, 0.3, uv.shape)).astype(np.float32), fseq=12 * k,
                        pose=drift_poses[k].astype(np.float32)))
    # the returning camera and its duplicates of keyframe 0's points
    A = drift_poses[-1] @ np.linalg.inv(true_poses[-1])
    cur_drifted = (A @ true_poses[0]).astype(np.float32)
    p0 = pts[:n_pt_per]
    corr = np.linalg.inv(cur_drifted) @ true_poses[0]
    dup = (p0 @ corr[:3, :3].T + corr[:3, 3]).astype(np.float32)
    c0 = -true_poses[0][:3, :3].T @ true_poses[0][:3, 3]
    T0 = true_poses[0]
    return dict(
        true_poses=np.stack(true_poses), drift_poses=np.stack(drift_poses).astype(np.float32),
        pts=pts, normals=pts / np.linalg.norm(pts, axis=1)[:, None], descs=descs,
        min_dist=dist / 1.2**7, max_dist=dist * 1.15, kfs=kfs,
        loop=dict(uv=project(p0 @ T0[:3, :3].T + T0[:3, 3]).astype(np.float32), desc=descs[:n_pt_per],
                  pose=cur_drifted, fseq=200, dup=dup, dup_normals=dup / np.linalg.norm(dup, axis=1)[:, None],
                  dup_min_dist=np.linalg.norm(p0 - c0, axis=1) / 1.2**7,
                  dup_max_dist=np.linalg.norm(p0 - c0, axis=1) * 1.15),
    )


def ring_loop_map(scene, params, device):
    """The port's Map, keyframe database and loop detector holding
    ring_loop_scene, with the returning keyframe inserted (its keypoints
    claimed by the duplicates). -> (map, detector, loop keyframe slot, frame)."""
    import numpy as np
    import torch
    from ucoslam_tpu_torch.geometry.camera import CameraParams
    from ucoslam_tpu_torch.mapping.frame import empty_frame
    from ucoslam_tpu_torch.mapping.kfdatabase import KeyFrameDataBase
    from ucoslam_tpu_torch.mapping.map import Map
    from ucoslam_tpu_torch.slam.loopclosure import LoopDetector

    cam = CameraParams.create(500.0, 500.0, 320.0, 240.0)
    m = Map(params, device=device)
    n = m.state.N
    slots = m.add_points(scene["pts"], scene["normals"], scene["descs"], scene["min_dist"], scene["max_dist"],
                         np.zeros(len(scene["pts"]), np.int32), 0)

    def frame(uv, desc, ids, pose, fseq):
        k = len(uv)
        pad = lambda a, fill=0: np.concatenate([a, np.full((n - k,) + a.shape[1:], fill, a.dtype)])
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return empty_frame(n, device).replace(
            fseq=fseq, und_xy=t(pad(uv)), desc=t(pad(desc).view(np.int32)), valid=t(np.arange(n) < k),
            ids=t(pad(ids.astype(np.int32), -1)), pose_f2g=t(pose),
        )

    for kf in scene["kfs"]:
        m.add_keyframe(frame(kf["uv"], scene["descs"][kf["obs"]], slots[kf["obs"]], kf["pose"], kf["fseq"]))
    kfdb = KeyFrameDataBase(params.maxKeyFrames, device=device)
    for s in m.keyframes.active_slots():
        kfdb.add(int(s), m.state.kf_desc[int(s)], m.state.kf_kpt_valid[int(s)])
    lp = scene["loop"]
    dup_slots = m.add_points(lp["dup"], lp["dup_normals"], lp["desc"], lp["dup_min_dist"], lp["dup_max_dist"],
                             np.zeros(len(lp["dup"]), np.int32), 0)
    f = frame(lp["uv"], lp["desc"], dup_slots, lp["pose"], lp["fseq"])
    kf_slot = m.add_keyframe(f)
    kfdb.add(kf_slot, f.desc, f.valid)
    return m, LoopDetector(params, cam, kfdb), kf_slot, f


#: a marker of known pose in keyframe 0's view of ring_loop_scene (id, side
#: length, and its pose as an se3 tangent before the flip that turns it to
#: face the camera)
RING_MARKER = dict(id=7, size=1.0, xi=(0.3, -0.2, 4.5, 0.4, 0.3, 0.0))


def ring_marker(scene) -> dict:
    """RING_MARKER in ring_loop_scene: its world pose, and its corners as
    keyframe 0 and the returning camera (both truly at keyframe 0's pose)
    see them, each with its own 0.2 px noise; numpy."""
    import numpy as np
    import torch
    from ucoslam_tpu_torch.geometry.se3 import se3_exp
    from ucoslam_tpu_torch.markers.ippe import marker_object_points

    g2m = se3_exp(torch.tensor(RING_MARKER["xi"])).numpy() @ np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    T = scene["true_poses"][0] @ g2m
    q = marker_object_points(RING_MARKER["size"]).numpy() @ T[:3, :3].T + T[:3, 3]
    uv = np.stack([500.0 * q[:, 0] / q[:, 2] + 320.0, 500.0 * q[:, 1] / q[:, 2] + 240.0], -1)
    rng = np.random.default_rng(11)
    return dict(g2m=g2m.astype(np.float32), corners_kf0=(uv + rng.normal(0, 0.2, uv.shape)).astype(np.float32),
                corners_loop=(uv + rng.normal(0, 0.2, uv.shape)).astype(np.float32), **RING_MARKER)


def add_ring_marker(m, marker: dict, kf_slot: int, f, cam):
    """Register ring_marker's marker in the port's map of ring_loop_map
    (with its true pose), record its observations in keyframe 0 and the
    returning keyframe `kf_slot`. -> the returning frame `f` carrying it."""
    import numpy as np
    import torch
    from ucoslam_tpu_torch.markers.detector import _markers_from
    from ucoslam_tpu_torch.slam.markermap import record_marker_observations

    slot = m.markers.alloc()
    m.set_markers([slot], mk_id=[marker["id"]], mk_active=[True], mk_size=[marker["size"]],
                  mk_pose=marker["g2m"][None], mk_pose_valid=[True])
    slots = np.full(16, -1, np.int32)
    slots[0] = slot
    for kf, key in ((0, "corners_kf0"), (kf_slot, "corners_loop")):
        corners = np.zeros((16, 4, 2), np.float32)
        corners[0] = marker[key]
        fm = _markers_from(np.asarray([marker["id"]], np.int32), corners, torch.from_numpy(corners).to(m.device),
                           marker["size"], cam)
        record_marker_observations(m, kf, fm, slots)
    return f.replace(markers=fm)


def se3_exp_np(xi) -> "np.ndarray":
    """SE3 exponential of xi = [rho, phi] in float64 numpy, -> float32 4x4."""
    import numpy as np

    xi = np.asarray(xi, np.float64)
    rho, phi = xi[:3], xi[3:]
    th = float(np.linalg.norm(phi))
    Kx = np.array([[0.0, -phi[2], phi[1]], [phi[2], 0.0, -phi[0]], [-phi[1], phi[0], 0.0]])
    if th < 1e-8:
        R, Vj = np.eye(3) + Kx, np.eye(3) + 0.5 * Kx
    else:
        a, b = (1.0 - np.cos(th)) / th**2, (th - np.sin(th)) / th**3
        R = np.eye(3) + np.sin(th) / th * Kx + a * Kx @ Kx
        Vj = np.eye(3) + a * Kx + b * Kx @ Kx
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, Vj @ rho
    return T.astype(np.float32)


#: the camera of ba_scale_problem (fx, fy, cx, cy) and its bf
BA_CAMERA, BA_BF = (500.0, 500.0, 320.0, 240.0), 50.0


def ba_scale_problem(n_kf=128, n_pt=16384, obs_per_pt=8, seed=7) -> dict:
    """The synthetic BA problem of bench.py's global-BA benchmark
    (`_make_ba_problem`), as numpy arrays from the same draws in the same
    order: n_kf keyframes along a gentle curve, n_pt points each seen by
    obs_per_pt consecutive keyframes (a sliding window), 0.5 px pixel noise,
    poses perturbed by 0.01 (keyframe 0 fixed), points by 0.05."""
    import numpy as np

    fx, fy, cx, cy = BA_CAMERA
    rng = np.random.default_rng(seed)
    X = rng.uniform(-4, 4, (n_pt, 3)).astype(np.float32)
    X[:, 2] = rng.uniform(6, 16, n_pt)
    poses = np.stack([se3_exp_np(np.array(
        [0.1 * np.sin(k * 0.1), 0.05 * np.cos(k * 0.13), 0.002 * k, 0.005 * np.sin(k * 0.2),
         0.005 * np.cos(k * 0.1), 0.0], np.float32)) for k in range(n_kf)])
    base = (np.arange(n_pt, dtype=np.int64) * n_kf // n_pt).astype(np.int32)
    obs_cam2 = (base[:, None] + np.arange(obs_per_pt, dtype=np.int32)) % n_kf
    T = poses[obs_cam2]  # (P, MO, 4, 4)
    Xc = np.einsum("pmij,pj->pmi", T[:, :, :3, :3], X) + T[:, :, :3, 3]
    uv = np.stack([fx * Xc[..., 0] / Xc[..., 2] + cx, fy * Xc[..., 1] / Xc[..., 2] + cy], -1).astype(np.float32)
    uv += rng.normal(0, 0.5, uv.shape).astype(np.float32)
    O = n_pt * obs_per_pt
    poses_init = poses.copy()
    xi_n = rng.normal(0, 0.01, (n_kf, 6)).astype(np.float32)
    for k in range(1, n_kf):
        poses_init[k] = se3_exp_np(xi_n[k]) @ poses[k]
    X_init = X + rng.normal(0, 0.05, X.shape).astype(np.float32)
    return dict(
        cam_pose=poses_init, cam_fixed=np.arange(n_kf) == 0, cam_valid=np.ones(n_kf, bool), pt_pos=X_init,
        pt_valid=np.ones(n_pt, bool), obs_cam=obs_cam2.reshape(-1).astype(np.int32),
        obs_pt=np.repeat(np.arange(n_pt, dtype=np.int32), obs_per_pt), obs_uv=uv.reshape(O, 2),
        obs_sigma2=np.ones(O, np.float32), obs_depth=np.zeros(O, np.float32), obs_valid=np.ones(O, bool),
        pt_obs=np.arange(O, dtype=np.int32).reshape(n_pt, obs_per_pt),
    )


def ba_gap(a: tuple, b: tuple, arrays: dict) -> dict:
    """How far the BA solution a = (cam_pose, pt_pos) of ba_scale_problem's
    arrays lies from b, in measures its free gauge cannot swamp (one fixed
    camera leaves the scale free, and the routes of one solver end that
    far apart along it): `reprojection_p99`, the 99th percentile over the
    observations of the distance (px) between the residual a and b give it;
    `point_p50` / `point_p99`, per point the distance from b's after a's
    cameras and points are brought onto b's by the best similarity
    (Umeyama), over its distance from b's first camera; `rotation`, the
    largest entry of the cameras' rotation differences (the fixed camera
    holds the rotation)."""
    import numpy as np

    fx, fy, cx, cy = BA_CAMERA

    def residual(pose, pts):
        T, X = pose.astype(np.float64)[arrays["obs_cam"]], pts.astype(np.float64)[arrays["obs_pt"]]
        Xc = np.einsum("oij,oj->oi", T[:, :3, :3], X) + T[:, :3, 3]
        return np.stack([fx * Xc[:, 0] / Xc[:, 2] + cx, fy * Xc[:, 1] / Xc[:, 2] + cy], -1) - arrays["obs_uv"]

    def centers(pose):
        pose = pose.astype(np.float64)
        return -np.einsum("kji,kj->ki", pose[:, :3, :3], pose[:, :3, 3])

    (pa, xa), (pb, xb) = [(np.asarray(p), np.asarray(x)) for p, x in (a, b)]
    src, dst = np.concatenate([centers(pa), xa]), np.concatenate([centers(pb), xb]).astype(np.float64)
    ms, md = src.mean(0), dst.mean(0)
    U, S, Vt = np.linalg.svd((dst - md).T @ (src - ms) / len(src))
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ D @ Vt
    scale = np.trace(np.diag(S) @ D) / ((src - ms) ** 2).sum(1).mean()
    moved = scale * (xa.astype(np.float64) - ms) @ R.T + md
    rel = np.linalg.norm(moved - xb, axis=1) / np.linalg.norm(xb - centers(pb)[0], axis=1)
    reproj = np.linalg.norm(residual(pa, xa) - residual(pb, xb), axis=1)
    return dict(reprojection_p99=float(np.percentile(reproj, 99)), point_p50=float(np.percentile(rel, 50)),
                point_p99=float(np.percentile(rel, 99)), rotation=float(np.abs(pa[:, :3, :3] - pb[:, :3, :3]).max()))


def ba_gap_failures(gap: dict, spread: dict) -> list[str]:
    """The measures of ba_gap past twice the widest of the reference's
    route pairs' (`spread`: pair -> ba_gap)."""
    return [k for k, v in gap.items() if v > 2 * max(pair[k] for pair in spread.values())]


def ba_problem_on(arrays: dict, device):
    """The port's BAProblem of ba_scale_problem's arrays on `device`, with its
    camera->observation table. -> (problem, camera)."""
    import numpy as np
    import torch
    from ucoslam_tpu_torch.geometry.camera import CameraParams
    from ucoslam_tpu_torch.optim.ba import BAProblem, _build_cam_obs

    def t(a):
        a = np.ascontiguousarray(a)
        return torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a).to(device)

    problem = BAProblem(**{k: t(v) for k, v in arrays.items()}, bf=BA_BF,
                        cam_obs=t(_build_cam_obs(arrays["obs_cam"], arrays["cam_pose"].shape[0])))
    return problem, CameraParams.create(*BA_CAMERA)


def b2_batch_inputs(device, C: int, B: int, seed: int = 100):
    """C different b2_inputs problems of B rows (seeds seed .. seed+C-1:
    each its own start pose, outliers and valid mask), stacked."""
    import torch

    probs = [b2_inputs(device, B=B, seed=seed + c) for c in range(C)]
    names = ("pose_init", "pts3d", "uv", "sigma2", "valid")
    return [torch.stack([p[k] for p in probs]).contiguous() for k in names]


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
    from ucoslam_tpu_torch.ops.cuda import fast_kernel, lm_kernel, match_kernel
    from ucoslam_tpu_torch.slam.system import disable_tf32

    disable_tf32()
    t0 = time.perf_counter()
    cuda.build(*cuda.KERNELS)  # one nvcc each, in parallel
    match_kernel._library()
    lm_kernel._library()
    fast_kernel._library()
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
    rec.update(phase_b2_batched())
    return rec


def phase_b2_batched() -> dict:
    """Batched B2 (candidate verification's refines, iters 10, rounds 2)
    against its plain version: at C=5 problems of B=2048 rows (pose < 1e-4,
    the same masks), C=1 bit-equal to the single launch, and B=16384 (the
    brute-force relocalization's arena), single and batched."""
    import torch
    from ucoslam_tpu_torch.ops.cuda import lm_kernel

    cam = (500.0, 500.0, 320.0, 240.0)
    rec = {}
    for C, B in ((5, 2048), (1, 16384)):
        args = b2_batch_inputs("cuda", C, B)

        def kernel():
            return lm_kernel.motion_only_lm_fused_batched(*args, *cam, iters=10, rounds=2)

        def plain():
            return lm_kernel.motion_only_lm_plain_batched(*args, *cam, iters=10, rounds=2)

        (pose_k, mask_k), (pose_p, mask_p) = kernel(), plain()
        single = [lm_kernel.motion_only_lm_fused(*(a[c] for a in args), *cam, iters=10, rounds=2) for c in range(C)]
        torch.cuda.synchronize()
        err = float((pose_k - pose_p).abs().max())
        check(err < 1e-4, f"batched B2 pose differs by {err} (C={C}, B={B})")
        check(torch.equal(mask_k, mask_p), f"batched B2 inlier masks differ (C={C}, B={B})")
        single_err = max(float((pose_k[c] - single[c][0]).abs().max()) for c in range(C))
        check(all(torch.equal(single[c][1], mask_k[c]) for c in range(C)), "batched and single B2 masks differ")
        ms, plain_ms = median_ms(kernel, 50), median_ms(plain, 3)
        single_ms = median_ms(lambda: [lm_kernel.motion_only_lm_fused(*(a[c] for a in args), *cam, iters=10, rounds=2)
                                       for c in range(C)], 50)
        # C problems' bytes and float operations (b2_bound's count, summed)
        nbytes = C * (64 + B * (12 + 8 + 4 + 1) + 64 + B)
        t_ops = sum(10 * (int(args[4][c].sum()) + int(mask_k[c].sum())) for c in range(C)) * B2_ROW_OPS / FP32_OPS_PER_S
        bound_ms, bound_by = bound_of(nbytes, t_ops)
        print(f"[3 B2 batched] C={C} B={B} 10x2: pose_max_abs_err={err:.3e} masks equal; vs single launches "
              f"max_abs={single_err:.3e} kernel_ms={ms:.4f} single_launches_ms={single_ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.6f} ({bound_by})")
        rec["max_abs_err_batched"] = max(rec.get("max_abs_err_batched", 0.0), err)
        if C == 1:
            check(single_err == 0.0, f"batched B2 at C=1 differs from the single launch by {single_err}")
            rec.update(ms_b16384=single_ms, plain_ms_b16384=plain_ms, bound_ms_b16384=bound_ms)
        else:
            # C=1 of these problems, bit-equal to the single launch
            one = lm_kernel.motion_only_lm_fused_batched(*(a[:1].contiguous() for a in args), *cam, iters=10, rounds=2)
            check(torch.equal(one[0][0], single[0][0]) and torch.equal(one[1][0], single[0][1]),
                  "batched B2 at C=1 is not bit-equal to the single launch")
            rec.update(ms_batched=ms, plain_ms_batched=plain_ms, bound_ms_batched=bound_ms,
                       bound_by_batched=bound_by, single_launches_ms_batched=single_ms)
    return rec


def phase_detect(scene) -> tuple[dict, dict]:
    """Kernels F1 and F2 on frame 0 of the scene at the library's widths
    against their plain versions on the card -> (F1's record, F2's); their
    launches are counted on the main paths from phase 4 on."""
    import numpy as np
    import torch
    from ucoslam_tpu_torch.features.orb import BLUR_K, EDGE_MARGIN, PATCH_RADIUS, ORBExtractor
    from ucoslam_tpu_torch.ops.cuda import fast_kernel

    orb = ORBExtractor()
    img = torch.from_numpy(np.asarray(scene[3][0], np.float32)).to("cuda")
    pyr = orb._pyramid(img)
    levels = pyr(img)
    grid = (orb.cell, orb.k_per_cell)
    rows = (orb.budgets, orb.scales, PATCH_RADIUS + BLUR_K // 2)

    def f1():
        return fast_kernel.fast_cells(levels, pyr, orb.fast_threshold, *grid, EDGE_MARGIN)

    def f1_plain():
        return fast_kernel.fast_cells_plain(levels, pyr, orb.fast_threshold, *grid, EDGE_MARGIN)

    cand = f1()
    got = fast_kernel.select_keypoints(levels, pyr, *cand, *grid, *rows)
    want_cand = f1_plain()
    want = fast_kernel.select_keypoints_plain(levels, pyr, *want_cand, *grid, *rows)
    torch.cuda.synchronize()
    check(all(torch.equal(g, w) for g, w in zip(cand, want_cand)), "F1 differs from its plain version")
    check(all(torch.equal(g, w) for g, w in zip(got, want)), "F2 differs from its plain version")
    ms = [median_ms(f1, 50), median_ms(lambda: fast_kernel.select_keypoints(levels, pyr, *cand, *grid, *rows), 50)]
    plain_ms = [median_ms(f1_plain, 5),
                median_ms(lambda: fast_kernel.select_keypoints_plain(levels, pyr, *cand, *grid, *rows), 5)]
    n, n_cand, P = sum(orb.budgets), cand[0].numel(), 2 * rows[2] + 1
    # bytes: F1 reads the levels once and writes the candidates; F2 reads
    # the candidates and writes the rows and patches (the patches' pixels it
    # reads are left out: a lower bound)
    f1_bound = bound_of(4 * levels.numel() + 8 * n_cand, levels.numel() * DETECT_OPS_PER_PIXEL / ISSUE_PER_S)
    f2_bound = bound_of(8 * n_cand + n * (8 + 4 + 4 + 1 + 4 * P * P), 0.0)
    recs = []
    for name, k_ms, p_ms, (b_ms, b_by) in zip(("F1", "F2"), ms, plain_ms, (f1_bound, f2_bound)):
        print(f"[3 {name}] 640x480 8 levels: exact, valid={int(want[3].sum())} "
              f"kernel_ms={k_ms:.4f} plain_chain_ms={p_ms:.4f} bound_ms={b_ms:.6f} ({b_by})")
        recs.append(dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=0))
    return recs[0], recs[1]


@contextlib.contextmanager
def patched(obj, name: str, around):
    """While entered, a call of obj.<name>(*a, **kw) (a module's function, a
    class's method or one object's method) runs around(inner, *a, **kw),
    inner being what obj.<name> was; restored on exit."""
    own, inner = name in vars(obj), getattr(obj, name)
    saved = vars(obj).get(name)
    setattr(obj, name, lambda *a, **kw: around(inner, *a, **kw))
    try:
        yield
    finally:
        if own:
            setattr(obj, name, saved)
        else:
            delattr(obj, name)


def timing(times: list):
    """An `around` for `patched`: each call timed on the host clock up to a
    device synchronize, in ms, appended to `times`."""
    import torch

    def around(inner, *args, **kwargs):
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        return out

    return around


def count_calls(stack: contextlib.ExitStack) -> dict:
    """Counts, while `stack` is open, the duplicate fusions
    (`mapmanager.fuse_duplicates_into_kf`: one B1 launch each, at keyframe
    insertion and at a loop's seam) and the marker pose refines
    (`markermap.motion_only_lm`: one B2 launch each)."""
    from ucoslam_tpu_torch.slam import mapmanager, markermap

    n = {"fusions": 0, "marker_lm": 0}

    def counting(key):
        def around(inner, *args, **kwargs):
            n[key] += 1
            return inner(*args, **kwargs)
        return around

    stack.enter_context(patched(mapmanager, "fuse_duplicates_into_kf", counting("fusions")))
    stack.enter_context(patched(markermap, "motion_only_lm", counting("marker_lm")))
    return n


def camera_center(pose):
    import numpy as np

    pose = np.asarray(pose, np.float64)
    return -pose[:3, :3].T @ pose[:3, 3]


def load_scene(ref_path: str, kind: str = "mono"):
    """-> (the JAX package's summary, camera, sequence, each frame's input:
    the rendered image, or for "stereo" / "rgbd" depth_input's tuple)."""
    from ucoslam_tpu_torch.geometry.camera import CameraParams
    from ucoslam_tpu_torch.io.synthetic import SyntheticSequence

    with open(ref_path) as f:
        ref = json.load(f)
    c = ref["camera"]
    cam = CameraParams.create(c["fx"], c["fy"], c["cx"], c["cy"], width=c["width"], height=c["height"],
                              bl=c.get("bl", 0.0), rgb_depthscale=c.get("rgb_depthscale", 1.0 / 5000.0))
    seq = SyntheticSequence(cam=cam, **ref["sequence"])
    return ref, cam, seq, [seq.render(i) if kind == "mono" else depth_input(kind, seq, i) for i in range(seq.n_frames)]


def feed(slam, kind: str, inputs, i: int):
    """Frame i through the UcoSlam entry point of its kind: process(image),
    processStereo(left, right) or processRGBD(image, raw depth)."""
    if kind == "mono":
        return slam.process(inputs, fseq=i)
    return (slam.processStereo if kind == "stereo" else slam.processRGBD)(*inputs, i)


def extract(ext, kind: str, inputs, i: int):
    """Frame i's Frame from a FrameExtractor, by the method of its kind."""
    if kind == "mono":
        return ext.process(inputs, i)
    return (ext.process_stereo if kind == "stereo" else ext.process_rgbd)(*inputs, i)


def ate_of(poses: dict, seq) -> float:
    import numpy as np
    from ucoslam_tpu_torch.geometry.horn import ate_rmse

    idx = sorted(poses)
    return ate_rmse(np.stack([camera_center(poses[i]) for i in idx]), seq.gt_positions()[idx], with_scale=True)


def metric_summary(poses: dict, seq) -> dict:
    """Metric ATE (rigid alignment, no scale), the Horn scale against the
    truth and the scale-aligned ATE of a run's poses (a marker map is
    metric, so its ATE is taken without scale alignment)."""
    import numpy as np
    from ucoslam_tpu_torch.geometry.horn import ate_rmse, horn_align

    idx = sorted(poses)
    if len(idx) < 3:
        return dict(metric_ate=float("inf"), horn_scale=None, ate=float("inf"))
    est = np.stack([camera_center(poses[i]) for i in idx])
    gt = seq.gt_positions()[idx]
    return dict(metric_ate=ate_rmse(est, gt, with_scale=False), horn_scale=float(horn_align(est, gt)[0]),
                ate=ate_rmse(est, gt, with_scale=True))


def map_to_world(poses: dict, seq):
    """(4, 4) rigid transform from a map's frame to the world, from the
    tracked frames' full poses: the mean of gt_pose^-1 @ pose, its rotation
    projected back onto SO(3)."""
    import numpy as np

    A = np.stack([np.linalg.inv(seq.gt_pose(i).astype(np.float64)) @ np.asarray(poses[i], np.float64)
                  for i in sorted(poses)])
    U, _, Vt = np.linalg.svd(A[:, :3, :3].sum(0))
    T = np.eye(4)
    T[:3, :3] = U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt)]) @ Vt
    T[:3, 3] = A[:, :3, 3].mean(0)
    return T


def marker_errors(mk_id, mk_pose, mk_valid, poses: dict, seq, truth: dict) -> dict:
    """Markers with a map pose, and the distance of their centres from the
    scene's (`truth`: id -> marker-to-world pose), the map carried into the
    world by map_to_world."""
    import numpy as np

    sel = [int(s) for s in np.nonzero(mk_valid)[0]]
    if not sel or not poses:
        return dict(markers_posed=len(sel), marker_err_mean=None, marker_err_max=None)
    T = map_to_world(poses, seq)
    err = [float(np.linalg.norm(T[:3, :3] @ mk_pose[s][:3, 3] + T[:3, 3] - truth[int(mk_id[s])][:3, 3]))
           for s in sel]
    return dict(markers_posed=len(sel), marker_err_mean=float(np.mean(err)), marker_err_max=float(np.max(err)))


def init_kind(slam, before_keyframes: int) -> str | None:
    """How a frame initialized the map of a UcoSlam (None if it did not):
    `marker` (no points: the marker path), `depth` (one keyframe with
    points: a stereo or RGB-D frame), `hybrid` (two-view points made metric
    by a marker), or `keypoint` (two-view, arbitrary scale)."""
    if before_keyframes > 0 or slam.map.n_keyframes == 0:
        return None
    if not slam._system.manager.metric_locked:
        return "keypoint"
    if slam.map.n_points == 0:
        return "marker"
    return "depth" if slam.map.n_keyframes == 1 else "hybrid"


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
    first_valid, t_extract, t_track = [], [], []

    def first_match(inner, *args):
        if not first_valid:
            first_valid.append(args[3])
        return inner(*args)

    poses, t_process = {}, []
    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(projection, "project_match", first_match))
        # process() is extract, then track: time each where process() calls it
        stack.enter_context(patched(slam._extractor, "process", timing(t_extract)))
        stack.enter_context(patched(slam._system, "process_frame", timing(t_track)))
        reset_counts()
        for i in frames:
            t0 = time.perf_counter()
            pose = slam.process(images[i], fseq=i)
            torch.cuda.synchronize()
            t_process.append(1e3 * (time.perf_counter() - t0))
            if pose is not None:
                poses[i] = pose
        launches = counts()
    attempts = slam._system.tracker.n_attempts
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
    for k in ("B1", "B2"):
        check(launches[k] > 0 and launches[k] == 2 * attempts,
              f"{k} launched {launches[k]} times for {attempts} track attempts")
    check_detect_launches(launches, detect_calls(slam, "mono", len(frames)), "[4 slice]")
    check(abs(first_live - SLICE_LIVE_ROWS) <= 0.1 * SLICE_LIVE_ROWS,
          f"B1 had {first_live} live rows on the first attempt; SLICE_LIVE_ROWS is {SLICE_LIVE_ROWS}")
    return launches


#: the timed steps of MapManager.new_keyframe, by the method that runs each
KEYFRAME_STEPS = {"epipolar": "_create_epipolar_points", "fuse": "_fuse_duplicates",
                  "cull_points": "_cull_recent_points", "cull_keyframes": "_cull_keyframes"}


def slam_pass(params, cam, images, kind: str = "mono") -> dict:
    """One forward SLAM pass of `UcoSlam(device="cuda")` over the images
    (each fed by `feed` as `kind`):
    each `process` timed and classed by what the frame did (init, track, or
    a keyframe insertion), `new_keyframe` and its steps timed, the kernels'
    launches counted with the calls that launch them, the init's kind, and
    the B1 inputs of the last duplicate fusion kept."""
    import torch
    from ucoslam_tpu_torch.api import UcoSlam
    from ucoslam_tpu_torch.matching import projection
    from ucoslam_tpu_torch.ops.cuda import lm_kernel, match_kernel
    from ucoslam_tpu_torch.optim import ba

    slam = UcoSlam(device="cuda")
    slam.setParams(None, params, cam)
    mgr = slam._system.manager
    steps = {k: [] for k in ("new_keyframe", *KEYFRAME_STEPS, "local_ba")}
    in_fuse, fuse_args = [], []

    def fuse(inner, *args):
        in_fuse.append(True)
        try:
            return inner(*args)
        finally:
            in_fuse.clear()

    def match(inner, *args):
        if in_fuse:
            fuse_args[:] = [a.clone() for a in args]
        return inner(*args)

    poses, t_frame, init = {}, {"init": [], "track": [], "keyframe": []}, None
    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(mgr, "new_keyframe", timing(steps["new_keyframe"])))
        for k, m in KEYFRAME_STEPS.items():
            stack.enter_context(patched(mgr, m, timing(steps[k])))
        stack.enter_context(patched(ba, "local_bundle_adjustment", timing(steps["local_ba"])))
        stack.enter_context(patched(mgr, "_fuse_duplicates", fuse))  # around its timing
        stack.enter_context(patched(projection, "project_match", match))
        calls = count_calls(stack)
        reset_counts()
        for i, img in enumerate(images):
            before, inserted = slam.map.n_keyframes, mgr.n_insertions
            t0 = time.perf_counter()
            pose = feed(slam, kind, img, i)
            torch.cuda.synchronize()
            did = "keyframe" if mgr.n_insertions > inserted else "track" if before > 0 else "init"
            t_frame[did].append(1e3 * (time.perf_counter() - t0))
            if (k := init_kind(slam, before)) is not None:
                init = dict(kind=k, frame=i)
            if pose is not None:
                poses[i] = pose
        launches = counts()
    return dict(slam=slam, poses=poses, t_frame=t_frame, steps=steps, launches=launches,
                attempts=slam._system.tracker.n_attempts, insertions=mgr.n_insertions,
                fuse_args=tuple(fuse_args), init=init, detects=detect_calls(slam, kind, len(images)), **calls)


def detect_calls(slam, kind: str, frames: int) -> int:
    """The detect_and_compute calls of `frames` frames of `kind` through
    slam's extractor, each one launch of F1 and one of F2: one an image
    (two a stereo frame) where the detector is the port's ORBExtractor,
    none for the cv2 families."""
    from ucoslam_tpu_torch.features.orb import ORBExtractor

    return frames * (2 if kind == "stereo" else 1) if isinstance(slam._extractor.orb, ORBExtractor) else 0


def check_detect_launches(launches: dict, calls: int, what: str) -> None:
    check(launches["F1"] == launches["F2"] == calls,
          f"{what}: F1 / F2 launched {launches['F1']} / {launches['F2']} times for {calls} detect_and_compute calls")


def check_slam_launches(run: dict, what: str) -> None:
    """B1 = 2 x track attempts + duplicate fusions (one per keyframe
    insertion, and one per keyframe of a loop's seam); B2 = 2 x track
    attempts (a marker fallback's retried track among them) + batched
    verifications + marker pose refines; F1 = F2 = the detector's calls."""
    n1, n2, a, k = run["launches"]["B1"], run["launches"]["B2"], run["attempts"], run["insertions"]
    nb, fu, mk = run["launches"]["B2_batched"], run["fusions"], run["marker_lm"]
    check(a > 0 and k > 0 and fu >= k, f"{what}: {a} track attempts, {k} keyframe insertions, {fu} fusions")
    check(n1 == 2 * a + fu, f"{what}: B1 launched {n1} times for {a} track attempts and {fu} fusions")
    check(n2 == 2 * a + nb + mk, f"{what}: B2 launched {n2} times for {a} track attempts, {nb} batched "
          f"verifications and {mk} marker refines")
    check_detect_launches(run["launches"], run["detects"], what)


def phase_slam(scene, map_path: str, workdir: str) -> dict:
    """Phase 5 -> the kernels' launches on its main path, B1's record at
    the last fusion's inputs, and the pass-1 checkpoint (in workdir)."""
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
    path = os.path.join(workdir, "slam.slm")
    slam.saveToFile(path)
    loc = UcoSlam(device="cuda")
    loc.readFromFile(path, cam)
    check(loc.getSignatureStr() == slam.getSignatureStr(), "the reloaded checkpoint has another signature")
    loc.setMode(Mode.LOCALIZATION)
    reset_counts()
    rev, t_rev = {}, []
    for i in reversed(range(len(images))):
        t0 = time.perf_counter()
        pose = loc.process(images[i], fseq=i)
        torch.cuda.synchronize()
        t_rev.append(1e3 * (time.perf_counter() - t0))
        if pose is not None:
            rev[i] = pose
    rev_launches = counts()
    rev_attempts = loc._system.tracker.n_attempts
    check(len(rev) >= 3, f"the reverse sweep tracked only {len(rev)} frames")
    rev_ate = ate_of(rev, seq)
    print(f"[5 slam] reload + reverse sweep: tracked={len(rev)} (jax {ref['pass2_tracked']}) ate={rev_ate:.6f} "
          f"(jax {ref['pass2_ate']:.6f}) process_ms_median={np.median(t_rev):.3f} attempts={rev_attempts} "
          f"launches={rev_launches}")
    check(len(rev) >= ref["pass2_tracked"] - 2, "the reverse sweep tracked over 2 frames fewer than JAX's")
    check(rev_ate <= 1.2 * ref["pass2_ate"] + 0.002, f"reverse-sweep ATE {rev_ate} over the limit")
    for k in ("B1", "B2"):
        check(rev_launches[k] > 0 and rev_launches[k] == 2 * rev_attempts,
              f"{k} launched {rev_launches[k]} times for {rev_attempts} track attempts")
    check_detect_launches(rev_launches, detect_calls(loc, "mono", len(images)), "[5 slam] reverse sweep")
    launches = {k: n + rev_launches[k] for k, n in launches.items()}

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
    return dict(launches=launches, checkpoint=path, b1_fuse=dict(
        launches_fuse=fuse_launches, ms_fuse=fuse_ms,
        plain_ms_fuse=fuse_plain_ms, bound_ms_fuse=fuse_bound_ms, bound_by_fuse=fuse_bound_by))


def recovery_ref(name: str) -> dict:
    with open(os.path.join(HERE, "data", "torch_port", f"mono_{name}_jax.json")) as f:
        return json.load(f)


#: the tracer's launch counters at the last reset_counts()
_COUNTS_AT_RESET: dict = {}
#: the kernels' launch counters (`timers.count`): B1, B2 single and
#: batched, F1, F2
KERNEL_COUNTERS = ("B1", "B2", "B2_batched", "F1", "F2")


def counts() -> dict:
    """The kernels' launches since the last reset_counts(): the tracer's
    counters, which count while tracing is on (from main()'s start)."""
    from ucoslam_tpu_torch.utils.timers import timers

    now = timers.counters()
    return {k: now.get(k, 0) - _COUNTS_AT_RESET.get(k, 0) for k in KERNEL_COUNTERS}


def reset_counts() -> None:
    from ucoslam_tpu_torch.utils.timers import timers

    _COUNTS_AT_RESET.clear()
    _COUNTS_AT_RESET.update(timers.counters())


def reloc_sweep(scene, brute_force: bool, map_path: str = MAP_PATH, jax_ref: dict | None = None,
                tag: str = "6 reloc") -> dict:
    """Phase 6 (a) or (b), or phase 10's sweep: a JAX map localized in
    reverse, resetTracker() before each of its reset frames, held to the JAX
    package's same sweep (`jax_ref`, phase 6's by default)."""
    import numpy as np
    import torch
    from ucoslam_tpu_torch import Mode
    from ucoslam_tpu_torch.api import UcoSlam
    from ucoslam_tpu_torch.config import TrackingState

    ref, cam, seq, images = scene
    jax_ref = jax_ref or recovery_ref("reloc_bf" if brute_force else "reloc")
    reset_frames = set(jax_ref["reset_frames"])
    slam = UcoSlam(device="cuda")
    slam.readFromFile(map_path, cam)
    slam.setMode(Mode.LOCALIZATION)
    system = slam._system
    if brute_force:
        system.manager.kfdb.dummy = True
    tracker = system.tracker
    poses, t_reloc, t_track = {}, [], []
    reset_counts()
    for i in reversed(range(seq.n_frames)):
        if i in reset_frames:
            slam.resetTracker()
        lost = system.state != TrackingState.TRACKING
        t0 = time.perf_counter()
        pose = slam.process(images[i], fseq=i)
        torch.cuda.synchronize()
        (t_reloc if lost else t_track).append(1e3 * (time.perf_counter() - t0))
        if pose is not None:
            poses[i] = pose
    launches = counts()
    for p in poses.values():
        check(p.shape == (4, 4) and np.isfinite(p).all(), "non-finite pose")
    ref_poses = {int(k): np.asarray(v) for k, v in jax_ref["poses"].items()}
    relocalized = sum(i in poses for i in reset_frames)
    ate = ate_of(poses, seq)
    dev = max(np.linalg.norm(camera_center(poses[i]) - camera_center(ref_poses[i])) for i in poses if i in ref_poses)
    tol = 0.02 * ref["depth_extent"]
    what = "(b) brute force" if brute_force else "(a) BoW"
    print(f"[{tag}] {what}: relocalized={relocalized}/{len(reset_frames)} (jax {jax_ref['relocalized']}) "
          f"tracked={len(poses)} (jax {jax_ref['tracked']}) ate={ate:.6f} (jax {jax_ref['ate']:.6f}) "
          f"max_centre_dev={dev:.6f} (tol {tol:.6f}) relocalizations={tracker.n_relocalizations} "
          f"attempts={tracker.n_attempts} launches={launches} process_ms_median: reloc={np.median(t_reloc):.3f} "
          f"(n={len(t_reloc)}) track={np.median(t_track):.3f} (n={len(t_track)})")
    check(relocalized >= jax_ref["relocalized"], f"{what}: relocalized fewer reset frames than the JAX package")
    check(len(poses) >= jax_ref["tracked"], f"{what}: tracked fewer frames than the JAX package")
    check(ate <= 1.2 * jax_ref["ate"] + 0.002, f"{what}: ATE {ate} over the limit")
    check(dev <= tol, f"{what}: camera centre {dev} from the JAX pose (tol {tol})")
    check(launches["B1"] == 2 * tracker.n_attempts, f"{what}: B1 launched {launches['B1']} times")
    check_detect_launches(launches, detect_calls(slam, "mono", seq.n_frames), what)
    if brute_force:  # one single launch at B = the arena per relocalization, 2 per track attempt
        check(launches["B2_batched"] == 0 and launches["B2"] == 2 * tracker.n_attempts + tracker.n_relocalizations,
              f"{what}: B2 launches {launches}")
    else:  # one batched launch per relocalization with a candidate
        check(1 <= launches["B2_batched"] <= tracker.n_relocalizations
              and launches["B2"] == 2 * tracker.n_attempts + launches["B2_batched"], f"{what}: B2 launches {launches}")
    return dict(launches=launches, reloc_ms=float(np.median(t_reloc)), track_ms=float(np.median(t_track)), slam=slam)


def slam_frames(params, cam, images, skip=()) -> dict:
    """A SLAM pass of UcoSlam(device="cuda") over images, resetTracker() in
    place of the `skip` frames (not processed)."""
    import torch
    from ucoslam_tpu_torch.api import UcoSlam

    slam = UcoSlam(device="cuda")
    slam.setParams(None, params, cam)
    poses = {}
    for i, img in enumerate(images):
        if i in skip:
            slam.resetTracker()
            continue
        pose = slam.process(img, fseq=i)
        if pose is not None:
            poses[i] = pose
    torch.cuda.synchronize()
    return dict(slam=slam, poses=poses)


def phase_recovery(scene) -> dict:
    """Phase 6 -> the kernels' launches on its main paths, and times."""
    import numpy as np
    from ucoslam_tpu_torch.config import Params
    from ucoslam_tpu_torch.io.serialize import load_map_meta
    from ucoslam_tpu_torch.io.synthetic import SyntheticSequence

    ref, cam, seq, images = scene
    launches = dict.fromkeys(KERNEL_COUNTERS, 0)
    out = {}
    for brute_force in (False, True):
        r = reloc_sweep(scene, brute_force)
        launches = {k: n + r["launches"][k] for k, n in launches.items()}
        out["bf" if brute_force else "bow"] = r
    params = Params.from_dict(load_map_meta(MAP_PATH)["params"])

    # (c) SLAM through a gap of reset frames, twice
    gap = recovery_ref("gap")
    skip, after = set(gap["gap_frames"]), max(gap["gap_frames"]) + 1
    reset_counts()
    runs = [slam_frames(params, cam, images, skip=skip) for _ in range(2)]
    c = counts()
    launches = {k: n + c[k] for k, n in launches.items()}
    tracked_after = [sum(i >= after for i in r["poses"]) for r in runs]
    sigs = [r["slam"].getSignatureStr() for r in runs]
    loops = [r["slam"]._system.manager.loop_closures for r in runs]
    print(f"[6 gap] (c) frames {sorted(skip)} reset: tracked={len(runs[0]['poses'])} (jax {gap['tracked']}) "
          f"tracked_after_gap={tracked_after[0]} (jax {gap['tracked_after_gap']}) ate={ate_of(runs[0]['poses'], seq):.6f} "
          f"(jax {gap['ate']:.6f}) relocalizations={runs[0]['slam']._system.tracker.n_relocalizations} "
          f"loop_closures={loops[0]} signature={sigs[0]} again={sigs[1]} launches(two passes)={c}")
    check(tracked_after[0] >= gap["tracked_after_gap"] - 2, "(c): tracked over 2 frames fewer after the gap than JAX")
    check(sigs[0] == sigs[1] and tracked_after[0] == tracked_after[1], "(c): a second pass gave another signature")
    runs[0]["slam"].map.check_consistency()
    del runs

    # (d) the re-seed on the splice
    rs = recovery_ref("reseed")
    other = SyntheticSequence(cam=cam, **rs["splice"]["sequence"])
    at = rs["splice"]["at"]
    spliced = images[:at] + [other.render(i) for i in range(at, len(images))]
    reset_counts()
    r = slam_frames(params, cam, spliced)
    c = counts()
    launches = {k: n + c[k] for k, n in launches.items()}
    slam = r["slam"]
    got_at = reseed_frame(slam._system.stats_log, params.reseedAfterLostFrames)
    after = None if got_at is None else sum(i > got_at for i in r["poses"])
    print(f"[6 reseed] (d) splice at {at}: reseed_frame={got_at} (jax {rs['reseed_frame']}) tracked_after_reseed="
          f"{after} (jax {rs['tracked_after_reseed']}) tracked={len(r['poses'])} (jax {rs['tracked']}) "
          f"keyframes={slam.map.n_keyframes} (jax {rs['n_keyframes']}) launches={c}")
    check(got_at is not None, "(d): the port did not re-seed")
    check(after >= rs["tracked_after_reseed"] - 2, "(d): tracked over 2 frames fewer after the re-seed than JAX")
    slam.map.check_consistency()
    out["launches"] = launches
    return out


def reseed_frame(log: list, after_lost: int):
    """First frame whose keyframe count rose by 2 (the two keyframes of a
    re-seeded segment) after >= after_lost lost frames in a row, from a
    System's stats_log; None if there is none."""
    streak = 0
    for prev, cur in zip(log, log[1:]):
        if cur["n_kf"] == prev["n_kf"] + 2 and streak >= after_lost:
            return cur["fseq"]
        streak = streak + 1 if not cur["tracked"] else 0
    return None


def loop_on(device: str) -> dict:
    """detect_from_keypoints -> correct_map -> global BA on the drifted ring
    map at the library's default capacities, on one device."""
    import numpy as np
    import torch
    from ucoslam_tpu_torch.config import Params
    from ucoslam_tpu_torch.optim.ba import global_bundle_adjustment
    from ucoslam_tpu_torch.slam import mapmanager

    def sync_ms(t0):
        if device == "cuda":
            torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    scene = ring_loop_scene()
    params = Params().replace(maxDescDistance=60.0, detectMarkers=False, KFMinConfidence=0.4)
    m, det, slot, f = ring_loop_map(scene, params, device)
    fused, ms = [], {}
    with patched(mapmanager, "fuse_duplicates_into_kf", lambda inner, *a: fused.append(a[1]) or inner(*a)):
        reset_counts()
        t0 = time.perf_counter()
        info = det.detect_from_keypoints(m, slot, f)
        ms["detect"] = sync_ms(t0)
        n_before = m.n_points
        t0 = time.perf_counter()
        ok = info.found and det.correct_map(m, info)
        ms["correct"] = sync_ms(t0)
    c = counts()
    poses_corr = m.h("kf_pose")[m.keyframes.active_slots()].copy()
    chi_merged = m.global_reproj_chi2(det.cam)
    t0 = time.perf_counter()
    global_bundle_adjustment(m, det.cam, n_iters=15)
    ms["global_ba"] = sync_ms(t0)
    return dict(info=info, ok=ok, n_before=n_before, n_after=m.n_points, fused=fused, launches=c, ms=ms,
                poses_corr=poses_corr, poses=m.h("kf_pose")[m.keyframes.active_slots()].copy(),
                chi_merged=chi_merged, chi=m.global_reproj_chi2(det.cam), scene=scene,
                drift_after=float(np.linalg.norm(poses_corr[9] - scene["true_poses"][9])),
                drift_before=float(np.linalg.norm(scene["drift_poses"][9] - scene["true_poses"][9])))


def phase_loop(slam_map_slm: str, cam) -> dict:
    """Phase 7 -> the kernels' launches on its main paths."""
    import numpy as np
    import torch
    from ucoslam_tpu_torch.api import UcoSlam

    card, cpu = loop_on("cuda"), loop_on("cpu")
    info = card["info"]
    pose_err = float(np.linalg.norm(info.expected_pose - card["scene"]["true_poses"][0])) if info.found else None
    d_corr = float(np.abs(card["poses_corr"] - cpu["poses_corr"]).max())
    d_ba = float(np.abs(card["poses"] - cpu["poses"]).max())
    print(f"[7 loop] ring map: found={info.found} matched_kf={info.matched_kf} n_inliers={info.n_matches} "
          f"expected_pose_err={pose_err} corrected={card['ok']} drift {card['drift_before']:.4f} -> "
          f"{card['drift_after']:.4f} points {card['n_before']} -> {card['n_after']} (cpu {cpu['n_after']}) "
          f"fused_kfs={card['fused']} chi2 merged={card['chi_merged']:.4f} after_global_ba={card['chi']:.4f} "
          f"(cpu {cpu['chi']:.4f}) card_vs_cpu_pose_max_abs: corrected={d_corr:.3e} after_ba={d_ba:.3e} "
          f"launches={card['launches']} ms: {json.dumps({k: round(v, 3) for k, v in card['ms'].items()})}")
    check(info.found and info.matched_kf == 0, "the loop was not found against keyframe 0")
    check(pose_err < 0.05, f"the loop's expected pose is {pose_err} from the truth")
    check(card["ok"] and card["drift_after"] < card["drift_before"], "the correction did not reduce the drift")
    check(card["n_after"] <= card["n_before"] - 30 and card["n_after"] == cpu["n_after"],
          "the seam's duplicates were not fused as on the CPU")
    check(d_corr <= 1e-3, f"card and CPU keyframe poses differ by {d_corr} after the correction")
    check(np.isfinite(card["chi"]) and card["chi"] < max(0.5 * card["chi_merged"], 6.0), "global BA did not settle")
    c = card["launches"]
    check(c["B2_batched"] == 1 and c["B2"] == 1, f"B2 launches {c} (one batched verification)")
    check(c["B1"] == len(card["fused"]) > 0, f"B1 launched {c['B1']} times for {len(card['fused'])} seam fusions")

    # globalOptimization on phase 5's pass-1 map, on the card and on the CPU
    chis, poses = {}, {}
    for device in ("cuda", "cpu"):
        slam = UcoSlam(device=device)
        slam.readFromFile(slam_map_slm, cam)
        before = slam.map.global_reproj_chi2(cam)
        t0 = time.perf_counter()
        slam.globalOptimization()
        if device == "cuda":
            torch.cuda.synchronize()
        chis[device] = (before, slam.map.global_reproj_chi2(cam), time.perf_counter() - t0)
        poses[device] = slam.map.h("kf_pose")[slam.map.keyframes.active_slots()]
    (b, a, t), (_, a_cpu, t_cpu) = chis["cuda"], chis["cpu"]
    d_pose = float(np.abs(poses["cuda"] - poses["cpu"]).max())
    print(f"[7 global BA] phase 5's map: chi2 {b:.6f} -> {a:.6f} (cpu {a_cpu:.6f}) card_vs_cpu_pose_max_abs="
          f"{d_pose:.3e} seconds={t:.3f} (cpu {t_cpu:.3f})")
    check(a < b, "globalOptimization did not lower the chi2")
    check(abs(a - a_cpu) <= 0.01 * a_cpu, f"card chi2 {a} not within 1% of the CPU's {a_cpu}")
    check(d_pose <= 1e-3, f"card and CPU keyframe poses differ by {d_pose} after globalOptimization")
    return dict(launches=c)


def count_launches(fn) -> int:
    """Kernel launches the host makes in one call of fn (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.key.startswith("cudaLaunchKernel"))


def marker_paths(frames: int) -> tuple[str, str]:
    """-> (checkpoint, summary) of the JAX package's run of the `markers`
    scenario over `frames` frames (make_reference_map.py --markers)."""
    name = "markers" if frames == 60 else f"markers{frames}"
    d = os.path.join(HERE, "data", "torch_port")
    return os.path.join(d, f"{name}_map.slm"), os.path.join(d, f"{name}_jax.json")


#: the marker relocalization sweep of phase 8 (c): resetTracker() before this
#: frame, and these frames' keypoints removed after extraction (the JAX
#: reference's, tools/port/make_reference_map.py)
MARKER_RESET_FRAME, MARKER_STRIP_FRAMES = 20, tuple(range(20, 25))


#: the frame of phase 9 (c), whose share of keypoints with depth the JAX
#: references record
FRONTEND_FRAME = 30


def depth_input(kind: str, seq, i: int) -> tuple:
    """The image arguments of `processStereo` (kind "stereo": the rendered
    left and right images) or `processRGBD` ("rgbd": the render and its
    z-buffer in the TUM convention, uint16(z * 5000) truncated) for frame i
    of a SyntheticSequence of either package."""
    import numpy as np

    if kind == "stereo":
        return seq.render_stereo(i)
    img, z = seq.render_with_depth(i)
    return img, np.clip(np.asarray(z) * 5000.0, 0, 65535).astype(np.uint16)


def b2_capture(stack: contextlib.ExitStack, rows: str = "marker", min_markers: int = 4) -> dict:
    """Keeps in the returned dict, while `stack` is open, the tracker's B2
    inputs of the first call with at least `min_markers` live markers among
    its corner rows (`rows` "marker"), or with depth on at least 100 valid
    rows ("depth")."""
    from ucoslam_tpu_torch.slam import tracker

    kept = {}

    def around(inner, pose0, X, uv, sig, valid, cam, depth=None, bf=None, iters=10, rounds=4):
        live = (int(valid[-64:].sum()) >= 4 * min_markers if rows == "marker"
                else depth is not None and int(((depth > 0) & valid).sum()) >= 100)
        if not kept and live:
            kept.update(tensors=[t.clone() for t in (pose0, X, uv, sig, valid)], cam=cam, iters=iters, rounds=rounds,
                        depth=None if depth is None else depth.clone(), bf=bf)
        return inner(pose0, X, uv, sig, valid, cam, depth=depth, bf=bf, iters=iters, rounds=rounds)

    stack.enter_context(patched(tracker, "motion_only_lm", around))
    return kept


def localize_sweep(map_path: str, cam, images, reloc: bool = False, capture: bool = False, kind: str = "mono") -> dict:
    """A reverse LOCALIZATION sweep of a checkpoint by UcoSlam(device="cuda"),
    each frame extracted as `kind` and fed through process_frame; with
    `reloc`, resetTracker() before MARKER_RESET_FRAME and the keypoints of
    MARKER_STRIP_FRAMES removed after extraction, so only the marker fallback
    can pose those frames; with `capture`, B2's inputs of the first track
    with 4 live markers (mono) or 100 rows with depth are kept."""
    import torch
    from ucoslam_tpu_torch import Mode
    from ucoslam_tpu_torch.api import UcoSlam

    slam = UcoSlam(device="cuda")
    slam.readFromFile(map_path, cam)
    signature = slam.getSignatureStr()
    slam.setMode(Mode.LOCALIZATION)
    poses, t_frame = {}, []
    with contextlib.ExitStack() as stack:
        calls = count_calls(stack)
        kept = b2_capture(stack, "marker" if kind == "mono" else "depth") if capture else {}
        reset_counts()
        for i in reversed(range(len(images))):
            t0 = time.perf_counter()
            if reloc and i == MARKER_RESET_FRAME:
                slam.resetTracker()
            f = extract(slam._extractor, kind, images[i], i)
            if reloc and i in MARKER_STRIP_FRAMES:
                f = f.replace(valid=torch.zeros_like(f.valid))
            pose = slam.process_frame(f)
            torch.cuda.synchronize()
            t_frame.append(1e3 * (time.perf_counter() - t0))
            if pose is not None:
                poses[i] = pose
        launches = counts()
    return dict(slam=slam, signature=signature, poses=poses, t_frame=t_frame, launches=launches, calls=calls,
                b2_args=kept or None, attempts=slam._system.tracker.n_attempts, marker_poses=slam._system.n_marker_poses,
                detects=detect_calls(slam, kind, len(images)))


def check_sweep_launches(run: dict, what: str) -> None:
    """A LOCALIZATION sweep: B1 = 2 x attempts; B2 = 2 x attempts + batched
    verifications + marker pose refines; F1 = F2 = the detector's calls."""
    n, a, mk = run["launches"], run["attempts"], run["calls"]["marker_lm"]
    check(n["B1"] == 2 * a, f"{what}: B1 launched {n['B1']} times for {a} track attempts")
    check(n["B2"] == 2 * a + n["B2_batched"] + mk,
          f"{what}: B2 launched {n['B2']} times for {a} attempts, {n['B2_batched']} batched, {mk} marker refines")
    check_detect_launches(n, run["detects"], what)


def marker_loop_on(device: str) -> dict:
    """detect_from_markers -> correct_map on the drifted ring map with
    RING_MARKER seen by keyframe 0 and the returning keyframe, on one device."""
    import numpy as np
    from ucoslam_tpu_torch.config import Params

    scene = ring_loop_scene()
    params = Params().replace(maxDescDistance=60.0, KFMinConfidence=0.4)
    m, det, slot, f = ring_loop_map(scene, params, device)
    f = add_ring_marker(m, ring_marker(scene), slot, f, det.cam)
    with contextlib.ExitStack() as stack:
        calls = count_calls(stack)
        reset_counts()
        t0 = time.perf_counter()
        info = det.detect_from_markers(m, slot, f)
        ok = info.found and det.correct_map(m, info)
        ms = 1e3 * (time.perf_counter() - t0)
        launches = counts()
    poses = m.h("kf_pose")[m.keyframes.active_slots()].copy()
    return dict(info=info, ok=ok, launches=launches, calls=calls, poses=poses, ms=ms,
                pose_err=None if not info.found else float(np.abs(info.expected_pose - scene["true_poses"][0]).max()),
                drift_before=float(np.linalg.norm(scene["drift_poses"][9] - scene["true_poses"][9])),
                drift_after=float(np.linalg.norm(poses[9] - scene["true_poses"][9])))


def b2_record(b2_args: dict, rows: str, tag: str, suffix: str) -> dict:
    """Kernel B2 against its plain version on captured tracker inputs, with
    live `rows` ("marker" corner rows, "depth" rows of a stereo / RGB-D
    frame, or "keypoint" rows of a mono frame): pose within 1e-4, the same
    mask, and its timing; the record's keys end in `suffix`."""
    import torch
    from ucoslam_tpu_torch.ops.cuda import lm_kernel

    pose0, X, uv, sig, valid = b2_args["tensors"]
    cam, depth = b2_args["cam"], b2_args["depth"]
    args = (pose0, X, uv, sig, valid, cam.fx, cam.fy, cam.cx, cam.cy)
    kw = dict(iters=b2_args["iters"], rounds=b2_args["rounds"])
    if depth is not None:
        kw.update(depth=depth, bf=b2_args["bf"], has_depth=True)

    def kernel():
        return lm_kernel.motion_only_lm_fused(*args, **kw)

    def plain():
        return lm_kernel.motion_only_lm_plain(*args, **kw)

    (pose_k, mask_k), (pose_p, mask_p) = kernel(), plain()
    torch.cuda.synchronize()
    err = float((pose_k - pose_p).abs().max())
    check(err < 1e-4, f"B2 on {rows} rows: pose differs by {err} from its plain version")
    check(torch.equal(mask_k, mask_p), f"B2 on {rows} rows: the inlier mask differs from its plain version")
    ms, plain_ms = median_ms(kernel, 50), median_ms(plain, 5)
    B = X.shape[0]
    bound_ms, bound_by = b2_bound(B, kw["iters"], kw["rounds"], int(valid.sum()), int(mask_k.sum()), depth is not None)
    if rows == "marker":
        live = int(valid[-64:].sum()) // 4
        detail = (f"live_markers={live} marker_sigma2={float(sig[-1]):.4f} (keypoint rows' median "
                  f"{float(sig[:-64][valid[:-64]].median()):.4f})")
        extra = {f"live_markers{suffix}": live}
    elif rows == "depth":
        live = int(((depth > 0) & valid).sum())
        detail = f"valid_rows={int(valid.sum())} rows_with_depth={live} bf={b2_args['bf']}"
        extra = {f"rows_with_depth{suffix}": live}
    else:  # "keypoint": a mono frame's rows, markers or none among them
        live = int(valid.sum())
        detail = f"valid_rows={live} live_markers={int(valid[-64:].sum()) // 4}"
        extra = {f"valid_rows{suffix}": live}
    print(f"[{tag}] B={B} {kw['iters']}x{kw['rounds']} {detail} pose_max_abs_err={err:.3e} masks equal "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.6f} ({bound_by})")
    return {**extra, f"max_abs_err{suffix}": err, f"ms{suffix}": ms, f"plain_ms{suffix}": plain_ms,
            f"bound_ms{suffix}": bound_ms, f"bound_by{suffix}": bound_by}


def phase_markers(frames: int, workdir: str) -> dict:
    """Phase 8 -> the kernels' launches on its main paths and B2's record on
    marker rows."""
    import numpy as np
    import torch
    from ucoslam_tpu_torch.config import Params
    from ucoslam_tpu_torch.io.serialize import load_map_meta
    from ucoslam_tpu_torch.markers import detector, native
    from ucoslam_tpu_torch.markers.ippe import ippe_square_poses
    from ucoslam_tpu_torch.optim import ba

    jax_map, jax_json = marker_paths(frames)
    ref, cam, seq, images = load_scene(jax_json)
    params = Params.from_dict(load_map_meta(jax_map)["params"])  # what the JAX package mapped with
    check(params.detectMarkers and params.aruco_markerSize == 0.6, "the marker reference's parameters")
    truth, j1 = seq.marker_poses, ref["pass1"]
    launches = dict.fromkeys(KERNEL_COUNTERS, 0)

    def add(c):
        for k in launches:
            launches[k] += c[k]

    # (a) SLAM from nothing, timed: the detector (native + IPPE), IPPE, local BA
    mk_vertices, t_detect, t_ippe = [], [], []

    def build(inner, *a, **kw):
        out = inner(*a, **kw)
        mk_vertices.append(len(out[3]))
        return out

    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(ba, "build_ba_problem", build))
        stack.enter_context(patched(detector.ArucoDetector, "detect", timing(t_detect)))
        stack.enter_context(patched(detector, "_markers_from", timing(t_ippe)))
        run = slam_pass(params, cam, images)
    slam, poses = run["slam"], run["poses"]
    add(run["launches"])
    for p in poses.values():
        check(p.shape == (4, 4) and np.isfinite(p).all(), "(a): a non-finite pose")
    ms = metric_summary(poses, seq)
    mk_id, mk_pose, mk_valid = slam.map.h("mk_id", "mk_pose", "mk_pose_valid")
    me = marker_errors(mk_id, mk_pose, mk_valid, poses, seq, truth)
    slam.map.check_consistency()
    check_slam_launches(run, "(a) pass 1")
    print(f"[8 markers] (a) pass 1: frames={len(images)} tracked={len(poses)} (jax {j1['tracked']}) metric_ate="
          f"{ms['metric_ate']:.6f} (jax {j1['metric_ate']:.6f}) horn_scale={ms['horn_scale']:.4f} (jax "
          f"{j1['horn_scale']:.4f}) markers_posed={me['markers_posed']} (jax {j1['markers_posed']}) "
          f"marker_err_mean={me['marker_err_mean']} max={me['marker_err_max']} (jax {j1['marker_err_mean']}) "
          f"keyframes={slam.map.n_keyframes} (jax {j1['keyframes']}) points={slam.map.n_points} (jax "
          f"{j1['points']}) init={run['init']} (jax {j1['init']}) metric_locked={slam._system.manager.metric_locked} "
          f"marker_fallback_poses={slam._system.n_marker_poses} loop_closures={slam._system.manager.loop_closures} "
          f"attempts={run['attempts']} insertions={run['insertions']} calls={ {k: run[k] for k in ('fusions', 'marker_lm')} } "
          f"launches={run['launches']}")
    check(len(poses) >= j1["tracked"] - 2, "(a): tracked over 2 frames fewer than the JAX package")
    check(ms["metric_ate"] <= 1.2 * j1["metric_ate"] + 0.002, f"(a): metric ATE {ms['metric_ate']} over the limit")
    check(me["markers_posed"] >= j1["markers_posed"] - 1, "(a): fewer markers with a map pose than the JAX package - 1")

    def med(ts):
        return f"{np.median(ts):.3f}" if len(ts) else "none"

    local_ba = run["steps"]["local_ba"]
    ippe_launches = count_launches(lambda: ippe_square_poses(
        torch.from_numpy(seq.frame(30, device="cpu").markers.und_corners).cuda(),
        torch.full((16,), 0.6, device="cuda"), cam))
    print(f"[8 times] ippe_device_launches_per_call={ippe_launches} (torch.profiler, one frame's 16 slots) "
          f"process_ms_median: track={med(run['t_frame']['track'])} (n={len(run['t_frame']['track'])}) "
          f"keyframe={med(run['t_frame']['keyframe'])} (n={len(run['t_frame']['keyframe'])}) "
          f"init={med(run['t_frame']['init'])}; detect_ms_median={med(t_detect)} (native + IPPE + fetch, "
          f"n={len(t_detect)}) ippe_ms_median={med(t_ippe)} (n={len(t_ippe)}); local_ba_ms_median={med(local_ba)} "
          f"(n={len(local_ba)}, marker vertices per BA problem {sorted(set(mk_vertices))}); "
          f"new_keyframe_ms_median={med(run['steps']['new_keyframe'])}; g++_s={native.build_seconds:.2f}")
    if frames != 60:
        return dict(launches=launches)
    # a second pass gives the same signature
    again = slam_pass(params, cam, images)
    add(again["launches"])
    check_slam_launches(again, "(a) pass 1 again")
    sig, sig_again = slam.getSignatureStr(), again["slam"].getSignatureStr()
    check(sig == sig_again, "(a): a second pass 1 gave another signature")
    del again
    # save, reload (the same signature), the reverse sweep
    path = os.path.join(workdir, "markers.slm")
    slam.saveToFile(path)
    rev = localize_sweep(path, cam, images, capture=True)
    add(rev["launches"])
    check_sweep_launches(rev, "(a) reverse sweep")
    check(rev["signature"] == sig, "(a): the reloaded checkpoint has another signature")
    rs = metric_summary(rev["poses"], seq)
    j2 = ref["reverse"]
    print(f"[8 markers] (a) signature={sig} again={sig_again}; reload + reverse sweep: tracked={len(rev['poses'])} "
          f"(jax pass 2 {j2['tracked']}) metric_ate={rs['metric_ate']:.6f} (jax {j2['metric_ate']:.6f}) "
          f"process_ms_median={med(rev['t_frame'])} launches={rev['launches']}")
    check(len(rev["poses"]) >= j2["tracked"] - 2, "(a): the reverse sweep tracked over 2 frames fewer than JAX's")
    check(rs["metric_ate"] <= 1.2 * j2["metric_ate"] + 0.002, f"(a): reverse-sweep metric ATE {rs['metric_ate']}")

    # (b) the JAX package's marker map, reverse sweep; (c) the same with the
    # keypoints of MARKER_STRIP_FRAMES removed and a reset
    tol = 0.02 * ref["depth_extent"]
    b2_args = rev["b2_args"]
    for name, jr in (("(b) jax map", ref["reverse"]), ("(c) marker reloc", ref["reloc"])):
        r = localize_sweep(jax_map, cam, images, reloc=name.startswith("(c)"), capture=b2_args is None)
        add(r["launches"])
        check_sweep_launches(r, name)
        b2_args = b2_args or r["b2_args"]
        jp = {int(k): np.asarray(v) for k, v in jr["poses"].items()}
        s8 = metric_summary(r["poses"], seq)
        dev = max(np.linalg.norm(camera_center(r["poses"][i]) - camera_center(jp[i]))
                  for i in r["poses"] if i in jp)
        posed = sum(i in r["poses"] for i in MARKER_STRIP_FRAMES)
        print(f"[8 markers] {name}: tracked={len(r['poses'])} (jax {jr['tracked']}) metric_ate={s8['metric_ate']:.6f} "
              f"(jax {jr['metric_ate']:.6f}) max_centre_dev={dev:.6f} (tol {tol:.6f}) stripped_frames_posed={posed} "
              f"marker_fallback_poses={r['marker_poses']} process_ms_median={med(r['t_frame'])} launches={r['launches']}")
        check(dev <= tol, f"{name}: a camera centre {dev} from JAX's (tol {tol})")
        if name.startswith("(b)"):
            check(len(r["poses"]) >= jr["tracked"], f"{name}: tracked fewer frames than the JAX package")
            check(s8["metric_ate"] <= 1.2 * jr["metric_ate"] + 0.002, f"{name}: metric ATE {s8['metric_ate']}")
        else:
            check(posed >= jr["posed_by_markers"], f"{name}: the markers posed fewer stripped frames than JAX's")

    # (d) the marker loop, on the card and on the CPU
    card, cpu = marker_loop_on("cuda"), marker_loop_on("cpu")
    add(card["launches"])
    info = card["info"]
    d_corr = float(np.abs(card["poses"] - cpu["poses"]).max())
    print(f"[8 markers] (d) ring map + marker: found={info.found} matched_kf={info.matched_kf} "
          f"n_corners={info.n_matches} expected_pose_err={card['pose_err']} corrected={card['ok']} drift "
          f"{card['drift_before']:.4f} -> {card['drift_after']:.4f} (cpu {cpu['drift_after']:.4f}) "
          f"card_vs_cpu_pose_max_abs={d_corr:.3e} ms={card['ms']:.3f} launches={card['launches']} calls={card['calls']}")
    check(info.found and info.matched_kf == 0, "(d): the marker loop was not found against keyframe 0")
    check(card["ok"] and card["drift_after"] < card["drift_before"], "(d): the correction did not lower the drift")
    check(d_corr <= 1e-3, f"(d): card and CPU keyframe poses differ by {d_corr} after the correction")
    c = card["launches"]
    check(c["B2"] == card["calls"]["marker_lm"] == 1 and c["B2_batched"] == 0, f"(d): B2 launches {c}")
    check(c["B1"] == card["calls"]["fusions"] > 0, f"(d): B1 launched {c['B1']} times for the seam fusions")

    # (e) B2 on a phase-8 frame's marker rows
    check(b2_args is not None, "(e): no phase-8 frame had 4 live markers in the tracker's rows")
    return dict(launches=launches, b2=b2_record(b2_args, "marker", "8 B2 marker rows", "_marker_rows"))


def depth_paths(kind: str, frames: int) -> tuple[str, str]:
    """-> (checkpoint, summary) of the JAX package's run of the `stereo` or
    `rgbd` scenario over `frames` frames (make_reference_map.py --stereo /
    --rgbd)."""
    name = kind if frames == 60 else f"{kind}{frames}"
    d = os.path.join(HERE, "data", "torch_port")
    return os.path.join(d, f"{name}_map.slm"), os.path.join(d, f"{name}_jax.json")


def frontend_on_shared_arrays(kind: str, params, cam, inputs, card: str = "cuda") -> dict:
    """Phase 9 (c): the frame's depth from `process_stereo` / `process_rgbd`
    on the `card` device and on the CPU, both given the CPU's base frame
    (and, for stereo, the CPU's right-image keypoints) -> the keypoints with
    depth on each side, the relative depth difference where both have one,
    and the card frontend's own share of keypoints with depth and its device
    launches."""
    import dataclasses

    import numpy as np
    import torch
    from ucoslam_tpu_torch.features.frame_extractor import FrameExtractor

    def on(device, obj):
        return dataclasses.replace(obj, **{f.name: getattr(obj, f.name).to(device) for f in dataclasses.fields(obj)
                                           if isinstance(getattr(obj, f.name), torch.Tensor)})

    x = inputs[FRONTEND_FRAME]
    cpu = FrameExtractor(params, cam, "cpu")
    base, gray = cpu._base_frame(x[0], FRONTEND_FRAME)
    right = cpu.orb.detect_and_compute(cpu._gray(x[1])) if kind == "stereo" else None
    depth = []
    for device in ("cpu", card):
        ext = FrameExtractor(params, cam, device)
        ext._base_frame = lambda img, fseq, d=device: (on(d, base), gray.to(d))
        if right is not None:
            ext.orb.detect_and_compute = lambda g, d=device: on(d, right)
        depth.append(extract(ext, kind, x, FRONTEND_FRAME).depth.cpu().numpy())
    a, b = depth[0] > 0, depth[1] > 0
    both = a & b
    rel = float((np.abs(depth[1][both] - depth[0][both]) / depth[0][both]).max()) if both.any() else 0.0
    ext = FrameExtractor(params, cam, card)
    f = extract(ext, kind, x, FRONTEND_FRAME)
    valid, d = f.valid.cpu().numpy(), f.depth.cpu().numpy()
    launches = count_launches(lambda: extract(ext, kind, x, FRONTEND_FRAME))
    return dict(cpu=int(a.sum()), card=int(b.sum()), differ=int((a ^ b).sum()), max_rel=rel,
                share=float((valid & (d > 0)).sum() / max(valid.sum(), 1)), launches=launches)


def phase_depth(kind: str, frames: int, workdir: str) -> dict:
    """Phase 9 for one kind ("stereo" or "rgbd") -> the kernels' launches on
    its main paths and B2's record on its depth rows."""
    import numpy as np
    from ucoslam_tpu_torch.config import Params
    from ucoslam_tpu_torch.features import frame_extractor
    from ucoslam_tpu_torch.io.serialize import load_map_meta

    tag = f"9 {kind}"
    jax_map, jax_json = depth_paths(kind, frames)
    ref, cam, seq, inputs = load_scene(jax_json, kind)
    params = Params.from_dict(load_map_meta(jax_map)["params"])  # what the JAX package mapped with
    check(cam.bl == 0.25 and not params.detectMarkers, f"({kind}) the reference's camera and parameters")
    j1 = ref["pass1"]
    launches = dict.fromkeys(KERNEL_COUNTERS, 0)

    def add(c):
        for k in launches:
            launches[k] += c[k]

    def med(ts):
        return f"{np.median(ts):.3f}" if len(ts) else "none"

    # (a) SLAM from nothing; the depth step timed (stereo: row matching and
    # SAD refinement; RGB-D: the depth image's sampling)
    t_step = []
    step = "stereo_depth" if kind == "stereo" else "bilinear_sample"
    with patched(frame_extractor, step, timing(t_step)):
        run = slam_pass(params, cam, inputs, kind)
    slam, poses = run["slam"], run["poses"]
    add(run["launches"])
    for p in poses.values():
        check(p.shape == (4, 4) and np.isfinite(p).all(), f"({kind} a): a non-finite pose")
    ms = metric_summary(poses, seq)
    slam.map.check_consistency()
    check_slam_launches(run, f"({kind} a) pass 1")
    print(f"[{tag}] (a) pass 1: frames={len(inputs)} tracked={len(poses)} (jax {j1['tracked']}) metric_ate="
          f"{ms['metric_ate']:.6f} (jax {j1['metric_ate']:.6f}) horn_scale={ms['horn_scale']:.4f} (jax "
          f"{j1['horn_scale']:.4f}) keyframes={slam.map.n_keyframes} (jax {j1['keyframes']}) points="
          f"{slam.map.n_points} (jax {j1['points']}) init={run['init']} (jax {j1['init']}) "
          f"metric_locked={slam._system.manager.metric_locked} loop_closures={slam._system.manager.loop_closures} "
          f"attempts={run['attempts']} insertions={run['insertions']} fusions={run['fusions']} "
          f"launches={run['launches']}")
    check(run["init"] == dict(kind="depth", frame=j1["init"]["frame"]) and j1["init"]["keyframes"] == 1,
          f"({kind} a): init {run['init']}, the JAX package's {j1['init']}")
    check(len(poses) >= j1["tracked"] - 2, f"({kind} a): tracked over 2 frames fewer than the JAX package")
    check(ms["metric_ate"] <= 1.2 * j1["metric_ate"] + 0.002, f"({kind} a): metric ATE {ms['metric_ate']} over the limit")
    steps = run["steps"]
    print(f"[{tag} times] process_ms_median: track={med(run['t_frame']['track'])} (n={len(run['t_frame']['track'])}) "
          f"keyframe={med(run['t_frame']['keyframe'])} (n={len(run['t_frame']['keyframe'])}) "
          f"init={med(run['t_frame']['init'])}; {step}_ms_median={med(t_step)} (n={len(t_step)}); "
          f"new_keyframe_ms_median={med(steps['new_keyframe'])}: epipolar={med(steps['epipolar'])} "
          f"fuse={med(steps['fuse'])} local_ba={med(steps['local_ba'])} (n={len(steps['local_ba'])})")
    if frames != 60:
        return dict(launches=launches)
    # a second pass gives the same signature
    again = slam_pass(params, cam, inputs, kind)
    add(again["launches"])
    check_slam_launches(again, f"({kind} a) pass 1 again")
    sig, sig_again = slam.getSignatureStr(), again["slam"].getSignatureStr()
    check(sig == sig_again, f"({kind} a): a second pass 1 gave another signature")
    del again
    # save, reload (the same signature), the reverse sweep; B2's inputs kept
    path = os.path.join(workdir, f"{kind}.slm")
    slam.saveToFile(path)
    rev = localize_sweep(path, cam, inputs, capture=True, kind=kind)
    add(rev["launches"])
    check_sweep_launches(rev, f"({kind} a) reverse sweep")
    check(rev["signature"] == sig, f"({kind} a): the reloaded checkpoint has another signature")
    rs = metric_summary(rev["poses"], seq)
    j2 = ref["reverse"]
    print(f"[{tag}] (a) signature={sig} again={sig_again}; reload + reverse sweep: tracked={len(rev['poses'])} "
          f"(jax pass 2 {j2['tracked']}) metric_ate={rs['metric_ate']:.6f} (jax {j2['metric_ate']:.6f}) "
          f"process_ms_median={med(rev['t_frame'])} launches={rev['launches']}")
    check(len(rev["poses"]) >= j2["tracked"] - 2, f"({kind} a): the reverse sweep tracked over 2 frames fewer than JAX's")
    check(rs["metric_ate"] <= 1.2 * j2["metric_ate"] + 0.002, f"({kind} a): reverse-sweep metric ATE {rs['metric_ate']}")

    # (b) the JAX package's map, reverse sweep
    r = localize_sweep(jax_map, cam, inputs, kind=kind)
    add(r["launches"])
    check_sweep_launches(r, f"({kind} b)")
    jp = {int(k): np.asarray(v) for k, v in j2["poses"].items()}
    sb = metric_summary(r["poses"], seq)
    tol = 0.02 * ref["depth_extent"]
    dev = max(np.linalg.norm(camera_center(r["poses"][i]) - camera_center(jp[i])) for i in r["poses"] if i in jp)
    print(f"[{tag}] (b) jax map: tracked={len(r['poses'])} (jax {j2['tracked']}) metric_ate={sb['metric_ate']:.6f} "
          f"(jax {j2['metric_ate']:.6f}) max_centre_dev={dev:.6f} (tol {tol:.6f}) "
          f"process_ms_median={med(r['t_frame'])} launches={r['launches']}")
    check(len(r["poses"]) >= j2["tracked"], f"({kind} b): tracked fewer frames than the JAX package")
    check(sb["metric_ate"] <= 1.2 * j2["metric_ate"] + 0.002, f"({kind} b): metric ATE {sb['metric_ate']}")
    check(dev <= tol, f"({kind} b): a camera centre {dev} from JAX's (tol {tol})")

    # (c) the frontend on one frame, card against CPU on the same arrays
    c = frontend_on_shared_arrays(kind, params, cam, inputs)
    jf = ref["frontend"]
    print(f"[{tag}] (c) frame {FRONTEND_FRAME} on shared arrays: with_depth cpu={c['cpu']} card={c['card']} "
          f"differ={c['differ']} max_rel_depth_diff={c['max_rel']:.3e}; card frontend share_with_depth="
          f"{c['share']:.4f} (jax {jf['share']:.4f}) device_launches_per_frame={c['launches']} (torch.profiler)")
    check(c["cpu"] > 100 and c["differ"] <= 0.01 * c["cpu"], f"({kind} c): keypoints with depth differ: {c}")
    check(c["max_rel"] <= 1e-4, f"({kind} c): depth differs by {c['max_rel']} relative")

    # (d) B2 on a tracked frame's own inputs, depth rows live
    check(rev["b2_args"] is not None, f"({kind} d): no tracked frame had 100 rows with depth")
    b2 = b2_record(rev["b2_args"], "depth", f"{tag} (d) B2 depth rows", f"_{kind}_rows")
    return dict(launches=launches, b2=b2)


#: phase 10: the JAX package's mono map built with data/vocab.fbow, its sweep
#: with resetTracker() at phase 6's frames, and the vocabulary's digest
#: (tools/port/make_reference_map.py --voc auto)
VOC_MAP_PATH = os.path.join(HERE, "data", "torch_port", "mono_voc_map.slm")
VOC_REF_PATHS = tuple(os.path.join(HERE, "data", "torch_port", n) for n in ("mono_voc_reloc_jax.json", "vocab_jax.npz"))


def vocab_sha256(v) -> str:
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for a in (v.desc, v.weight, v.word_id):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def phase_vocabulary(scene, workdir: str) -> dict:
    """Phase 10 -> the kernels' launches on its main path, and the word
    search's record."""
    import numpy as np
    import torch
    from ucoslam_tpu_torch.api import UcoSlam
    from ucoslam_tpu_torch.config import Params
    from ucoslam_tpu_torch.features.frame_extractor import FrameExtractor
    from ucoslam_tpu_torch.io.fbow import default_vocab_path, load_fbow
    from ucoslam_tpu_torch.io.serialize import load_map_meta
    from ucoslam_tpu_torch.mapping.frame import tensor_from_numpy
    from ucoslam_tpu_torch.mapping.kfdatabase import quantize_words

    ref, cam, seq, images = scene
    reloc_path, digest_path = VOC_REF_PATHS
    with open(reloc_path) as f:
        jax_reloc = json.load(f)
    jax = np.load(digest_path)
    v = load_fbow(default_vocab_path())
    sha = vocab_sha256(v)
    print(f"[10 vocab] {default_vocab_path()}: words={len(v.desc)} (jax {int(jax['n_words'])}) k={v.k} "
          f"(jax {int(jax['k'])}) sha256={sha[:16]} (jax {str(jax['sha256'])[:16]})")
    check(len(v.desc) == int(jax["n_words"]) == 16384 and v.k == int(jax["k"]) and sha == str(jax["sha256"]),
          "the vocabulary differs from the JAX package's")
    vocab_card, vocab_cpu = tensor_from_numpy(v.desc, "cuda"), tensor_from_numpy(v.desc, "cpu")
    # the JAX frontend's frame-30 descriptors: card, CPU and JAX's word ids
    desc_j = jax["desc"]
    w_card = quantize_words(tensor_from_numpy(desc_j, "cuda"), vocab_card).cpu().numpy()
    w_cpu = quantize_words(tensor_from_numpy(desc_j, "cpu"), vocab_cpu).numpy()
    # the port's own frontend on frame 30, card and CPU on the same descriptors
    params = Params.from_dict(load_map_meta(VOC_MAP_PATH)["params"])
    f = FrameExtractor(params, cam, "cuda").process(images[FRONTEND_FRAME], FRONTEND_FRAME)
    own_card = quantize_words(f.desc, vocab_card).cpu().numpy()
    own_cpu = quantize_words(f.desc.cpu(), vocab_cpu).numpy()
    ms = median_ms(lambda: quantize_words(f.desc, vocab_card), 20)
    launches = count_launches(lambda: quantize_words(f.desc, vocab_card))
    n = f.desc.shape[0]
    # bytes: descriptors and centroids read once, ids written; operations per
    # (descriptor, word) pair as B1's inside its gate: 8 XOR, 7 adds and the
    # minimum's compare at the issue rate, and 8 popcounts
    pairs = n * len(v.desc)
    bound_ms, bound_by = bound_of(32 * (n + len(v.desc)) + 8 * n, 16 * pairs / ISSUE_PER_S + 8 * pairs / POPC_PER_S)
    print(f"[10 vocab] quantize_words at frame {FRONTEND_FRAME}'s {n} descriptors x {len(v.desc)} words: "
          f"JAX's descriptors card==cpu {np.array_equal(w_card, w_cpu)} ==jax {np.array_equal(w_card, jax['words'])}; "
          f"the port's own card==cpu {np.array_equal(own_card, own_cpu)}; ms={ms:.4f} launches={launches} "
          f"bound_ms={bound_ms:.6f} ({bound_by})")
    check(np.array_equal(w_card, w_cpu) and np.array_equal(w_card, jax["words"]),
          "word ids of JAX's frame-30 descriptors differ (card, CPU, JAX)")
    check(np.array_equal(own_card, own_cpu), "the port's frame-30 word ids differ on card and CPU")

    # the JAX vocabulary map's sweep with resetTracker() at phase 6's frames
    r = reloc_sweep(scene, False, map_path=VOC_MAP_PATH, jax_ref=jax_reloc, tag="10 vocab sweep")
    slam = r.pop("slam")
    kfdb = slam._system.manager.kfdb
    check(kfdb.vocab.shape[0] == 16384 and not kfdb.dummy, "the checkpoint's vocabulary was not restored")
    sig = slam.getSignatureStr()
    path = os.path.join(workdir, "voc_map.slm")
    slam.saveToFile(path)
    back = UcoSlam(device="cuda")
    back.readFromFile(path, cam)
    same = torch.equal(back._system.manager.kfdb.vocab, kfdb.vocab) and torch.equal(
        back._system.manager.kfdb.weights, kfdb.weights)
    print(f"[10 vocab] saveToFile/readFromFile: vocabulary kept {same} signature {sig} again {back.getSignatureStr()}")
    check(same and back.getSignatureStr() == sig, "the checkpoint lost the vocabulary or the signature")
    return dict(launches=r["launches"], quantize=dict(ms=ms, launches=launches, bound_ms=bound_ms, n=n))


#: phase 11: JAX's global BA of ba_scale_problem (tools/port/ba_reference.py)
BA_REF_PATHS = tuple(os.path.join(HERE, "data", "torch_port", n) for n in ("ba128_jax.json", "ba128_jax.npz"))


def ba_ms_per_iteration(problem, cam, solver: str) -> tuple[float, object]:
    """bench.py's `_ba_iter_time`: (t(24) - t(6)) / 18 of one-stage solves,
    each ended by a device synchronize, after a warm-up of each (the
    point-major tables are built once and cached). -> (ms, the 24-step result)."""
    import torch
    from ucoslam_tpu_torch.optim.ba import ba_solve

    def run(iters):
        t0 = time.perf_counter()
        r = ba_solve(problem, cam, iters=iters, stages=1, solver=solver)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, r

    run(6), run(24)
    (t_lo, _), (t_hi, r) = run(6), run(24)
    return 1e3 * (t_hi - t_lo) / 18, r


def ring_ba_on(device: str, workdir: str, nudge: int | None = None) -> dict:
    """The drifted ring map of ring_loop_scene(n_kf=128), saved, read back by
    UcoSlam and globally optimized, on one device; with `nudge`, the scene's
    points first moved in their last bits (relative normal noise of 1e-7,
    seeded by `nudge`)."""
    import numpy as np
    import torch
    from ucoslam_tpu_torch.api import UcoSlam
    from ucoslam_tpu_torch.config import Params
    from ucoslam_tpu_torch.io.serialize import save_map

    params = Params().replace(maxDescDistance=60.0, detectMarkers=False, KFMinConfidence=0.4)
    scene = ring_loop_scene(n_kf=128)
    if nudge is not None:
        noise = 1e-7 * np.random.default_rng(nudge).normal(size=scene["pts"].shape)
        scene["pts"] = (scene["pts"] * (1 + noise)).astype(scene["pts"].dtype)
    m, det, _, _ = ring_loop_map(scene, params, device)
    path = os.path.join(workdir, f"ring128_{device}.slm")
    save_map(m, path)
    slam = UcoSlam(device=device)
    slam.readFromFile(path, det.cam)
    before = slam.map.global_reproj_chi2(det.cam)
    t0 = time.perf_counter()
    slam.globalOptimization()
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return dict(before=before, after=slam.map.global_reproj_chi2(det.cam), seconds=seconds,
                poses=slam.map.h("kf_pose")[slam.map.keyframes.active_slots()].copy(), n_kf=slam.map.n_keyframes)


def ring_gap(a: dict, b: dict) -> dict:
    """Two ring_ba_on results apart: chi2, the largest keyframe-pose entry
    and the largest rotation entry."""
    import numpy as np

    return dict(chi2=abs(a["after"] - b["after"]), pose=float(np.abs(a["poses"] - b["poses"]).max()),
                rotation=float(np.abs(a["poses"][:, :3, :3] - b["poses"][:, :3, :3]).max()))


def phase_ba_scale(workdir: str) -> dict:
    """Phase 11: global BA at 128 and 512 keyframes, point-major, CG and
    dense, and globalOptimization on a 128-keyframe map.

    Bundle adjustment of these problems is ill-conditioned: one fixed
    camera leaves the scale free, and the reference's own routes end 8% apart
    in scale and 40 map units apart in the worst point. So the solutions are
    held in measures the gauge cannot swamp (ba_gap), each within twice the
    widest gap between the reference's routes; the final cost within 1% of
    the reference's cost reduction above its "auto" solve, and no lower than
    1% of it below its lowest route. The port's own solve cut to half its LM
    steps is a control that these gates must reject. On the ring map, card
    and CPU poses are held to twice the spread that last-bit nudges of the
    start give on the CPU, and their chi2 within 1%."""
    import numpy as np
    import torch
    from ucoslam_tpu_torch.optim import schur_pm
    from ucoslam_tpu_torch.optim.ba import ba_solve

    with open(BA_REF_PATHS[0]) as f:
        jax_ref = json.load(f)
    jax_out = np.load(BA_REF_PATHS[1])
    spread = {pair: {k: v for k, v in gap.items() if k != "cost"} for pair, gap in jax_ref["spread"].items()}
    c0, jc = jax_ref["cost_history"][0], jax_ref["cost_history"][-1]
    cost_band = (min([jc] + [g["cost"] for g in jax_ref["spread"].values()]) - 0.01 * (c0 - jc), jc + 0.01 * (c0 - jc))
    out = {}
    with contextlib.ExitStack() as stack:
        routes = []
        stack.enter_context(patched(schur_pm, "pm_staged_lm", lambda inner, *a, **k: routes.append(1) or inner(*a, **k)))

        def judge(r, arrays, ref, band):
            """-> (ba_gap of r from ref, final cost, the failed gates)."""
            gap = ba_gap((r.cam_pose.cpu().numpy(), r.pt_pos.cpu().numpy()), ref, arrays)
            cost = float(r.cost_history[-1])
            return gap, cost, ba_gap_failures(gap, spread) + ([] if band[0] <= cost <= band[1] else ["cost"])

        # (a) 128 keyframes x 16384 points x 131072 observations
        arrays = ba_scale_problem(128, 16384, 8)
        problem, cam = ba_problem_on(arrays, "cuda")
        ms_pm, r = ba_ms_per_iteration(problem, cam, "auto")
        costs = r.cost_history.cpu().numpy()
        jax_sol = (jax_out["cam_pose"], jax_out["pt_pos"])
        gap, cost, failed = judge(r, arrays, jax_sol, cost_band)
        limits = {k: 2 * max(pair[k] for pair in spread.values()) for k in gap}
        print(f"[11 ba] (a) 128x16384x131072 auto: point-major solves={len(routes)} cost {costs[0]:.3f} -> {cost:.3f} "
              f"(jax {jc:.3f}; band {cost_band[0]:.3f} .. {cost_band[1]:.3f}) vs jax {json.dumps(gap)} (limits "
              f"{json.dumps(limits)}) ms_per_lm_iter={ms_pm:.3f}")
        check(len(routes) == 4, f"the 128-keyframe problem took the point-major route {len(routes)} of 4 times")
        check(bool(np.all(np.diff(costs) <= 0)), "the point-major cost rose")
        check(not failed, f"the 128-keyframe solve fails {failed} against the JAX package's")
        # the control: the same solve cut to half its LM steps must fail the gates
        half = ba_solve(problem, cam, iters=len(costs) // 2, stages=1, solver="auto")
        c_gap, c_cost, c_failed = judge(half, arrays, jax_sol, cost_band)
        print(f"[11 ba] (a) control, {len(costs) // 2} LM steps: cost {c_cost:.3f} vs jax {json.dumps(c_gap)} "
              f"rejected by {c_failed}")
        check(bool(c_failed), "the gates passed the solve cut to half its LM steps")
        # (c) solver="cg" and the dense solve of the same problem
        n_pm = len(routes)
        ms_cg, rc = ba_ms_per_iteration(problem, cam, "cg")
        ms_dense, rd = ba_ms_per_iteration(problem, cam, "dense")
        dense_cost = float(rd.cost_history[-1])
        dense_band = (dense_cost - 0.01 * (c0 - dense_cost), dense_cost + 0.01 * (c0 - dense_cost))
        gap_c, cg_cost, failed_c = judge(rc, arrays, (rd.cam_pose.cpu().numpy(), rd.pt_pos.cpu().numpy()), dense_band)
        print(f"[11 ba] (c) cg vs dense at 128: cost {cg_cost:.3f} vs {dense_cost:.3f} gap {json.dumps(gap_c)} (limits "
              f"{json.dumps(limits)}) ms_per_lm_iter point-major={ms_pm:.3f} cg={ms_cg:.3f} dense={ms_dense:.3f}")
        check(len(routes) == n_pm, "solver='cg' or 'dense' took the point-major route")
        check(not failed_c, f"CG and dense part past the reference's routes: {failed_c}")
        out["ba128"] = dict(point_major=ms_pm, cg=ms_cg, dense=ms_dense)
        del problem, r, rc, rd, half
        # (b) 512 keyframes x 65536 points x 524288 observations
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        problem, cam = ba_problem_on(ba_scale_problem(512, 65536, 8), "cuda")
        n_pm = len(routes)
        ms_512, r = ba_ms_per_iteration(problem, cam, "auto")
        costs = r.cost_history.cpu().numpy()
        peak = torch.cuda.max_memory_allocated() / 2**30
        total = torch.cuda.get_device_properties(0).total_memory / 2**30
        print(f"[11 ba] (b) 512x65536x524288 auto: point-major solves={len(routes) - n_pm} cost {costs[0]:.3f} -> "
              f"{costs[-1]:.3f} ms_per_lm_iter={ms_512:.3f} peak_memory_gib={peak:.3f} of {total:.1f}")
        check(len(routes) - n_pm == 4, "the 512-keyframe problem did not take the point-major route")
        check(costs[-1] < costs[0] and np.isfinite(costs).all(), "the 512-keyframe cost did not fall")
        out["ba512"] = dict(point_major=ms_512, peak_gib=peak)
        # the other two routes at 512, timed beside it (which route is fastest on this card)
        for solver in ("cg", "dense"):
            del r
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ms, r = ba_ms_per_iteration(problem, cam, solver)
            costs = r.cost_history.cpu().numpy()
            peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"[11 ba] (b) 512x65536x524288 {solver}: cost {costs[0]:.3f} -> {costs[-1]:.3f} ms_per_lm_iter={ms:.3f} "
                  f"peak_memory_gib={peak:.3f}")
            check(costs[-1] < costs[0] and np.isfinite(costs).all(), f"the 512-keyframe {solver} cost did not fall")
            out["ba512"].update({solver: ms, f"{solver}_peak_gib": peak})
        del problem, r
        torch.cuda.empty_cache()
        # (d) globalOptimization on the 128-keyframe ring map, card and CPU, and
        # the CPU's own spread under two last-bit nudges of the start
        n_pm = len(routes)
        card = ring_ba_on("cuda", workdir)
        check(len(routes) - n_pm == 1, "globalOptimization of the ring map did not take the point-major route")
        cpu = ring_ba_on("cpu", workdir)
        nudged = [ring_gap(ring_ba_on("cpu", workdir, nudge=seed), cpu) for seed in (0, 1)]
        d_ring = ring_gap(card, cpu)
        ring_limits = {k: 2 * max(g[k] for g in nudged) for k in ("pose", "rotation")}
        ring_limits["chi2"] = 0.01 * cpu["after"]
        jax_chi2 = jax_ref["ring128"]["chi2"]
        print(f"[11 ba] (d) ring map of {card['n_kf']} keyframes: globalOptimization chi2 {card['before']:.6f} -> "
              f"{card['after']:.6f} (cpu {cpu['after']:.6f}; jax by route {json.dumps(jax_chi2)}) card vs cpu "
              f"{json.dumps(d_ring)} (limits {json.dumps(ring_limits)}; the nudges' {json.dumps(nudged)}) "
              f"seconds={card['seconds']:.3f} (cpu {cpu['seconds']:.3f})")
        check(card["after"] < card["before"], "the ring map's chi2 did not fall")
        check(card["after"] <= max(jax_chi2.values()), "the ring map's chi2 ends above every route of the reference's")
        check(all(d_ring[k] <= ring_limits[k] for k in d_ring), f"card and CPU ring results part past {ring_limits}: {d_ring}")
    out["ring_s"] = card["seconds"]
    return out


#: phase 12: the JAX package's sequential, drained and free async passes of
#: the 60-frame mono scene (tools/port/make_reference_map.py --async-trials 3)
ASYNC_REF_PATH = os.path.join(HERE, "data", "torch_port", "mono_async_jax.json")


def async_pass(params, cam, images, drained: bool = False) -> dict:
    """A SLAM pass of UcoSlam(device="cuda") over the images, each `process`
    timed on the host clock (the pose it returns was fetched, so its work
    is done; no extra synchronize, which would wait for the worker's work
    too), the frames that inserted a keyframe inline apart; with `drained`,
    a `waitForFinished()` after every frame."""
    from ucoslam_tpu_torch.api import UcoSlam

    slam = UcoSlam(device="cuda")
    slam.setParams(None, params, cam)
    mgr = slam._system.manager
    poses, t_track, t_kf = {}, [], []
    with contextlib.ExitStack() as stack:
        calls = count_calls(stack)
        reset_counts()
        for i, img in enumerate(images):
            before, inserted = slam.map.n_keyframes, mgr.n_insertions
            t0 = time.perf_counter()
            pose = slam.process(img, fseq=i)
            ms = 1e3 * (time.perf_counter() - t0)
            if before > 0:
                (t_kf if not mgr.is_async and mgr.n_insertions > inserted else t_track).append(ms)
            if pose is not None:
                poses[i] = pose
            if drained:
                slam.waitForFinished()
        slam.waitForFinished()
        launches = counts()
    return dict(slam=slam, poses=poses, t_track=t_track, t_kf=t_kf, launches=launches,
                attempts=slam._system.tracker.n_attempts, insertions=mgr.n_insertions,
                detects=detect_calls(slam, "mono", len(images)), **calls)


def lost_after_init(tracked: int, init_frame: int, n_frames: int) -> int:
    return n_frames - init_frame - tracked


def phase_async(scene) -> dict:
    """Phase 12 -> the kernels' launches on its main path, and the times."""
    import numpy as np
    from ucoslam_tpu_torch.config import Params
    from ucoslam_tpu_torch.io.serialize import load_map_meta

    ref, cam, seq, images = scene
    with open(ASYNC_REF_PATH) as f:
        jax_ref = json.load(f)
    n = len(images)
    params = Params.from_dict(load_map_meta(MAP_PATH)["params"])
    pct = lambda ts, q: float(np.percentile(ts, q))
    seq_run = async_pass(params, cam, images)
    check_slam_launches(seq_run, "sequential")
    launches = dict(seq_run["launches"])
    print(f"[12 async] sequential: tracked={len(seq_run['poses'])} ate={ate_of(seq_run['poses'], seq):.6f} keyframes="
          f"{seq_run['slam'].map.n_keyframes} points={seq_run['slam'].map.n_points} (jax {json.dumps(jax_ref['sequential'])}) "
          f"process_ms tracking p50={pct(seq_run['t_track'], 50):.3f} "
          f"p99={pct(seq_run['t_track'], 99):.3f} (n={len(seq_run['t_track'])}) keyframe p50="
          f"{pct(seq_run['t_kf'], 50):.3f} (n={len(seq_run['t_kf'])}) all p50="
          f"{pct(seq_run['t_track'] + seq_run['t_kf'], 50):.3f} p99={pct(seq_run['t_track'] + seq_run['t_kf'], 99):.3f}")
    seq_run["slam"].clear()
    params_async = params.replace(runSequential=False)
    # the drained pass against JAX's drained pass
    run = async_pass(params_async, cam, images, drained=True)
    check_slam_launches(run, "drained async")
    launches = {k: c + run["launches"][k] for k, c in launches.items()}
    jd, slam = jax_ref["drained"], run["slam"]
    ate = ate_of(run["poses"], seq)
    print(f"[12 async] drained: tracked={len(run['poses'])} ate={ate:.6f} keyframes={slam.map.n_keyframes} points="
          f"{slam.map.n_points} insertions={run['insertions']} (jax {json.dumps(jd)})")
    check(slam._system.manager.is_async, "runSequential=False did not start the worker")
    check(len(run["poses"]) >= jd["tracked"] - 2, "the drained pass tracked over 2 frames fewer than JAX's")
    check(ate <= 1.2 * jd["ate"] + 0.002, f"the drained pass's ATE {ate} over the limit")
    check(abs(slam.map.n_keyframes - jd["keyframes"]) <= 1, "the drained pass's keyframes part from JAX's")
    check(abs(slam.map.n_points - jd["points"]) <= 0.1 * jd["points"], "the drained pass's points part from JAX's")
    slam.map.check_consistency()
    slam.clear()
    # three free passes: the ATE bound from JAX's sequential pass; the map
    # against JAX's free async passes (a keyframe waits for an idle worker,
    # so the port's worker keeps pace as JAX's does on the CPU)
    bound = 1.5 * jax_ref["sequential"]["ate"] + 0.01
    free = jax_ref["trials"]
    lost = max(lost_after_init(r["tracked"], r["init_frame"], n) for r in free)
    kf_range = (min(r["keyframes"] for r in free) - 1, max(r["keyframes"] for r in free) + 1)
    ppk_range = (0.8 * min(r["points"] / r["keyframes"] for r in free), 1.2 * max(r["points"] / r["keyframes"] for r in free))
    print(f"[12 async] jax free async passes: {json.dumps(free)}")
    t_all = []
    for trial in range(3):
        run = async_pass(params_async, cam, images)
        slam, mgr = run["slam"], run["slam"]._system.manager
        check(mgr.is_async, "runSequential=False did not start the worker")
        check_slam_launches(run, f"async trial {trial}")
        launches = {k: c + run["launches"][k] for k, c in launches.items()}
        ate = ate_of(run["poses"], seq)
        t_all += run["t_track"]
        lost_here = lost_after_init(len(run["poses"]), min(run["poses"]), n)
        print(f"[12 async] trial {trial}: tracked={len(run['poses'])} lost_after_init={lost_here} (jax <= {lost}) "
              f"ate={ate:.6f} (bound {bound:.6f}) keyframes={slam.map.n_keyframes} points={slam.map.n_points} "
              f"busy={mgr.busy()} insertions={run['insertions']} process_ms p50={pct(run['t_track'], 50):.3f} "
              f"p99={pct(run['t_track'], 99):.3f} launches={run['launches']}")
        check(len(run["poses"]) >= 0.85 * (n - 2), f"async trial {trial} tracked {len(run['poses'])}")
        check(lost_here <= lost, f"async trial {trial} lost {lost_here} frames after its init")
        check(ate < bound, f"async trial {trial}: ATE {ate} over {bound}")
        check(not mgr.busy() and slam.map.n_keyframes >= 3 and slam.map.n_points > 100,
              f"async trial {trial}: after waitForFinished busy={mgr.busy()} keyframes={slam.map.n_keyframes}")
        check(kf_range[0] <= slam.map.n_keyframes <= kf_range[1],
              f"async trial {trial}: {slam.map.n_keyframes} keyframes, JAX's free passes {kf_range}")
        check(ppk_range[0] <= slam.map.n_points / slam.map.n_keyframes <= ppk_range[1],
              f"async trial {trial}: {slam.map.n_points} points on {slam.map.n_keyframes} keyframes, JAX's free "
              f"passes {ppk_range[0]:.1f} .. {ppk_range[1]:.1f} a keyframe")
        slam.map.check_consistency()
        if trial == 2:
            # a worker error is raised by waitForFinished; globalOptimization drains first
            mgr._worker_error = RuntimeError("planted")
            try:
                slam.waitForFinished()
                raised = False
            except RuntimeError as e:
                raised = str(e) == "planted"
            order = []
            with patched(mgr, "wait_idle", lambda inner: order.append("drain") or inner()):
                from ucoslam_tpu_torch import api

                with patched(api, "global_bundle_adjustment", lambda inner, *a, **k: order.append("ba") or inner(*a, **k)):
                    slam.globalOptimization(n_iters=10)
            print(f"[12 async] a planted worker error raised: {raised}; globalOptimization order {order}")
            check(raised, "a worker error was not raised by waitForFinished")
            check(order == ["drain", "ba"], f"globalOptimization did not drain the worker first: {order}")
        slam.clear()
    print(f"[12 async] process_ms over 3 trials: p50={pct(t_all, 50):.3f} p99={pct(t_all, 99):.3f} (n={len(t_all)}); "
          f"sequential tracking frames p50={pct(seq_run['t_track'], 50):.3f} p99={pct(seq_run['t_track'], 99):.3f}")
    return dict(launches=launches, ms=dict(
        async_p50=pct(t_all, 50), async_p99=pct(t_all, 99),
        seq_track_p50=pct(seq_run["t_track"], 50), seq_track_p99=pct(seq_run["t_track"], 99),
        seq_all_p50=pct(seq_run["t_track"] + seq_run["t_kf"], 50), seq_all_p99=pct(seq_run["t_track"] + seq_run["t_kf"], 99)))


#: phase 13: the JAX package's harness on the parity scenarios' PNG trees
#: (tools/port/harness_reference.py), keyed by frame count, then scenario
HARNESS_REF_PATH = os.path.join(HERE, "data", "torch_port", "harness_jax.json")
#: the trees phase 13 drives the port's harness on
HARNESS_TREES = ("mono", "rgbd", "stereo")
#: the 0.25 m rig of run_parity.py's `stereo` and `rgbd` scenes
RIG_CAMERA = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480, bl=0.25)
#: processes rendering a tree's frames (the card's host has 8 cores)
RENDER_JOBS = 6


def harness_scenario(name: str, frames: int) -> dict:
    """tools/parity/run_parity.py's build_scenario for the two-pass harness:
    the SyntheticSequence keywords, whether the camera is RIG_CAMERA (else the
    sequence's own), the tree's layout ("tum", "tum_depth" or "euroc"), the
    harness switches and the Params overrides of a --params file."""
    seq = dict(n_frames=frames, n_points=1600, seed=5)
    out = dict(seq=seq, rig=False, layout="tum", switches=[], params=None)
    if name == "markers":
        seq.update(n_markers=10, marker_size=0.6)
        out["params"] = dict(aruco_markerSize=0.6)
    elif name == "rgbd":
        out.update(rig=True, layout="tum_depth", switches=["--rgbd"])
    elif name == "stereo":
        seq.update(depth_mode="stereo")
        out.update(rig=True, layout="euroc", switches=["--stereo", "--format", "euroc"])
    elif name == "loop":
        seq.update(n_points=3000, trajectory="orbit_out")
        out["switches"] = ["--recovery", "--save-every", "40"]
    elif name == "loop_easy":
        seq.update(n_points=2200, trajectory="sweep_back")
    elif name != "mono":
        raise ValueError(name)
    if out["layout"] != "euroc":
        out["switches"] = out["switches"] + ["--format", "tum"]
    return out


def write_camera_yml(path: str, cam) -> None:
    """The camera file run_parity.py hands the harness (write_tpu_camera_yml)."""
    with open(path, "w") as f:
        f.write(f"fx: {float(cam.fx)}\nfy: {float(cam.fy)}\ncx: {float(cam.cx)}\ncy: {float(cam.cy)}\n"
                f"width: {cam.width}\nheight: {cam.height}\nbl: {float(cam.bl)}\n")


def _render_frames(args) -> list:
    """A pool worker: the renders `write_tree`'s writer asks for, frames i0..i1."""
    from ucoslam_tpu_torch.geometry.camera import CameraParams
    from ucoslam_tpu_torch.io.synthetic import SyntheticSequence

    seq_kw, rig, layout, i0, i1 = args
    seq = SyntheticSequence(cam=CameraParams.create(**RIG_CAMERA) if rig else None, **seq_kw)
    how = {"euroc": seq.render_stereo, "tum_depth": seq.render_with_depth}.get(layout, seq.render)
    return [how(i) for i in range(i0, i1)]


def write_tree(name: str, frames: int, root: str):
    """The scenario's PNG tree, written by the port's writer
    (io.datasets.write_synthetic_*) from renders made by RENDER_JOBS
    processes at once -> (the sequence, the harness scenario)."""
    import concurrent.futures
    import multiprocessing

    from ucoslam_tpu_torch.geometry.camera import CameraParams
    from ucoslam_tpu_torch.io import datasets
    from ucoslam_tpu_torch.io.synthetic import SyntheticSequence

    sc = harness_scenario(name, frames)
    seq = SyntheticSequence(cam=CameraParams.create(**RIG_CAMERA) if sc["rig"] else None, **sc["seq"])
    cuts = [frames * k // RENDER_JOBS for k in range(RENDER_JOBS + 1)]
    parts = [(sc["seq"], sc["rig"], sc["layout"], a, b) for a, b in zip(cuts, cuts[1:]) if b > a]
    with concurrent.futures.ProcessPoolExecutor(len(parts), mp_context=multiprocessing.get_context("spawn")) as pool:
        renders = [r for part in pool.map(_render_frames, parts) for r in part]
    if sc["layout"] == "euroc":
        datasets.write_synthetic_euroc(seq, root, stereo=True, renders=renders)
    else:
        datasets.write_synthetic_tum(seq, root, depth=sc["layout"] == "tum_depth", renders=renders)
    return seq, sc


#: phase 13 holds B1 and B2 to their plain versions on the inputs of the
#: tracker's call of this number (from 1) to each, in pass 1 of each tree:
#: the first refine of about the 21st track attempt, with the map built up
HARNESS_CAPTURE_CALL = 41


def harness_capture(stack: contextlib.ExitStack, call: int) -> dict:
    """Keeps in the returned dict, while `stack` is open, the inputs of the
    tracker's `call`-th B1 call (`b1_track`) and `call`-th B2 call (`b2`, in
    b2_record's form), and those of the last duplicate fusion's B1
    (`b1_fuse`): clones only, no host read and no launch."""
    from ucoslam_tpu_torch.matching import projection
    from ucoslam_tpu_torch.slam import mapmanager, tracker

    kept, n, fusing = {}, {"b1": 0, "b2": 0}, []

    def fuse(inner, *args, **kwargs):
        fusing.append(True)
        try:
            return inner(*args, **kwargs)
        finally:
            fusing.pop()

    def match(inner, *args):
        if fusing:
            kept["b1_fuse"] = tuple(a.clone() for a in args)
        else:
            n["b1"] += 1
            if n["b1"] == call:
                kept["b1_track"] = tuple(a.clone() for a in args)
        return inner(*args)

    def lm(inner, pose0, X, uv, sig, valid, cam, depth=None, bf=None, iters=10, rounds=4):
        n["b2"] += 1
        if n["b2"] == call:
            kept["b2"] = dict(tensors=[t.clone() for t in (pose0, X, uv, sig, valid)], cam=cam, iters=iters,
                              rounds=rounds, depth=None if depth is None else depth.clone(), bf=bf)
        return inner(pose0, X, uv, sig, valid, cam, depth=depth, bf=bf, iters=iters, rounds=rounds)

    stack.enter_context(patched(mapmanager, "fuse_duplicates_into_kf", fuse))
    stack.enter_context(patched(projection, "project_match", match))
    stack.enter_context(patched(tracker, "motion_only_lm", lm))
    return kept


def b1_record(args: tuple, tag: str, suffix: str) -> dict:
    """Kernel B1 against its plain version on captured inputs, exactly, and
    its timing; the record's keys end in `suffix`."""
    import torch
    from ucoslam_tpu_torch.ops.cuda import match_kernel

    got, want = match_kernel.project_match(*args), match_kernel.project_match_plain(*args)
    torch.cuda.synchronize()
    err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          f"{tag}: B1 differs from its plain version (max abs err {err})")
    ms = median_ms(lambda: match_kernel.project_match(*args), 50)
    plain_ms = median_ms(lambda: match_kernel.project_match_plain(*args), 5)
    bound_ms, bound_by, passing = b1_bound(args)
    print(f"[{tag}] P={args[0].shape[0]} N={args[4].shape[0]} live_rows={int(args[3].sum())} "
          f"keypoints={int(args[7].sum())} gated_pairs={passing} exact kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={bound_ms:.6f} ({bound_by})")
    return {f"max_abs_err{suffix}": err, f"ms{suffix}": ms, f"plain_ms{suffix}": plain_ms,
            f"bound_ms{suffix}": bound_ms, f"bound_by{suffix}": bound_by}


def run_app(main, argv: list, log: str) -> str:
    """One of the port's apps in-process, its standard output kept in `log`."""
    with open(log, "w") as f, contextlib.redirect_stdout(f):
        rc = main(argv)
    with open(log) as f:
        text = f.read()
    check(rc in (0, None), f"{main.__module__} exited {rc}: {text[-500:]}")
    return text


def frontend_options_on_shared_arrays(images: list) -> dict:
    """Phase 13's frontend options: kptImageScaleFactor 0.5 with
    autoAdjustKpSensitivity, the same images (two frames, three nearly flat
    ones, two frames) through a FrameExtractor on the card and one on the
    CPU -> per frame the keypoints on each side and those of one side only
    (same octave, xy within 1e-3 px), and each side's FAST thresholds."""
    import numpy as np
    from ucoslam_tpu_torch.config import Params
    from ucoslam_tpu_torch.features.frame_extractor import FrameExtractor
    from ucoslam_tpu_torch.geometry.camera import CameraParams

    params = Params().replace(kptImageScaleFactor=0.5, autoAdjustKpSensitivity=True, detectMarkers=False,
                              maxKeyPointsPerFrame=1024)
    cam = CameraParams.create(500.0, 500.0, 320.0, 240.0)
    flat = np.full((480, 640), 40.0, np.float32) + (np.arange(640)[None, :] % 7)
    frames = images[:2] + [flat] * 3 + images[2:4]
    ext = {d: FrameExtractor(params, cam, d) for d in ("cuda", "cpu")}
    out = dict(card=[], cpu=[], one_side=[], thr_card=[], thr_cpu=[])
    for i, img in enumerate(frames):
        f = {d: e.process(img, i) for d, e in ext.items()}
        kp = {}
        for d, fr in f.items():
            v = fr.valid.cpu().numpy()
            kp[d] = (fr.xy.cpu().numpy()[v], fr.octave.cpu().numpy()[v])
        (xa, oa), (xb, ob) = kp["cuda"], kp["cpu"]
        dist = np.abs(xa[:, None, :] - xb[None, :, :]).max(-1) + np.where(oa[:, None] != ob[None, :], np.inf, 0.0)
        both = int((dist.min(1, initial=np.inf) <= 1e-3).sum()) if len(xa) and len(xb) else 0
        out["card"].append(len(xa))
        out["cpu"].append(len(xb))
        out["one_side"].append(len(xa) + len(xb) - 2 * both)
        out["thr_card"].append(ext["cuda"].orb.fast_threshold)
        out["thr_cpu"].append(ext["cpu"].orb.fast_threshold)
    return out


def phase_harness(frames: int, workdir: str) -> dict:
    """Phase 13 -> the kernels' launches on its main paths (the harness on
    each tree, run_slam's localization, test_reloc), the harness's numbers,
    and B1's and B2's records at the harness's shapes (`b1`, `b2`)."""
    import numpy as np
    import torch
    from ucoslam_tpu_torch.apps import map_export, run_slam, test_reloc, test_sequence
    from ucoslam_tpu_torch.apps.compare_logs import evaluate
    from ucoslam_tpu_torch.io import datasets

    with open(HARNESS_REF_PATH) as f:
        refs = json.load(f)["runs"][str(frames)]
    launches = dict.fromkeys(KERNEL_COUNTERS, 0)
    b1, b2 = {}, {}

    def add(n):
        for k in launches:
            launches[k] += n[k]

    out, mono_images = {}, None
    for name in HARNESS_TREES:
        ref = refs[name]
        root, run_dir = os.path.join(workdir, f"h13_{name}"), os.path.join(workdir, f"h13_{name}_run")
        t0 = time.perf_counter()
        seq, sc = write_tree(name, frames, root)
        write_s = time.perf_counter() - t0
        # the decoded first frame is the render, quantised as the writer quantises
        if sc["layout"] == "euroc":
            ds = datasets.EurocSequence.open(root, stereo=True)
            got = [ds.read(0), ds.read(0, 1)]
            want = [np.clip(x, 0, 255).astype(np.uint8) for x in seq.render_stereo(0)]
        else:
            ds = datasets.TumSequence.open(root)
            got, want = [ds.read_rgb(0)], [np.clip(seq.render(0), 0, 255).astype(np.uint8)]
            if sc["layout"] == "tum_depth":
                img, z = seq.render_with_depth(0)
                got.append(ds.read_depth_for(0))
                want.append(np.clip(np.asarray(z) * 5000.0, 0, 65535).astype(np.uint16))
        check(all(g.dtype == w.dtype and np.array_equal(g, w) for g, w in zip(got, want)),
              f"13 {name}: the decoded first frame is not the quantised render")
        if name == "mono":
            mono_images = [datasets.TumSequence.open(root).read_rgb(i) for i in range(4)]
        cam_yml = os.path.join(workdir, f"h13_{name}_cam.yml")
        write_camera_yml(cam_yml, seq.cam)
        argv = ["--dataset", root, "--out-dir", run_dir, "--camera", cam_yml, *sc["switches"], "--device", "cuda"]
        with contextlib.ExitStack() as stack:
            kept = harness_capture(stack, HARNESS_CAPTURE_CALL)
            reset_counts()
            t0 = time.perf_counter()
            run_app(test_sequence.main, argv, os.path.join(workdir, f"h13_{name}.log"))
            torch.cuda.synchronize()
            harness_s = time.perf_counter() - t0
            n = counts()
        add(n)
        with open(os.path.join(run_dir, "summary.json")) as f:
            r = json.load(f)
        gt = os.path.join(run_dir if sc["layout"] == "euroc" else root, "groundtruth.txt")
        est = os.path.join(run_dir, "trajectory.txt")
        ev = evaluate(est, gt, with_scale=False)
        r["metric_ate"] = None if ev is None else float(ev[0])
        stages = " ".join(f"{k}={v:.1f}ms" for k, v in r["stage_ms"].items())
        print(f"[13 harness {name}] {frames} frames: write_s={write_s:.1f} harness_s={harness_s:.1f} "
              f"pass1 tracked {r['pass1_tracked']} (jax {ref['pass1_tracked']}) pass2 tracked {r['pass2_tracked']} "
              f"(jax {ref['pass2_tracked']}) ATE={r['ate']} (jax {ref['ate']:.6f}) metric_ATE={r['metric_ate']} "
              f"(jax {ref['metric_ate']:.6f}) keyframes={r['keyframes']} (jax {ref['keyframes']}) points={r['points']} "
              f"(jax {ref['points']}) recoveries={r['recoveries']}; launches B1={n['B1']} B2={n['B2']} "
              f"(batched {n['B2_batched']})")
        print(f"[13 harness {name}] decode_ms_median={r['decode_ms_median']:.3f} steadyFPS={r['steady_fps']:.2f} "
              f"mappingFPS={r['mapping_fps']:.2f} trackingFPS={r['tracking_fps']:.2f} stage_ms: {stages}")
        check(n["B1"] > 0 and n["B2"] > 0, f"13 {name}: B1 or B2 was not launched on the card")
        check(r["pass1_tracked"] >= ref["pass1_tracked"] - 2, f"13 {name}: pass 1 tracked {r['pass1_tracked']}")
        check(r["pass2_tracked"] >= ref["pass2_tracked"] - 2, f"13 {name}: pass 2 tracked {r['pass2_tracked']}")
        check(r["ate"] is not None and r["ate"] <= 1.2 * ref["ate"] + 0.002, f"13 {name}: ATE {r['ate']}")
        if name != "mono":
            check(r["metric_ate"] is not None and r["metric_ate"] <= 1.2 * ref["metric_ate"] + 0.002,
                  f"13 {name}: metric ATE {r['metric_ate']}")
        out[name] = dict(r, write_s=write_s, harness_s=harness_s, launches=n)
        # the kernels at the harness's shapes, on this run's inputs
        check(all(k in kept for k in ("b1_track", "b1_fuse", "b2")),
              f"13 {name}: the run made no {HARNESS_CAPTURE_CALL}th tracker call to B1 and B2, or no fusion")
        b1.update(b1_record(kept["b1_track"], f"13 {name} B1 track", f"_h13_{name}_track"))
        b1.update(b1_record(kept["b1_fuse"], f"13 {name} B1 fusion", f"_h13_{name}_fuse"))
        b2.update(b2_record(kept["b2"], "keypoint" if name == "mono" else "depth", f"13 {name} B2",
                            f"_h13_{name}"))

        if name == "mono":
            map_path = os.path.join(run_dir, "map.slm")
            reset_counts()
            text = run_app(run_slam.main, ["--dataset", root, "--camera", cam_yml, "--mode", "localization",
                                           "--in-map", map_path, "--out", os.path.join(workdir, "h13_loc.txt"),
                                           "--device", "cuda"], os.path.join(workdir, "h13_run_slam.log"))
            torch.cuda.synchronize()
            n = counts()
            add(n)
            tracked = int(text.split("\ntracked ")[-1].split("/")[0])
            print(f"[13 run_slam] localization over the mono tree from the harness's map: tracked {tracked}/{frames} "
                  f"(harness pass 2 {r['pass2_tracked']}); launches B1={n['B1']} B2={n['B2']}")
            check(tracked >= r["pass2_tracked"] - 2 and n["B1"] > 0, f"13 run_slam: tracked {tracked}")
            reset_counts()
            text = run_app(test_reloc.main, ["--map", map_path, "--dataset", root, "--camera", cam_yml,
                                             "--device", "cuda"], os.path.join(workdir, "h13_reloc.log"))
            torch.cuda.synchronize()
            n = counts()
            add(n)
            rate = float(text.split("relocRate=")[-1].split()[0])
            print(f"[13 test_reloc] relocRate={rate:.4f} (jax {ref['reloc']['rate']:.4f}); launches B1={n['B1']} "
                  f"B2={n['B2']} (batched {n['B2_batched']})")
            check(rate >= ref["reloc"]["rate"], f"13 test_reloc: relocRate {rate} < JAX's {ref['reloc']['rate']}")
            exp = os.path.join(workdir, "h13_export")
            text = run_app(map_export.main, [map_path, "--ply", exp + ".ply", "--pcd", exp + ".pcd",
                                             "--markermap", exp + "_markers.yml", "--pmvs", exp + "_pmvs"],
                           os.path.join(workdir, "h13_export.log"))
            n_pmvs = sum(len(fs) for _, _, fs in os.walk(exp + "_pmvs"))
            ok = all(os.path.getsize(exp + x) > 0 for x in (".ply", ".pcd", "_markers.yml"))
            print(f"[13 map_export] ply/pcd/markermap written {ok}; pmvs files {n_pmvs} for {r['keyframes']} keyframes")
            check(ok and n_pmvs == r["keyframes"] + 2, "13 map_export: files missing")

    fo = frontend_options_on_shared_arrays(mono_images)
    one_side = max(o / max(a, b, 1) for o, a, b in zip(fo["one_side"], fo["card"], fo["cpu"]))
    print(f"[13 frontend options] ksf 0.5 + autoAdjustKpSensitivity, card vs CPU: keypoints {fo['card']} / "
          f"{fo['cpu']}, on one side only at most {100 * one_side:.2f}%; FAST thresholds card {fo['thr_card']} "
          f"cpu {fo['thr_cpu']}")
    check(one_side <= 0.01, f"13 frontend options: {100 * one_side:.2f}% of the keypoints on one side only")
    check(fo["thr_card"] == fo["thr_cpu"] and min(fo["thr_card"]) < 7.0,
          "13 frontend options: the FAST thresholds differ or never moved")
    return dict(launches=launches, trees=out, b1=b1, b2=b2)


#: phase 14: the JAX package's FREAK and SURF runs of the mono scene
#: (`tools/port/make_reference_map.py --descriptor freak|surf`)
DESCRIPTOR_FAMILIES = ("freak", "surf")
#: the share of descriptor bits on shared keypoints that may differ between
#: card and CPU: the floor tests/test_torch_descriptors.py holds the port to
#: against the JAX package (it measured 0-1 bits of ~131000 a frame)
DESC_BIT_SHARE_TOL = 1e-3
#: phase 14 (c): the trainer at the repository vocabulary's width, and the
#: card-vs-CPU subset (words, frames harvested, iterations)
VOCAB_WORDS, VOCAB_FRAMES, VOCAB_SUBSET = 16384, 120, (2048, 16, 2)


def descriptor_ref(family: str) -> dict:
    with open(os.path.join(HERE, "data", "torch_port", f"{family}_jax.json")) as f:
        return json.load(f)


def descriptor_params(family: str):
    """The library's widths with the family's own gate, markers off (what
    the JAX reference mapped with)."""
    from ucoslam_tpu_torch.config import DescriptorType, Params

    return Params().setParams(True, DescriptorType[family.upper()]).replace(detectMarkers=False)


def frames_card_vs_cpu(params, cam, images) -> dict:
    """The same images through a FrameExtractor on the card and one on the
    CPU -> keypoints on each side, those of one side only (same octave, xy
    within 1e-3 px), and the descriptor bits that differ on the shared ones."""
    import numpy as np
    from ucoslam_tpu_torch.features.frame_extractor import FrameExtractor

    ext = {d: FrameExtractor(params, cam, d) for d in ("cuda", "cpu")}
    out = dict(card=0, cpu=0, one_side=0, bits=0, shared=0)
    for i, img in enumerate(images):
        f = {d: e.process(img, i) for d, e in ext.items()}
        kp = {}
        for d, fr in f.items():
            v = fr.valid.cpu().numpy()
            kp[d] = (fr.xy.cpu().numpy()[v], fr.octave.cpu().numpy()[v], fr.desc.cpu().numpy()[v].view(np.uint32))
        (xa, oa, da), (xb, ob, db) = kp["cuda"], kp["cpu"]
        dist = np.abs(xa[:, None, :] - xb[None, :, :]).max(-1) + np.where(oa[:, None] != ob[None, :], np.inf, 0.0)
        j = dist.argmin(1)
        both = dist[np.arange(len(xa)), j] <= 1e-3
        out["card"] += len(xa)
        out["cpu"] += len(xb)
        out["one_side"] += len(xa) + len(xb) - 2 * int(both.sum())
        out["shared"] += int(both.sum())
        out["bits"] += int(np.unpackbits((da[both] ^ db[j[both]]).view(np.uint8)).sum())
    return out


def descriptor_slam(family: str, scene, workdir: str) -> dict:
    """Phase 14 (b) for one family -> the kernels' launches on its main path
    (pass 1 and the reloaded sweep) and B1's and B2's records on its inputs."""
    import numpy as np
    import torch
    from ucoslam_tpu_torch import Mode
    from ucoslam_tpu_torch.api import UcoSlam

    ref, (_, cam, seq, images) = descriptor_ref(family), scene
    params = descriptor_params(family)
    tag = f"14 {family}"
    with contextlib.ExitStack() as stack:
        kept = harness_capture(stack, HARNESS_CAPTURE_CALL)
        run = slam_pass(params, cam, images)
    slam, poses, t_frame = run["slam"], run["poses"], run["t_frame"]
    check(slam._extractor.orb.descriptor == family, f"{tag}: the extractor describes {slam._extractor.orb.descriptor}")
    check(len(poses) >= 3 and all(p.shape == (4, 4) and np.isfinite(p).all() for p in poses.values()),
          f"{tag}: pass 1 tracked {len(poses)} frames or gave a non-finite pose")
    ate = ate_of(poses, seq)
    slam.map.check_consistency()
    print(f"[{tag} slam] gate={params.maxDescDistance} pass 1: tracked={len(poses)} (jax {ref['pass1_tracked']}) "
          f"ate={ate:.6f} (jax {ref['pass1_ate']:.6f}) keyframes={slam.map.n_keyframes} (jax {ref['n_keyframes']}) "
          f"points={slam.map.n_points} (jax {ref['n_points']}) insertions={run['insertions']} "
          f"(jax {ref['pass1_insertions']}) attempts={run['attempts']} launches={run['launches']}")
    check(len(poses) >= ref["pass1_tracked"] - 2, f"{tag}: pass 1 tracked over 2 frames fewer than JAX's")
    check(ate <= 1.2 * ref["pass1_ate"] + 0.002, f"{tag}: pass 1 ATE {ate} over the limit")
    check(abs(slam.map.n_keyframes - ref["n_keyframes"]) <= 1, f"{tag}: keyframes not within 1 of JAX's")
    check_slam_launches(run, f"{tag} pass 1")
    launches = dict(run["launches"])

    path = os.path.join(workdir, f"{family}.slm")
    slam.saveToFile(path)
    loc = UcoSlam(device="cuda")
    loc.readFromFile(path, cam)
    check(loc.getSignatureStr() == slam.getSignatureStr() and loc._extractor.orb.descriptor == family,
          f"{tag}: the reloaded checkpoint has another signature or family")
    loc.setMode(Mode.LOCALIZATION)
    reset_counts()
    rev = {}
    for i in reversed(range(len(images))):
        pose = loc.process(images[i], fseq=i)
        if pose is not None:
            rev[i] = pose
    rev_launches, attempts = counts(), loc._system.tracker.n_attempts
    check(len(rev) >= 3, f"{tag}: the reloaded sweep tracked only {len(rev)} frames")
    rev_ate = ate_of(rev, seq)
    print(f"[{tag} reload] reverse sweep: tracked={len(rev)} (jax {ref['pass2_tracked']}) ate={rev_ate:.6f} "
          f"(jax {ref['pass2_ate']:.6f}) attempts={attempts} launches={rev_launches}")
    check(len(rev) >= ref["pass2_tracked"] - 2, f"{tag}: the reloaded sweep tracked over 2 frames fewer than JAX's")
    for k in ("B1", "B2"):
        check(rev_launches[k] > 0 and rev_launches[k] == 2 * attempts,
              f"{tag}: {k} launched {rev_launches[k]} times for {attempts} attempts")
    check_detect_launches(rev_launches, detect_calls(loc, "mono", len(images)), f"{tag} reload")
    launches = {k: n + rev_launches[k] for k, n in launches.items()}

    def med(ts):
        return f"{np.median(ts):.3f}" if ts else "none"

    print(f"[{tag} times] process_ms_median: track={med(t_frame['track'])} (n={len(t_frame['track'])}) "
          f"keyframe={med(t_frame['keyframe'])} (n={len(t_frame['keyframe'])})")
    check(all(k in kept for k in ("b1_track", "b1_fuse", "b2")), f"{tag}: no B1 / B2 inputs captured")
    b1 = {**b1_record(kept["b1_track"], f"{tag} B1 track", f"_{family}_track"),
          **b1_record(kept["b1_fuse"], f"{tag} B1 fuse", f"_{family}_fuse")}
    b2 = b2_record(kept["b2"], "keypoint", f"{tag} B2", f"_{family}")
    torch.cuda.synchronize()
    return dict(launches=launches, b1=b1, b2=b2, t_frame=t_frame)


def vocabulary_top1(vocab_path: str | None) -> float:
    """tests/test_fbow.py's revisit gate on the card: each of 10 query frames
    (the database's trajectory under a 0.15 brightness drift) retrieves its
    own frame or a neighbour, top-1 -> the share that does; `vocab_path`
    None: the database's default random centroids."""
    import numpy as np
    import torch
    from ucoslam_tpu_torch.features.orb import ORBExtractor
    from ucoslam_tpu_torch.io.synthetic import SyntheticSequence
    from ucoslam_tpu_torch.mapping.kfdatabase import KeyFrameDataBase

    seq_db = SyntheticSequence(n_frames=10, n_points=1500, seed=301)
    seq_q = SyntheticSequence(n_frames=10, n_points=1500, seed=301, brightness_drift=0.15)
    orb = ORBExtractor(max_features=1000)

    def feats(seq):
        return [orb.detect_and_compute(torch.from_numpy(np.asarray(seq.render(i), np.float32)).cuda())
                for i in range(10)]

    db = KeyFrameDataBase(16, device="cuda")
    if vocab_path is not None:
        db.load_vocabulary(vocab_path)
    for i, f in enumerate(feats(seq_db)):
        db.add(i, f.desc, f.valid)
    hits = sum(abs(int(np.argmax(db.query(f.desc, f.valid)[:10])) - i) <= 1 for i, f in enumerate(feats(seq_q)))
    return hits / 10.0


def phase_descriptors(scene, workdir: str) -> dict:
    """Phase 14 -> the kernels' launches on its main paths (each family's
    pass 1 and reloaded sweep) and B1's and B2's records on their inputs."""
    import numpy as np
    import torch
    from ucoslam_tpu_torch.features import vocab_trainer
    from ucoslam_tpu_torch.features.frame_extractor import FrameExtractor
    from ucoslam_tpu_torch.io.fbow import default_vocab_path, load_fbow

    _, cam, _, images = scene
    # (a) one frame, card against CPU, and the extract ms of each family beside ORB's
    extract_ms = {}
    for family in ("orb", *DESCRIPTOR_FAMILIES):
        params = descriptor_params(family)
        if family != "orb":
            fc = frames_card_vs_cpu(params, cam, [images[FRONTEND_FRAME]])
            one_side, bits = fc["one_side"] / max(fc["card"], fc["cpu"], 1), fc["bits"] / max(256 * fc["shared"], 1)
            print(f"[14 {family} frame] card vs CPU, frame {FRONTEND_FRAME}: keypoints {fc['card']} / {fc['cpu']}, "
                  f"on one side only {100 * one_side:.2f}%; descriptor bits differing {fc['bits']} of "
                  f"{256 * fc['shared']} ({100 * bits:.4f}%, tol {100 * DESC_BIT_SHARE_TOL:.2f}%)")
            check(one_side <= 0.01, f"14 {family}: {100 * one_side:.2f}% of the keypoints on one side only")
            check(bits <= DESC_BIT_SHARE_TOL, f"14 {family}: {100 * bits:.4f}% of the descriptor bits differ")
        ext, ts = FrameExtractor(params, cam, "cuda"), []
        for i in range(20):
            t0 = time.perf_counter()
            ext.process(images[i], i)
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t0))
        extract_ms[family] = float(np.median(ts[2:]))
    print("[14 extract] FrameExtractor.process ms a frame (median of 18, host clock to a synchronize): "
          + " ".join(f"{k}={v:.3f}" for k, v in extract_ms.items()))

    # (b) each family through SLAM, save, reload, sweep; B1 and B2 on its inputs
    launches, b1, b2, frame_ms = dict.fromkeys(KERNEL_COUNTERS, 0), {}, {}, {}
    for family in DESCRIPTOR_FAMILIES:
        part = descriptor_slam(family, scene, workdir)
        launches = {k: n + part["launches"][k] for k, n in launches.items()}
        b1.update(part["b1"])
        b2.update(part["b2"])
        frame_ms[family] = {k: float(np.median(v)) for k, v in part["t_frame"].items() if v}

    # (c) the trainer: the repository vocabulary's width on the card
    out = os.path.join(workdir, "vocab14.fbow")
    log = run_app(vocab_trainer.main, ["--out", out, "--words", str(VOCAB_WORDS), "--frames", str(VOCAB_FRAMES)],
                  os.path.join(workdir, "vocab14.log"))
    for line in log.strip().splitlines():
        print(f"[14 trainer] {line.strip()}")
    check(len(load_fbow(out).desc) == VOCAB_WORDS, f"14 trainer: the vocabulary has not {VOCAB_WORDS} words")
    words, frames, iters = VOCAB_SUBSET
    desc, ids, n_img = vocab_trainer.harvest_descriptors(frames, device="cuda")
    trained = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        trained[device] = vocab_trainer.train_vocabulary(desc, ids, n_img, k=words, iters=iters, device=device)
        trained[device + "_s"] = time.perf_counter() - t0
    same = all(np.array_equal(a, b) for a, b in zip(trained["cuda"], trained["cpu"]))
    print(f"[14 trainer] subset: {words} words over {len(desc)} descriptors of {n_img} images, {iters} iterations: "
          f"card {trained['cuda_s']:.3f} s, cpu {trained['cpu_s']:.3f} s; centroids and idf identical {same}")
    check(same, "14 trainer: card and CPU give other centroids or idf")
    acc = {name: vocabulary_top1(p) for name, p in (("card-trained", out), ("random", None),
                                                    ("data/vocab.fbow", default_vocab_path()))}
    print("[14 trainer] revisit top-1: " + " ".join(f"{k}={v:.2f}" for k, v in acc.items()))
    check(acc["card-trained"] >= acc["random"] and acc["card-trained"] >= 0.8,
          "14 trainer: the card-trained vocabulary does not pass the reference's revisit gate")
    print(f"[14 times] process_ms_median by family and frame kind: {json.dumps(frame_ms)}")
    return dict(launches=launches, b1=b1, b2=b2)


#: phase 15: the marker views of tools/port/marker_render.py per table, the
#: corner bound against the projected corners (tests/test_torch_dictionaries.py
#: measured 0.193 px on the CPU), the frames of the TAG36h11 SLAM pass
DICT_CORNER_BOUND, DICT_SLAM_FRAMES = 0.25, 60
DICT_SLAM_REF = os.path.join(HERE, "data", "torch_port", "markers_tag36h11_jax.json")
#: phase 15 (b): bench.py's BA problem, the LM steps of the solves
SHARD_BA_SHAPE, SHARD_BA_ITERS = (128, 16384, 8), 20


def ring_pose_graph(n: int = 128, drift: float = 0.02, seed: int = 3):
    """A ring of n Sim3 keyframes (tests/test_posegraph.py's ring_problem at
    n, numpy): odometry edges carry the true relative motion, the starting
    poses integrate a drifted one with a 1% scale drift a step, one loop
    edge closes the ring; keyframe 0 fixed -> the port's PoseGraphProblem (CPU)."""
    import numpy as np
    import torch
    from ucoslam_tpu_torch.optim.posegraph import PoseGraphProblem

    rng = np.random.default_rng(seed)
    true = []
    for k in range(n):
        a = 2 * np.pi * k / n
        T = se3_exp_np(np.array([3 * np.sin(a), 0.0, 3 - 3 * np.cos(a), 0.0, a, 0.0], np.float32))
        true.append(T.astype(np.float64))
    noisy, acc = [true[0]], true[0]
    for k in range(1, n):
        rel = true[k] @ np.linalg.inv(true[k - 1])
        d = se3_exp_np(rng.normal(0, drift, 6).astype(np.float32)).astype(np.float64)
        S = d @ rel
        S[:3, :3] *= 1.01  # the scale drifts too
        acc = S @ acc
        noisy.append(acc)
    ei = list(range(n - 1)) + [n - 1]
    ej = list(range(1, n)) + [0]
    meas = [true[i] @ np.linalg.inv(true[j]) for i, j in zip(ei, ej)]
    w = [50.0] * (n - 1) + [200.0]
    fixed = np.zeros(n, bool)
    fixed[0] = True
    return PoseGraphProblem(
        poses=torch.from_numpy(np.stack(noisy).astype(np.float32)), fixed=torch.from_numpy(fixed),
        edge_i=torch.tensor(ei), edge_j=torch.tensor(ej), edge_meas=torch.from_numpy(np.stack(meas).astype(np.float32)),
        edge_weight=torch.tensor(w), edge_valid=torch.ones(n, dtype=torch.bool))


def phase_dictionaries(workdir: str) -> dict:
    """Phase 15 (a) -> the kernels' launches on the TAG36h11 pass and their
    records on its inputs, and the pass's map (for (b))."""
    import numpy as np
    from tools.port.marker_render import dictionary_frames, dictionary_scene
    from ucoslam_tpu_torch.config import Params
    from ucoslam_tpu_torch.geometry.camera import CameraParams
    from ucoslam_tpu_torch.markers import dictionary
    from ucoslam_tpu_torch.markers.detector import ArucoDetector

    cam = CameraParams.create(500.0, 500.0, 320.0, 240.0)
    names = [f"DICT_{f}_{s}" for f in ("4X4", "5X5", "6X6", "7X7") for s in (50, 100, 250, 1000)] + [
        "DICT_APRILTAG_16h5", "DICT_APRILTAG_25h9", "DICT_APRILTAG_36h10", "DICT_APRILTAG_36h11",
        "DICT_ARUCO_ORIGINAL", "DICT_ARUCO_MIP_36h12"]
    worst, n_markers, t0 = 0.0, 0, time.perf_counter()
    for name in names:
        det = ArucoDetector(name, marker_size=0.6, device="cuda")
        for gray, oracle in dictionary_frames(name):
            fm = det.detect(gray, cam)
            ids = sorted(int(i) for i in fm.id[fm.valid])
            check(ids == sorted(oracle), f"(a) {name}: detected {ids}, rendered {sorted(oracle)}")
            for i, c in zip(fm.id[fm.valid], fm.corners[fm.valid]):
                bm = dictionary.marker_bitmap(int(i), name)
                gap = np.abs(c - oracle[int(i)]).max()
                if (np.rot90(bm, 2) == bm).all():  # a code equal to its own half-turn
                    gap = min(gap, np.abs(np.roll(c, 2, 0) - oracle[int(i)]).max())
                worst = max(worst, float(gap))
            check(np.isfinite(fm.pose1[fm.valid]).all(), f"(a) {name}: a non-finite IPPE pose")
            n_markers += len(ids)
    check(worst < DICT_CORNER_BOUND, f"(a): a corner {worst} px from the projected one")
    print(f"[15 dictionaries] (a) tables={len(names)} views={2 * len(names)} markers={n_markers} all ids exact "
          f"corner_max_err_px={worst:.4f} (bound {DICT_CORNER_BOUND}) s={time.perf_counter() - t0:.1f}")

    with open(DICT_SLAM_REF) as f:
        ref = json.load(f)
    j1, p = ref["pass1"], ref["params"]
    check(ref["sequence"]["n_frames"] == DICT_SLAM_FRAMES, "the TAG36h11 reference's length")
    seq, ids, images, truth = dictionary_scene(p["aruco_Dictionary"], ref["sequence"], cam=cam)
    check({str(k): v for k, v in ids.items()} == ref["ids"], "the reference drew other codewords")
    params = Params().replace(**p)
    with contextlib.ExitStack() as stack:
        b2_args = b2_capture(stack, "marker", min_markers=2)
        run = slam_pass(params, cam, images)
    slam, poses = run["slam"], run["poses"]
    check_slam_launches(run, "(a) TAG36h11 pass")
    ms = metric_summary(poses, seq)
    me = marker_errors(*slam.map.h("mk_id", "mk_pose", "mk_pose_valid"), poses, seq, truth)
    print(f"[15 dictionaries] (a) TAG36h11 pass (jax: cv2 backend {ref['backend']}): frames={len(images)} "
          f"tracked={len(poses)} (jax {j1['tracked']}) metric_ate={ms['metric_ate']:.6f} (jax "
          f"{j1['metric_ate']:.6f}) markers_posed={me['markers_posed']} (jax {j1['markers_posed']}) "
          f"marker_err_mean={me['marker_err_mean']} (jax {j1['marker_err_mean']}) keyframes={slam.map.n_keyframes} "
          f"(jax {j1['keyframes']}) init={run['init']} (jax {j1['init']}) launches={run['launches']}")
    check(len(poses) >= j1["tracked"] - 2, "(a) TAG36h11: tracked over 2 frames fewer than the JAX package")
    check(ms["metric_ate"] <= 1.2 * j1["metric_ate"] + 0.002, f"(a) TAG36h11: metric ATE {ms['metric_ate']}")
    check(me["markers_posed"] >= j1["markers_posed"] - 1, "(a) TAG36h11: fewer markers posed than JAX's - 1")
    check(b2_args, "(a) TAG36h11: no frame had 2 live markers in the tracker's rows")
    return dict(launches=run["launches"], slam=slam, cam=cam,
                b2=b2_record(b2_args, "marker", "15 B2 TAG36h11 marker rows", "_tag36h11"),
                b1=b1_record(run["fuse_args"], "15 B1 TAG36h11 fusion", "_tag36h11"))


def phase_sharded(marker_map, cam) -> dict:
    """Phase 15 (b): the sharded solvers in two worlds of ranks on the card,
    one NCCL rank and two gloo ranks on cuda:0, each running all its cases
    in one world."""
    import numpy as np
    from tools.port import parallel_tasks
    from ucoslam_tpu_torch.optim import ba, posegraph, schur_pm
    from ucoslam_tpu_torch.parallel.distributed import spawn, to_host
    from ucoslam_tpu_torch.parallel.sharded_ba import shard_ba_problem
    from ucoslam_tpu_torch.parallel.sharded_posegraph import shard_pose_graph_problem

    def close(got, want, what, cost_tol, pose_tol):
        c = np.asarray(want[1])
        rel = float(np.max(np.abs(got["costs"] - c) / c))
        dp = float(np.abs(got["cam_pose"] - np.asarray(want[0])).max())
        check(rel <= cost_tol and dp <= pose_tol, f"(b) {what}: cost history {rel} relative, poses {dp} apart")
        return rel, dp

    # bench.py's problem, point-major (the tables built once, on the host)
    cam_args = dict(zip(("fx", "fy", "cx", "cy"), BA_CAMERA))
    arrays = ba_scale_problem(*SHARD_BA_SHAPE)
    problem, bcam = ba_problem_on(arrays, "cuda")
    pm = schur_pm.pm_problem_for(problem)
    check(pm is not None, "(b): bench.py's problem is not point-major")
    single = schur_pm.pm_staged_lm(pm, bcam, iters=SHARD_BA_ITERS, stages=2)
    want = (single[0].cpu().numpy(), single[2].cpu().numpy())
    ms_single = ba_ms_per_iteration(problem, bcam, "auto")[0]
    pm_host = to_host(pm)
    # the TAG36h11 pass's marker map (the general sharded solver) and a
    # 128-keyframe ring's pose graph, solved here on one device
    mproblem, _, _, mk_slots = ba.build_ba_problem(marker_map, cam)
    check(len(mk_slots) > 0, "(b): the marker map has no marker vertex")
    mres = ba.ba_solve(mproblem, cam, iters=10, stages=2, solver="dense")
    pg = ring_pose_graph(128)
    pg_single = posegraph.pose_graph_solve(pg.__class__(**{k: v.cuda() for k, v in vars(pg).items()}), iters=20)
    mcam = dict(fx=float(cam.fx), fy=float(cam.fy), cx=float(cam.cx), cy=float(cam.cy))
    pm_jobs = [("pm", (pm_host, cam_args, SHARD_BA_ITERS, 2), {}), ("pm_step_ms", (pm_host, cam_args), {})]
    t0 = time.perf_counter()
    w1 = spawn(parallel_tasks.batch, 1, pm_jobs, timeout=300, backend="nccl", device="cuda")
    w2 = spawn(parallel_tasks.batch, 2, pm_jobs + [
        ("ba", (to_host(shard_ba_problem(mproblem, 2)), mcam, 10, 2, "dense"), {}),
        ("posegraph", (to_host(shard_pose_graph_problem(pg, 2)), 20, False), {})],
        timeout=300, backend="gloo", device="cuda:0")
    t_worlds = time.perf_counter() - t0

    n_macro = -(-SHARD_BA_ITERS // 6)
    R = -(-SHARD_BA_ITERS // n_macro)
    expect = 2 * (1 + n_macro * (1 + 2 * R))
    with open(BA_REF_PATHS[0]) as f:
        spread = {pair: {k: v for k, v in gap.items() if k != "cost"} for pair, gap in json.load(f)["spread"].items()}
    for what, world in (("world 1 nccl", w1), ("world 2 gloo cuda:0", w2)):
        got = world[0][0]
        if world is w1:  # one rank: the all_reduce is a copy, the solve the single device's
            rel, dp = close(got, want, what, 1e-5, 1e-4)
            detail = ""
        else:
            # two ranks sum the camera system in another order; bench.py's
            # problem leaves the scale free (phase 11), so past the cost the
            # solution is held in ba_gap's gauge-free measures to twice the
            # reference's own route gaps, as phase 11 holds it
            rel, _ = close(got, want, what, 1e-4, float("inf"))
            dp = float(np.abs(got["cam_pose"] - want[0]).max())
            gap = ba_gap((got["cam_pose"], got["pt_pos"][:SHARD_BA_SHAPE[1]]), (want[0], single[1].cpu().numpy()),
                         arrays)
            bad = ba_gap_failures(gap, spread)
            check(not bad, f"(b) {what}: {bad} past twice the reference's route gaps: {gap}")
            detail = " ba_gap=" + json.dumps({k: round(v, 6) for k, v in gap.items()})
        check(all(r[0]["collectives"] == expect for r in world), f"(b) {what}: collectives {got['collectives']} "
              f"(expected {expect})")
        steps = world[0][1]
        check(steps["collectives_per_step"] == 2 and steps["collectives_per_relin"] == 1,
              f"(b) {what}: the point-major collective profile {steps}")
        print(f"[15 sharded] (b) bench BA point-major {what}: ranks={len(world)} devices="
              f"{[r[0]['device'] for r in world]} cost_rel_err={rel:.3e} pose_max_abs_err={dp:.3e}{detail} "
              f"collectives={got['collectives']} (= stages x (1 + relinearizations x (1 + 2 x steps))) "
              f"ms_per_lm_step={steps['ms_per_step']:.3f} collectives_per_lm_step={steps['collectives_per_step']} "
              f"collectives_per_relinearization={steps['collectives_per_relin']}")
    print(f"[15 sharded] (b) ms an LM step (point-major, {SHARD_BA_SHAPE[0]} keyframes): single device "
          f"{ms_single:.3f} (phase 11's measure), world 1 nccl {w1[0][1]['ms_per_step']:.3f}, world 2 gloo on one "
          f"card {w2[0][1]['ms_per_step']:.3f}; none of the collectives in PCG; both worlds' s={t_worlds:.1f}")

    mw = w2[0][2]
    rel, dp = close(mw, (mres.cam_pose.cpu().numpy(), mres.cost_history.cpu().numpy()), "marker map", 1e-4, 1e-3)
    dm = float(np.abs(mw["mk_pose"] - mres.mk_pose.cpu().numpy()).max())
    check(dm <= 1e-3, f"(b) marker map: marker poses {dm} apart")
    print(f"[15 sharded] (b) marker map ({int(mproblem.cam_valid.sum())} keyframes, {len(mk_slots)} markers, "
          f"{int(mproblem.obs_valid.sum())} observations) sharded_ba_solve world 2 gloo cuda:0: cost_rel_err={rel:.3e} "
          f"pose_max_abs_err={dp:.3e} marker_pose_max_abs_err={dm:.3e} collectives={mw['collectives']}")
    pw = w2[0][3]
    d = float(np.abs(pw["poses"] - pg_single.cpu().numpy()).max())
    moved = float(np.abs(pg_single.cpu().numpy() - pg.poses.numpy()).max())
    check(d <= 1e-4 and moved > 1e-2, f"(b) ring pose graph: sharded poses {d} from single, moved {moved}")
    print(f"[15 sharded] (b) 128-keyframe ring pose graph sharded_pose_graph_solve world 2 gloo cuda:0: "
          f"pose_max_abs_err={d:.3e} (the solve moved poses by {moved:.3f}) collectives={pw['collectives']}")
    return dict(ms_single=ms_single, ms_world1=w1[0][1]["ms_per_step"], ms_world2=w2[0][1]["ms_per_step"])


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke test of the PyTorch/CUDA port on one GPU.")
    ap.add_argument("--frames", type=int, default=60, choices=(60, 150),
                    help="frames of the mono, markers, stereo and rgbd scenarios that phases 5, 8 and 9 map "
                         "(the JAX references' length)")
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

    from ucoslam_tpu_torch.utils.timers import timers

    timers.start()  # the launch table reads the tracer's counters
    t_start = time.perf_counter()
    seconds = {}

    def lap(phase):
        seconds[phase] = round(time.perf_counter() - t_start - sum(seconds.values()), 3)

    name = phase_environment()
    lap("1")
    b1 = phase_b1()
    lap("2")
    b2 = phase_b2()
    lap("3")
    scene = load_scene(REF_PATH)
    lap("render")
    f1, f2 = phase_detect(scene)
    lap("3 F1/F2")
    launches = phase_slice(scene)
    lap("4")
    for rec, k in ((f1, "F1"), (f2, "F2")):  # phase 4 is the localize slice: one frame, one image
        rec["launches_per_frame"] = launches[k] / scene[2].n_frames
    slam_map, slam_ref = reference_paths(args.frames)
    failed = None
    with tempfile.TemporaryDirectory() as workdir:
        try:
            slam = phase_slam(scene if args.frames == 60 else load_scene(slam_ref), slam_map, workdir)
        except SmokeFailure as e:
            # no later phase but 6 and 7 depends on phase 5: they still run
            # and report, and the run fails after them
            failed, slam = e, None
            print(f"[5 slam] FAILED: {e}")
        lap("5")
        if slam is not None:
            launches = {k: n + slam["launches"][k] for k, n in launches.items()}
            b1.update(slam["b1_fuse"])
        if slam is not None and args.frames == 60:  # phases 6 and 7 run on the 60-frame scene
            recovery = phase_recovery(scene)
            lap("6")
            loop = phase_loop(slam["checkpoint"], scene[1])
            lap("7")
            launches = {k: n + recovery["launches"][k] + loop["launches"][k] for k, n in launches.items()}
            b2["launches_batched"] = recovery["launches"]["B2_batched"] + loop["launches"]["B2_batched"]
            b2.update(reloc_process_ms=recovery["bow"]["reloc_ms"], reloc_bf_process_ms=recovery["bf"]["reloc_ms"])
        for phase, kind in (("8", None), ("9 stereo", "stereo"), ("9 rgbd", "rgbd")):
            try:
                part = phase_markers(args.frames, workdir) if kind is None else phase_depth(kind, args.frames, workdir)
            except SmokeFailure as e:
                # no phase from 8 on depends on another: each still runs and
                # reports, and the run fails after them
                failed, part = failed or e, None
                print(f"[{phase}] FAILED: {e}")
            lap(phase)
            if part is not None:
                launches = {k: n + part["launches"][k] for k, n in launches.items()}
                b2["launches_batched"] = b2.get("launches_batched", 0) + part["launches"]["B2_batched"]
                b2.update(part.get("b2", {}))
        phases = [("13", lambda: phase_harness(args.frames, workdir))]
        if args.frames == 60:  # phases 10-12 and 14 run in the 60-frame run
            phases[:0] = [("10", lambda: phase_vocabulary(scene, workdir)), ("11", lambda: phase_ba_scale(workdir)),
                          ("12", lambda: phase_async(scene))]
            phases.append(("14", lambda: phase_descriptors(scene, workdir)))

            def phase15():
                part = phase_dictionaries(workdir)
                lap("15 dictionaries")
                phase_sharded(part.pop("slam").map, part.pop("cam"))
                return part

            phases.append(("15", phase15))
        for phase, run in phases:
            try:
                part = run()
            except SmokeFailure as e:
                # no phase from 10 on depends on another: each still runs
                failed, part = failed or e, None
                print(f"[{phase}] FAILED: {e}")
            lap(phase)
            if part is not None and "launches" in part:
                launches = {k: n + part["launches"][k] for k, n in launches.items()}
                b2["launches_batched"] = b2.get("launches_batched", 0) + part["launches"]["B2_batched"]
            for rec, key in ((b1, "b1"), (b2, "b2")):  # phases 13's and 14's records on their inputs
                if part is not None and key in part:
                    rec.update(part[key])
                    rec["max_abs_err"] = max([rec["max_abs_err"]] + [
                        v for k, v in part[key].items() if k.startswith("max_abs_err")])
    if failed is not None:
        raise failed
    print(f"[time] seconds by phase {json.dumps(seconds)} total={time.perf_counter() - t_start:.1f}")
    check("jax" not in sys.modules, "jax was imported")
    check("ucoslam_tpu" not in sys.modules, "the JAX package ucoslam_tpu was imported")
    kernels = [
        dict(name="project_match", route="cuda", source="ucoslam_tpu_torch/csrc/match_kernel.cu",
             replaces="ucoslam_tpu/ops/pallas/match_kernel.py:105", launches=launches["B1"],
             library_ms=None, **b1),
        dict(name="motion_only_lm", route="cuda", source="ucoslam_tpu_torch/csrc/lm_kernel.cu",
             replaces="ucoslam_tpu/ops/pallas/lm_kernel.py:246", launches=launches["B2"],
             library_ms=None, **b2),
        dict(name="fast_cells", route="cuda", source="ucoslam_tpu_torch/csrc/fast_kernel.cu",
             replaces=None, launches=launches["F1"], library_ms=None, **f1),
        dict(name="select_keypoints", route="cuda", source="ucoslam_tpu_torch/csrc/fast_kernel.cu",
             replaces=None, launches=launches["F2"], library_ms=None, **f2),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
