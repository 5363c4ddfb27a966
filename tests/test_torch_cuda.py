"""The port's CUDA kernels against their plain versions on the card.

Marked `cuda`: each test skips without a CUDA device. This file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import chip_smoke
from ucoslam_tpu_torch.ops.cuda import fast_kernel, lm_kernel, match_kernel
from ucoslam_tpu_torch.slam.system import disable_tf32
from ucoslam_tpu_torch.utils.timers import N_MARKS, DeviceTrace, attribute, now_ns, timers, tracing

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    disable_tf32()
    return torch.device("cuda")


def _assert_b1_equal(args):
    with tracing():
        before = timers.counters().get("B1", 0)
        got = match_kernel.project_match(*args)
        assert timers.counters().get("B1", 0) == before + 1
    want = match_kernel.project_match_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# The kernel's persistent grid deals row p to block p mod grid, with one or
# two blocks an SM, and gives a point 32 lanes where a block has at most 32
# live rows, 16 where it has at most 64, else 8. With P = 256 rows an SM and
# the first LIVE_PER_SM x SMs rows live, every block has LIVE_PER_SM (one
# block an SM) or half of it (two) live: 16 and 48 reach 32 lanes, 48 and 96
# reach 16, 96 and 200 reach 8, whichever the grid is.
LIVE_PER_SM = [16, 48, 96, 200]


def _sms():
    return torch.cuda.get_device_properties(0).multi_processor_count


def _front_rows_live(args, per_sm):
    args = list(args)
    args[3] = torch.arange(args[0].shape[0], device=args[3].device) < per_sm * _sms()
    return args


# (1000, 700): P not a multiple of any lane group; (3000, 5000): N over one
# shared-memory tile of 2048 keypoints
@pytest.mark.parametrize("P,N", [(1, 1), (1000, 700), (3000, 5000), (16384, 2048)])
def test_match_kernel_equals_plain(card, P, N):
    _assert_b1_equal(chip_smoke.b1_inputs(card, P=P, N=N, seed=P))


@pytest.mark.parametrize("per_sm", LIVE_PER_SM)
def test_match_kernel_launches_equal_plain(card, per_sm):
    """Each lane width of the sweep (see LIVE_PER_SM), and the slice's share."""
    _assert_b1_equal(_front_rows_live(chip_smoke.b1_inputs(card, P=256 * _sms(), seed=per_sm), per_sm))
    _assert_b1_equal(chip_smoke.b1_slice_inputs(card))


def test_match_kernel_all_rows_dead(card):
    args = list(chip_smoke.b1_inputs(card, P=2000, N=512, seed=3))
    args[3] = torch.zeros_like(args[3])
    _assert_b1_equal(args)
    idx, best, _ = match_kernel.project_match(*args)
    assert bool((idx == -1).all()) and bool((best == 10000).all())


@pytest.mark.parametrize("per_sm", LIVE_PER_SM)
def test_match_kernel_ties_across_lanes(card, per_sm):
    """Every keypoint has the same descriptor and lies inside every radius,
    so each point's best distance ties over all columns and sits in every
    lane of its group: the merge must return the lowest passing column, at
    each lane width (see LIVE_PER_SM)."""
    rng = np.random.default_rng(7)
    P, N = 256 * _sms(), 300
    desc_b = np.tile(rng.integers(0, 2**32, (1, 8), dtype=np.uint32), (N, 1))
    uv_b = np.full((N, 2), 100.0, np.float32)
    oct_b = np.zeros(N, np.int32)
    valid_b = rng.random(N) < 0.7
    desc_a = np.tile(desc_b[:1], (P, 1))
    desc_a[:, 0] ^= rng.integers(0, 16, P).astype(np.uint32)
    uv_a = (100.0 + rng.normal(0, 1.0, (P, 2))).astype(np.float32)
    oct_a = rng.integers(0, 2, P).astype(np.int32)
    valid_a = rng.random(P) < 0.9
    radius2 = np.full(N, 400.0, np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(card)

    args = _front_rows_live((t(desc_a.view(np.int32)), t(uv_a), t(oct_a), t(valid_a),
                             t(desc_b.view(np.int32)), t(uv_b), t(oct_b), t(valid_b), t(radius2)), per_sm)
    _assert_b1_equal(args)
    idx, best, second = match_kernel.project_match(*args)
    live = args[3]
    assert bool((idx[live] == int(np.argmax(valid_b))).all())
    assert torch.equal(best[live], second[live])


def test_match_kernel_rejects_bad_input(card):
    args = list(chip_smoke.b1_inputs(card, P=64, N=64))
    args[1] = args[1].double()
    with pytest.raises(TypeError):
        match_kernel.project_match(*args)


def _assert_b2_close(card, B, with_depth, iters=10, rounds=4):
    kw = chip_smoke.b2_inputs(card, B=B, seed=B, with_depth=with_depth)
    extra = dict(bf=50.0, has_depth=True) if with_depth else {}
    args = [kw.pop(k) for k in ("pose_init", "pts3d", "uv", "sigma2", "valid")]
    cam = (500.0, 500.0, 320.0, 240.0)
    pose_k, inl_k = lm_kernel.motion_only_lm_fused(
        *args, *cam, **kw, **extra, iters=iters, rounds=rounds)
    pose_p, inl_p = lm_kernel.motion_only_lm_plain(
        *args, *cam, **kw, **extra, iters=iters, rounds=rounds)
    assert float((pose_k - pose_p).abs().max()) < 1e-4
    assert torch.equal(inl_k, inl_p)


@pytest.mark.parametrize("with_depth", [False, True])
# B=200: fewer rows than the block's threads, with 121 valid rows. Fewer
# keypoint rows leave the 6-dof problem ill-posed: at B=70 (6 rows) the plain
# version on the CPU and on the card disagree by ~1e-2, as the kernel does.
# B=2112 is the slice's B; B=5000 needs several rows a thread.
@pytest.mark.parametrize("B", [200, 2112, 5000])
def test_lm_kernel_equals_plain(card, with_depth, B):
    _assert_b2_close(card, B, with_depth)


@pytest.mark.parametrize("with_depth", [False, True])
def test_lm_kernel_second_stage_equals_plain(card, with_depth):
    """The slice's second refine: (iters, rounds) = (10, 2)."""
    _assert_b2_close(card, 2112, with_depth, iters=10, rounds=2)


def test_lm_kernel_rejects_too_many_rows(card):
    limit = lm_kernel._library().motion_only_lm_max_rows()
    kw = chip_smoke.b2_inputs(card, B=limit + 1)
    args = [kw.pop(k) for k in ("pose_init", "pts3d", "uv", "sigma2", "valid")]
    with pytest.raises(ValueError, match="rows"):
        lm_kernel.motion_only_lm_fused(*args, 500.0, 500.0, 320.0, 240.0, **kw)


# C=5, B=2048: candidate verification's batch; C=1, B=16384: the
# brute-force relocalization's arena; C=3, B=200: fewer rows than threads
@pytest.mark.parametrize("C,B", [(5, 2048), (1, 16384), (3, 200)])
def test_lm_kernel_batched_equals_plain(card, C, B):
    args = chip_smoke.b2_batch_inputs(card, C, B)
    cam = (500.0, 500.0, 320.0, 240.0)
    with tracing():
        before = timers.counters()
        pose_k, inl_k = lm_kernel.motion_only_lm_fused_batched(*args, *cam, iters=10, rounds=2)
        after = timers.counters()
    assert [after.get(k, 0) - before.get(k, 0) for k in ("B2", "B2_batched")] == [1, 1]
    pose_p, inl_p = lm_kernel.motion_only_lm_plain_batched(*args, *cam, iters=10, rounds=2)
    assert float((pose_k - pose_p).abs().max()) < 1e-4
    assert torch.equal(inl_k, inl_p)
    # each problem bit-equal to its own single launch
    for c in range(C):
        pose_1, inl_1 = lm_kernel.motion_only_lm_fused(*(a[c] for a in args), *cam, iters=10, rounds=2)
        assert torch.equal(pose_1, pose_k[c]) and torch.equal(inl_1, inl_k[c])


def test_lm_kernel_batched_rejects_bad_input(card):
    args = chip_smoke.b2_batch_inputs(card, 2, 300)
    cam = (500.0, 500.0, 320.0, 240.0)
    with pytest.raises(ValueError, match="shape"):
        lm_kernel.motion_only_lm_fused_batched(args[0], args[1][0], *args[2:], *cam)
    with pytest.raises(ValueError, match="shape"):
        lm_kernel.motion_only_lm_fused_batched(args[0][:1], *args[1:], *cam)
    limit = lm_kernel._library().motion_only_lm_max_rows()
    big = chip_smoke.b2_batch_inputs(card, 1, limit + 1)
    with pytest.raises(ValueError, match="rows"):
        lm_kernel.motion_only_lm_fused_batched(*big, *cam)


def test_match_kernel_equals_plain_at_fuse_inputs(card):
    """The duplicate fusion's call: the whole 16384-point arena against one
    keyframe's 2048 keypoints at a 3 px radius (scaled by octave), the live
    rows in the front of the arena as the map fills it, most rows a noisy
    copy of a keypoint."""
    rng = np.random.default_rng(11)
    args = list(chip_smoke.b1_inputs(card, seed=11))
    P, N = args[0].shape[0], args[4].shape[0]
    src = torch.from_numpy(rng.integers(0, N, P)).to(card)
    flips = np.where(rng.random((P, 8)) < 0.3, 1 << rng.integers(0, 31, (P, 8)), 0).astype(np.int32)
    args[0] = args[4][src] ^ torch.from_numpy(flips).to(card)
    args[1] = args[5][src] + torch.from_numpy(rng.normal(0, 1.5, (P, 2)).astype(np.float32)).to(card)
    args[2] = args[6][src]
    args[3] = torch.from_numpy((np.arange(P) < 4000) & (rng.random(P) < 0.9)).to(card)
    args[8] = (3.0 * 1.2 ** args[6].float()) ** 2
    _assert_b1_equal(args)
    idx, _, _ = match_kernel.project_match(*args)
    assert int((idx >= 0).sum()) > 1000


# -- kernels F1 and F2: the detect stage over every level --------------------


def _mono_frame(seed: int, frame: int = 40) -> np.ndarray:
    """A 640x480 frame of the benchmark's `mono` scene (1600 quads, the
    150-frame arc, the TUM fr1 intrinsics) with this scene seed."""
    from ucoslam_tpu_torch.geometry.camera import CameraParams
    from ucoslam_tpu_torch.io.synthetic import SyntheticSequence

    cam = CameraParams.create(517.3, 516.5, 318.6, 255.3, width=640, height=480)
    return SyntheticSequence(cam=cam, n_points=1600, n_frames=150, seed=seed).render(frame).astype(np.float32)


def _assert_detect_equal(card, img, thresholds=(7.0,), **orb_kw):
    """F1 and F2 on the card against their plain versions on the card, on
    the extractor's packed pyramid of `img`, at each threshold in turn: the
    candidates and every keypoint slot (xy, response, octave, valid,
    patches) bit-equal, one launch of each counted. -> (extractor, pyramid,
    levels, each threshold's outputs)."""
    from ucoslam_tpu_torch.features.orb import BLUR_K, EDGE_MARGIN, PATCH_RADIUS, ORBExtractor

    orb = ORBExtractor(**orb_kw)
    img = torch.as_tensor(img).to(card)
    pyr = orb._pyramid(img)
    levels = pyr(img)
    grid = (orb.cell, orb.k_per_cell)
    rows = (orb.budgets, orb.scales, PATCH_RADIUS + BLUR_K // 2)
    outs = []
    for threshold in thresholds:
        with tracing():
            before = timers.counters()
            cand = fast_kernel.fast_cells(levels, pyr, threshold, *grid, EDGE_MARGIN)
            got = fast_kernel.select_keypoints(levels, pyr, *cand, *grid, *rows)
            after = timers.counters()
        assert {k: after.get(k, 0) - before.get(k, 0) for k in ("F1", "F2")} == {"F1": 1, "F2": 1}
        want_cand = fast_kernel.fast_cells_plain(levels, pyr, threshold, *grid, EDGE_MARGIN)
        want = fast_kernel.select_keypoints_plain(levels, pyr, *want_cand, *grid, *rows)
        for g, w in zip((*cand, *got), (*want_cand, *want)):
            assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)
        outs.append(got)
    return orb, pyr, levels, outs


@pytest.mark.parametrize("seed", [5, 11, 17, 23])
def test_detect_kernels_equal_plain_on_mono_scenes(card, seed):
    """(a) The four `mono` scenes at the library's widths (640x480, 8
    levels, scale 1.2, 2048 keypoints); the packed levels are bit-equal to
    each level's own two matmuls."""
    img = _mono_frame(seed)
    orb, pyr, levels, ((_, _, _, valid, _),) = _assert_detect_equal(card, img)
    assert int(valid.sum()) > 1500
    t = torch.from_numpy(img).to(card)
    for lv in range(1, orb.n_levels):
        ah, aw = pyr.weights[lv]
        assert torch.equal(pyr.level(levels, lv), (ah @ t) @ aw.T)


def test_detect_kernels_equal_plain_with_ties(card):
    """(b) An image quantized to steps of 16: level 0's FAST scores are
    multiples of 16 and tie everywhere, inside cells and across them."""
    orb, _, _, ((_, resp, _, valid, _),) = _assert_detect_equal(card, np.floor(_mono_frame(5) / 16.0) * 16.0)
    level0 = resp[: orb.budgets[0]][valid[: orb.budgets[0]]]
    assert level0.numel() > 500 and level0.unique().numel() <= 16


def test_detect_kernels_equal_plain_nms_cells(card):
    """(c) KPNonMaximaSuppresion's grid: cells of 64, one keypoint a cell."""
    _assert_detect_equal(card, _mono_frame(11), cell=64, k_per_cell=1)


def test_detect_kernels_equal_plain_scaled_detector(card):
    """(d) kptImageScaleFactor 0.5: the frame resized to 240x320 first."""
    from ucoslam_tpu_torch.ops.image import resize_linear

    small = resize_linear(torch.from_numpy(_mono_frame(17)).to(card), (240, 320))
    _assert_detect_equal(card, small)


@pytest.mark.parametrize("crop", [(60, 75), (30, 41)])
def test_detect_kernels_equal_plain_small_images(card, crop):
    """(e) Levels with fewer candidate slots than their budgets (zero
    padding), and, at 30x41, every level smaller than one patch."""
    img = np.ascontiguousarray(_mono_frame(23)[100 : 100 + crop[0], 200 : 200 + crop[1]])
    _assert_detect_equal(card, img)


def test_detect_kernels_follow_the_threshold(card):
    """(f) The threshold changed between two calls on the same levels, as
    autoAdjustKpSensitivity does: each call equals its plain version."""
    dim = np.ascontiguousarray(_mono_frame(5)[:240, :320] * 0.1)  # fewer corners than the budgets
    _, _, _, (hi, lo) = _assert_detect_equal(card, dim, thresholds=(7.0, 3.0))
    assert int(lo[3].sum()) > int(hi[3].sum())


def test_detect_kernels_launch_once_per_frame(card):
    """detect_and_compute launches F1 and F2 once each, in frontend.detect."""
    from ucoslam_tpu_torch.features.orb import ORBExtractor

    orb = ORBExtractor()
    img = torch.from_numpy(_mono_frame(5)).to(card)
    orb.detect_and_compute(img)  # builds and caches the pyramid's matrices
    with tracing():
        timers.drain()
        before = timers.counters()
        orb.detect_and_compute(img)
        after = timers.counters()
        spans = {s.name: s for s in timers.drain()}
    assert {k: after.get(k, 0) - before.get(k, 0) for k in ("F1", "F2")} == {"F1": 1, "F2": 1}
    assert spans["frontend.detect"].counts == {"F1": 1, "F2": 1}


def test_detect_kernels_reject_bad_input(card):
    from ucoslam_tpu_torch.features.orb import EDGE_MARGIN, ORBExtractor

    orb = ORBExtractor()
    img = torch.from_numpy(_mono_frame(5)).to(card)
    pyr = orb._pyramid(img)
    levels = pyr(img)
    n = levels.numel()
    with pytest.raises(TypeError):
        fast_kernel.fast_cells(levels.double(), pyr, 7.0, 32, 4, EDGE_MARGIN)
    with pytest.raises(ValueError):
        fast_kernel.fast_cells(torch.zeros(2 * n, device=card)[::2], pyr, 7.0, 32, 4, EDGE_MARGIN)
    cand = fast_kernel.fast_cells(levels, pyr, 7.0, 32, 4, EDGE_MARGIN)
    budgets = [fast_kernel.MAX_SLOTS + 1] + orb.budgets[1:]
    with pytest.raises(ValueError):
        fast_kernel.select_keypoints(levels, pyr, *cand, 32, 4, budgets, orb.scales, 18)
    # the launcher checks the host's layout: one that does not follow from
    # the shapes and the cell is refused, not read
    lay = fast_kernel._layout(tuple(pyr.shapes), 32, 4)
    args = list(fast_kernel._level_args(levels, pyr, 32, lay))
    args[4] = fast_kernel._ints([g + 1 for g in lay.gw])
    err = fast_kernel._library().fast_cells_launch(
        levels.data_ptr(), *args, 32, 4, EDGE_MARGIN, 7.0, cand[0].data_ptr(), cand[1].data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    assert err == 1  # cudaErrorInvalidValue


def _seeded_map_state(device, seed=0):
    """A MapState at the library's default widths (P=16384, K=256, N=2048)
    with random content: 40 active keyframes observing a third of the
    points, keyframe 1 observing one point twice."""
    from ucoslam_tpu_torch.config import Params
    from ucoslam_tpu_torch.geometry.se3 import se3_exp
    from ucoslam_tpu_torch.mapping.map import empty_map_state, map_state_from_numpy, map_state_to_numpy

    rng = np.random.default_rng(seed)
    a = map_state_to_numpy(empty_map_state(Params().replace(detectMarkers=False), "cpu"))
    K, N, _ = a["kf_desc"].shape
    P = a["pt_pos"].shape[0]
    kf_active = np.arange(K) < 40
    pt_active = np.arange(P) < P // 3
    alive = np.nonzero(pt_active)[0]
    ids = np.where(rng.random((K, N)) < 0.5, rng.choice(alive, (K, N)), -1).astype(np.int32)
    ids[~kf_active] = -1
    ids[1, 5] = ids[1, 9] = alive[3]
    xi = np.c_[rng.normal(0, 0.5, (K, 3)), rng.normal(0, 0.2, (K, 3))].astype(np.float32)
    a.update(
        pt_pos=np.c_[rng.uniform(-3, 3, (P, 2)), rng.uniform(2, 8, P)].astype(np.float32),
        pt_desc=rng.integers(0, 2**32, (P, 8), dtype=np.uint32), pt_active=pt_active,
        kf_pose=se3_exp(torch.from_numpy(xi)).numpy(), kf_fseq=rng.permutation(1000)[:K].astype(np.int32),
        kf_active=kf_active, kf_octave=rng.integers(0, 8, (K, N)).astype(np.int32),
        kf_desc=rng.integers(0, 2**32, (K, N, 8), dtype=np.uint32),
        kf_kpt_valid=(rng.random((K, N)) < 0.9) & kf_active[:, None], kf_ids=ids,
    )
    return map_state_from_numpy(a, device)


def test_update_point_stats_on_card_is_repeatable(card):
    """Two runs on the card are bit-equal (no atomic float sums), and agree
    with the CPU: descriptors exactly, normals and bounds within 1e-6."""
    from ucoslam_tpu_torch.mapping.map import map_state_to_numpy, op_update_point_stats

    want = map_state_to_numpy(op_update_point_stats(_seeded_map_state("cpu"), 1.2, 8))
    st = _seeded_map_state(card)
    a = map_state_to_numpy(op_update_point_stats(st, 1.2, 8))
    b = map_state_to_numpy(op_update_point_stats(st, 1.2, 8))
    for k in want:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        if k in ("pt_normal", "pt_min_dist", "pt_max_dist"):
            np.testing.assert_allclose(a[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(a[k], want[k], err_msg=k)


def _perturbed_map_problem():
    """The BA problem of test_ba_solve_dense_on_card_matches_cpu: a map the
    port built from 29 oracle frames (5 keyframes), all keyframes, the two
    oldest fixed, the points seen by 3 or more, from perturbed points and
    poses. -> (problem, camera, seed generator, point count)."""
    from ucoslam_tpu_torch.config import Params
    from ucoslam_tpu_torch.io.synthetic import SyntheticSequence
    from ucoslam_tpu_torch.optim import ba
    from ucoslam_tpu_torch.slam.system import System

    seq = SyntheticSequence(n_frames=40, seed=1)
    params = Params().replace(maxMapPoints=4096, maxKeyFrames=32, maxKeyPointsPerFrame=512,
                              maxDescDistance=60.0, detectMarkers=False)
    slam = System(params, seq.cam, device="cpu")
    for i in range(29):
        slam.process_frame(seq.frame(i, device="cpu"))
    assert slam.map.n_keyframes >= 5
    problem, _, pt_slots, _ = ba.build_ba_problem(
        slam.map, seq.cam, fixed_kfs=slam.map.keyframes.active_slots()[:2], min_obs=3)
    rng = np.random.default_rng(0)
    pt = problem.pt_pos.numpy()
    problem.pt_pos = torch.from_numpy(pt + (rng.normal(0, 0.02, pt.shape) * np.abs(pt)).astype(np.float32))
    free = (problem.cam_valid & ~problem.cam_fixed).numpy()
    pose = problem.cam_pose.numpy().copy()
    pose[free, :3, 3] += rng.normal(0, 0.01, (int(free.sum()), 3)).astype(np.float32)
    problem.cam_pose = torch.from_numpy(pose)
    return problem, seq.cam, rng, len(pt_slots)


def _on(problem, device):
    import dataclasses

    return dataclasses.replace(problem, **{
        f.name: getattr(problem, f.name).to(device)
        for f in dataclasses.fields(problem) if isinstance(getattr(problem, f.name), torch.Tensor)})


def _assert_card_matches_cpu(got, want):
    for k in ("cam_pose", "pt_pos"):
        w = getattr(want, k)
        d = float((getattr(got, k).cpu() - w).abs().max()) / float(w.abs().max())
        assert d <= 1e-4, f"{k}: card and CPU {d:.3e} apart (relative); cost {got.cost_history[-1]} vs {want.cost_history[-1]}"
    n = int((got.obs_bad.cpu() != want.obs_bad).sum())
    assert n == 0, f"{n} bad associations differ"


def test_ba_solve_dense_on_card_matches_cpu(card):
    """The dense Schur LM on _perturbed_map_problem: the card within 1e-4
    (relative to the largest value) of the CPU, with the same bad
    associations. The bound is held against the problem's own
    conditioning: on the CPU, a start that differs in the last bits of its
    points moves the solution by under 4e-5 (checked here; with the points
    seen twice, or from fewer frames, the problem conditions too poorly
    for the bound)."""
    import dataclasses

    from ucoslam_tpu_torch.optim import ba

    problem, cam, rng, n_pts = _perturbed_map_problem()
    want = ba.ba_solve(problem, cam, iters=10, stages=2)
    nudge = torch.from_numpy((1 + 1e-7 * rng.normal(size=problem.pt_pos.shape)).astype(np.float32))
    nudged = ba.ba_solve(dataclasses.replace(problem, pt_pos=problem.pt_pos * nudge), cam, iters=10, stages=2)
    assert float((nudged.pt_pos - want.pt_pos).abs().max()) < 4e-5
    _assert_card_matches_cpu(ba.ba_solve(_on(problem, card), cam, iters=10, stages=2), want)
    assert n_pts > 200


def _padded_to_128(problem, cam):
    """The problem with invalid, fixed camera slots up to 128 (where
    solver="auto" takes the point-major route)."""
    import dataclasses

    extra = 128 - problem.cam_pose.shape[0]
    pad = lambda x, v: torch.cat([x, x.new_full((extra,) + x.shape[1:], v)])
    return dataclasses.replace(
        problem, cam_pose=torch.cat([problem.cam_pose, torch.eye(4).expand(extra, 4, 4)]),
        cam_fixed=pad(problem.cam_fixed, True), cam_valid=pad(problem.cam_valid, False),
        cam_obs=pad(problem.cam_obs, -1)), cam


@pytest.mark.parametrize("solver,iters,stages", [("auto", 10, 2), ("cg", 4, 1)])
def test_point_major_and_cg_on_card_match_cpu(card, solver, iters, stages, monkeypatch):
    """The point-major solve (the problem padded with invalid, fixed camera
    slots to 128, so solver="auto" routes to it) and the matrix-free CG
    solve of _perturbed_map_problem: the card within 1e-4 (relative) of the
    CPU, the same bad associations. CG is held over its first 4 LM steps:
    later, near the optimum, a step's acceptance turns on cost changes of
    1e-6 relative, and card and CPU took different ones there (1.6e-4 apart
    in points after 10 steps and 2 stages, costs within 4e-6)."""
    import dataclasses

    from ucoslam_tpu_torch.optim import ba, schur_pm

    problem, cam = _padded_to_128(*_perturbed_map_problem()[:2])
    routes = []
    inner = schur_pm.pm_staged_lm
    monkeypatch.setattr(schur_pm, "pm_staged_lm", lambda *a, **k: routes.append(1) or inner(*a, **k))
    want = ba.ba_solve(problem, cam, iters=iters, stages=stages, solver=solver)
    got = ba.ba_solve(_on(problem, card), cam, iters=iters, stages=stages, solver=solver)
    assert routes == ([1, 1] if solver == "auto" else [])
    _assert_card_matches_cpu(got, want)


def test_cg_second_stage_on_card_matches_cpu(card):
    """The CG solve's whole run, both stages, on _perturbed_map_problem with
    every 40th observation moved 12 px (32 of 1100 then demoted by the
    first stage): the card demotes the same observations as the CPU, and
    ends at its cost and poses; its points are held to the spread that
    last-bit nudges of the start give on the CPU (measured here, the
    bound three times the widest of two). The second stage drops the
    demoted observations, which leaves some points seen by one or two
    keyframes: they move by up to 1.2e-2 (relative) under such nudges,
    while the cost moves by under 1e-5 and the poses by under 1e-6."""
    import dataclasses

    from ucoslam_tpu_torch.optim import ba

    problem, cam, _, _ = _perturbed_map_problem()
    uv = problem.obs_uv.clone()
    uv[::40] += 12.0
    problem, cam = _padded_to_128(dataclasses.replace(problem, obs_uv=uv), cam)
    solve = lambda p: ba.ba_solve(p, cam, iters=10, stages=2, solver="cg")
    want = solve(problem)
    rel = lambda a, b: float((a.cpu() - b).abs().max() / b.abs().max())
    spread = 0.0
    for seed in (0, 1):
        nudge = 1 + 1e-7 * np.random.default_rng(seed).normal(size=problem.pt_pos.shape)
        nudged = solve(dataclasses.replace(problem, pt_pos=problem.pt_pos * torch.from_numpy(nudge.astype(np.float32))))
        assert torch.equal(nudged.obs_bad, want.obs_bad)
        spread = max(spread, rel(nudged.pt_pos, want.pt_pos))
    got = solve(_on(problem, card))
    assert int(want.obs_bad.sum()) >= 25
    n = int((got.obs_bad.cpu() != want.obs_bad).sum())
    assert n == 0, f"{n} of {int(want.obs_bad.sum())} demotions differ"
    c_got, c_want = float(got.cost_history[-1]), float(want.cost_history[-1])
    assert abs(c_got - c_want) <= 3e-5 * c_want, (c_got, c_want)
    assert rel(got.cam_pose, want.cam_pose) <= 1e-4
    assert rel(got.pt_pos, want.pt_pos) <= max(1e-4, 3 * spread), (rel(got.pt_pos, want.pt_pos), spread)


def test_quantize_words_card_equals_cpu(card):
    """The 16384-word vocabulary's chunked word search: the card equal to the
    CPU on 2048 seeded descriptors, words duplicated across chunk
    boundaries among them (the lowest word wins on both)."""
    from ucoslam_tpu_torch.io.fbow import default_vocab_path, load_fbow
    from ucoslam_tpu_torch.mapping.frame import tensor_from_numpy
    from ucoslam_tpu_torch.mapping.kfdatabase import quantize_words

    v = load_fbow(default_vocab_path()).desc.copy()
    v[4096], v[8192 + 5] = v[4095], v[5]
    rng = np.random.default_rng(2)
    desc = rng.integers(0, 2**32, (2048, 8), dtype=np.uint32)
    desc[0], desc[1] = v[4095], v[5]
    got = quantize_words(tensor_from_numpy(desc, card), tensor_from_numpy(v, card)).cpu()
    want = quantize_words(tensor_from_numpy(desc, "cpu"), tensor_from_numpy(v, "cpu"))
    assert torch.equal(got, want)
    assert got[0] == 4095 and got[1] == 5


@pytest.mark.parametrize("n_markers", [1, 4, 16])
@pytest.mark.parametrize("iters,rounds", [(10, 4), (10, 2)])
def test_lm_kernel_with_marker_rows_equals_plain(card, n_markers, iters, rounds):
    """B = 2112 rows, the last 64 holding the corners of 1, 4 or 16 live
    markers at the tracker's sigma2_mk: pose within 1e-4, the same mask."""
    kw = chip_smoke.b2_marker_inputs(card, n_markers, seed=n_markers)
    assert int(kw["valid"][-64:].sum()) == 4 * n_markers
    args = (kw["pose_init"], kw["pts3d"], kw["uv"], kw["sigma2"], kw["valid"], 500.0, 500.0, 320.0, 240.0)
    pose_k, mask_k = lm_kernel.motion_only_lm_fused(*args, iters=iters, rounds=rounds)
    pose_p, mask_p = lm_kernel.motion_only_lm_plain(*args, iters=iters, rounds=rounds)
    assert float((pose_k - pose_p).abs().max()) < 1e-4
    assert torch.equal(mask_k, mask_p)


def test_ippe_and_best_pose_from_markers_card_equals_cpu(card):
    """IPPE over two frames' 16 slots and best_pose_from_valid_markers (its
    B2 refine at B=64 included) on the card against the CPU. IPPE computes
    in float64, so the homographies agree within 1e-9, the poses within
    1e-4 where err_ratio >= 1.5 (a far marker among them, whose float32
    pose the two devices put 1.4e-3 apart) and err_ratio within 1e-4
    relative; the pose from the markers (float32, B2) within 1e-3."""
    from ucoslam_tpu_torch.config import Params
    from ucoslam_tpu_torch.io.synthetic import SyntheticSequence
    from ucoslam_tpu_torch.mapping.map import Map
    from ucoslam_tpu_torch.markers.ippe import _homography_4pt, ippe_square_poses, marker_object_points
    from ucoslam_tpu_torch.slam import markermap

    seq = SyntheticSequence(n_frames=30, seed=13, n_markers=3, marker_size=0.5)
    corners = torch.from_numpy(np.stack([seq.frame(i, device="cpu").markers.und_corners for i in (0, 9)]))
    sizes = torch.full((2, 16), 0.5)
    valid = torch.from_numpy(np.stack([seq.frame(i, device="cpu").markers.valid for i in (0, 9)]))
    src = marker_object_points(sizes.double())[..., :2]
    uv = (corners.double() - torch.tensor([seq.cam.cx, seq.cam.cy], dtype=torch.float64)) \
        / torch.tensor([seq.cam.fx, seq.cam.fy], dtype=torch.float64)
    H_card, H_cpu = _homography_4pt(src.to(card), uv.to(card)).cpu(), _homography_4pt(src, uv)
    assert float((H_card - H_cpu)[valid].abs().max()) < 1e-9
    want = ippe_square_poses(corners, sizes, seq.cam)
    got = ippe_square_poses(corners.to(card), sizes.to(card), seq.cam)
    got = [g.cpu()[valid] for g in got]
    want = [w[valid] for w in want]
    ratio_g, ratio_w = got[3] / got[2], want[3] / want[2]
    sel = ratio_w >= 1.5
    assert int(sel.sum()) >= 4
    for k in (0, 1):
        assert float((got[k] - want[k])[sel].abs().max()) < 1e-4, k
    assert float(((ratio_g - ratio_w) / ratio_w).abs().max()) < 1e-4
    params = Params().replace(maxMapPoints=256, maxKeyFrames=8, maxKeyPointsPerFrame=512, aruco_markerSize=0.5)
    poses = {}
    for device in ("cpu", card):
        m = Map(params, device=device)
        for i in (0, 6, 12, 18):
            f = seq.frame(i, device=device)
            f = f.replace(pose_f2g=torch.from_numpy(seq.gt_pose(i)).to(device))
            markermap.record_marker_observations(m, m.add_keyframe(f), f.markers,
                                                 markermap.resolve_marker_slots(m, f.markers))
        assert markermap.update_marker_poses(m, seq.cam, params) == 3
        poses[str(device)] = markermap.best_pose_from_valid_markers(m, seq.frame(24, device="cpu").markers, seq.cam)
    assert np.abs(poses["cpu"] - poses[str(card)]).max() < 1e-3


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
def test_bilinear_sample_card_equals_cpu(card, mode):
    from ucoslam_tpu_torch.ops.image import bilinear_sample

    rng = np.random.default_rng(7)
    img = torch.from_numpy(rng.uniform(0, 255, (2, 480, 640)).astype(np.float32))
    xy = torch.from_numpy(rng.uniform(-3, 643, (2, 2048, 121, 2)).astype(np.float32))  # past every border too
    for args in ((img[0], xy[0]), (img, xy)):  # one image, and a stack each at its own points
        want = bilinear_sample(*args, mode=mode)
        got = bilinear_sample(*(a.to(card) for a in args), mode=mode).cpu()
        if mode == "nearest":
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=0)


@pytest.mark.parametrize("kind", ["stereo", "rgbd"])
def test_depth_frontend_card_equals_cpu(card, kind):
    """stereo_depth (row matching, SAD refinement) and the RGB-D sampling on
    the card against the CPU on the same base frame and right keypoints: the
    same keypoints with depth except at most 1%, depth within 1e-4 relative."""
    from ucoslam_tpu_torch.config import Params as PortParams
    from ucoslam_tpu_torch.geometry.camera import CameraParams
    from ucoslam_tpu_torch.io.synthetic import SyntheticSequence

    cam = CameraParams.create(500.0, 500.0, 320.0, 240.0, width=640, height=480, bl=0.25)
    seq = SyntheticSequence(cam=cam, n_frames=40, n_points=1600, seed=5)
    params = PortParams().replace(detectMarkers=False, maxDescDistance=60.0)
    inputs = {chip_smoke.FRONTEND_FRAME: chip_smoke.depth_input(kind, seq, chip_smoke.FRONTEND_FRAME)}
    c = chip_smoke.frontend_on_shared_arrays(kind, params, cam, inputs, card=card)
    assert c["cpu"] > 100 and c["differ"] <= 0.01 * c["cpu"], c
    assert c["max_rel"] <= 1e-4, c


def test_stereorectify_card_equals_cpu(card):
    from ucoslam_tpu_torch.geometry.camera import CameraParams
    from ucoslam_tpu_torch.geometry.se3 import so3_exp
    from ucoslam_tpu_torch.io.stereorectify import StereoRectify

    cam_l = CameraParams.create(460.0, 460.0, 320.0, 240.0, dist=[0.05, -0.1, 0.001, -0.001, 0.0])
    cam_r = CameraParams.create(455.0, 455.0, 315.0, 242.0, dist=[0.04, -0.08, -0.001, 0.001, 0.0])
    R = so3_exp(torch.tensor([0.01, -0.03, 0.005])).numpy()
    T = np.asarray([-0.11, 0.002, -0.004])
    rng = np.random.default_rng(101)
    left, right = (rng.uniform(0, 255, (480, 640)).astype(np.float32) for _ in range(2))
    on = {str(d): StereoRectify(cam_l, cam_r, R, T, device=d) for d in ("cpu", card)}
    cpu, gpu = on["cpu"], on[str(card)]
    torch.testing.assert_close(gpu.remap_grids().cpu(), cpu.remap_grids(), rtol=1e-5, atol=1e-5)
    for g, c in zip(gpu.rectify(left, right), cpu.rectify(left, right)):
        np.testing.assert_allclose(g, c, atol=1e-3 * 255, rtol=0)


@pytest.mark.parametrize("family", ["FREAK", "SURF"])
def test_descriptor_family_card_equals_cpu(card, family):
    """A FREAK or SURF frame at the library's widths on the card against
    the CPU: the same keypoints but for 1%, and descriptor bits of the
    shared keypoints differing in at most chip_smoke.DESC_BIT_SHARE_TOL (the
    floor the CPU tests hold the port to against the JAX package)."""
    from ucoslam_tpu_torch.geometry.camera import CameraParams
    from ucoslam_tpu_torch.io.synthetic import SyntheticSequence

    cam = CameraParams.create(500.0, 500.0, 320.0, 240.0)
    seq = SyntheticSequence(cam=cam, n_frames=40, n_points=1600, seed=5)
    c = chip_smoke.frames_card_vs_cpu(chip_smoke.descriptor_params(family.lower()), cam, [seq.render(3), seq.render(31)])
    assert c["cpu"] > 2000 and c["one_side"] <= 0.01 * c["cpu"], c
    assert c["bits"] <= chip_smoke.DESC_BIT_SHARE_TOL * 256 * c["shared"], c


def test_vocabulary_trainer_card_equals_cpu(card):
    """train_vocabulary on the card and on the CPU from the same descriptors
    and seed: the same centroids and idf, bit for bit, with empty clusters
    re-seeded on the way (many exact duplicates)."""
    from ucoslam_tpu_torch.features import vocab_trainer

    rng = np.random.default_rng(5)
    base = rng.integers(0, 2**32, (300, 8), dtype=np.uint32)
    desc = base[rng.integers(0, 300, 20000)]
    noisy = rng.random(20000) < 0.5
    desc[noisy] ^= rng.integers(0, 2**32, (int(noisy.sum()), 8), dtype=np.uint32) & rng.integers(
        0, 2**32, (int(noisy.sum()), 8), dtype=np.uint32)
    ids = np.repeat(np.arange(40), 500).astype(np.int32)
    got = vocab_trainer.train_vocabulary(desc, ids, 40, k=1024, iters=3, device=card)
    want = vocab_trainer.train_vocabulary(desc, ids, 40, k=1024, iters=3, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _pm_world(n: int, backend: str, device: str):
    """bench.py's BA problem (cut to 2048 points) point-major in a spawned
    world, the single-device solve on the card, and the problem's arrays."""
    from tools.port import parallel_tasks
    from ucoslam_tpu_torch.optim import schur_pm
    from ucoslam_tpu_torch.parallel.distributed import spawn, to_host

    arrays = chip_smoke.ba_scale_problem(128, 2048, 8)
    problem, cam = chip_smoke.ba_problem_on(arrays, "cuda")
    pm = schur_pm.pm_problem_for(problem)
    single = schur_pm.pm_staged_lm(pm, cam, iters=12, stages=2)
    cam_args = dict(zip(("fx", "fy", "cx", "cy"), chip_smoke.BA_CAMERA))
    got = spawn(parallel_tasks.pm, n, to_host(pm), cam_args, 12, 2, backend=backend, device=device, timeout=300)
    return got, single, arrays


def test_sharded_pm_world_1_nccl(card):
    """A world of one NCCL rank on the card: the all_reduce is a copy, so the
    solve is the single-device one."""
    (got,), single, _ = _pm_world(1, "nccl", "cuda")
    assert got["device"] == "cuda:0"
    costs = single[2].cpu().numpy()
    assert np.max(np.abs(got["costs"] - costs) / costs) <= 1e-5
    assert np.abs(got["cam_pose"] - single[0].cpu().numpy()).max() <= 1e-4


def test_sharded_pm_world_2_gloo_on_one_card(card):
    """Two gloo ranks on cuda:0 (NCCL refuses two ranks on one card). The
    ranks sum the camera system in another order, and this problem leaves
    its scale free (one fixed camera: chip_smoke.py phase 11): the LM path
    wanders along it (steps up to 7.0e-4 apart in cost on the H100), so the
    final cost is held within tests/test_torch_parallel.py's 1e-4 relative,
    every step within 1e-3, and the solution in chip_smoke.ba_gap's
    gauge-free measures (the reprojection's p99 within 0.05 px, points
    within 5% of their depth at p99, rotations within 2e-3) rather than
    pose by pose."""
    got, single, arrays = _pm_world(2, "gloo", "cuda:0")
    assert [r["device"] for r in got] == ["cuda:0", "cuda:0"]
    costs = single[2].cpu().numpy()
    rel = np.abs(got[0]["costs"] - costs) / costs
    assert rel[-1] <= 1e-4 and rel.max() <= 1e-3, rel
    gap = chip_smoke.ba_gap((got[0]["cam_pose"], got[0]["pt_pos"][:2048]),
                            (single[0].cpu().numpy(), single[1].cpu().numpy()), arrays)
    assert gap["reprojection_p99"] < 0.05 and gap["point_p99"] < 0.05 and gap["rotation"] < 2e-3, gap
    assert np.array_equal(got[0]["cam_pose"], got[1]["cam_pose"])


def _busy(ns: int) -> None:
    t = now_ns()
    while now_ns() - t < ns:
        pass


def test_device_trace_puts_each_launch_in_its_span(card):
    """1000 spans, each a 100 us host busy-wait, one spin-kernel launch and
    another 100 us: on the trace's clock, moved by the marker launches, the
    runtime call of every launch lands in its own span, and the marks bound
    the clock's error under 50 us."""
    torch.cuda._sleep(1)
    torch.cuda.synchronize()
    dt = DeviceTrace()
    with tracing():
        timers.drain()
        dt.start()
        for _ in range(1000):
            with timers.span("marker"):
                _busy(100_000)
                torch.cuda._sleep(1)
                _busy(100_000)
        dev = dt.stop()
        spans = timers.drain()
    assert dev.clock_error_ns < 50_000, dev.clock_error_ns
    stats = attribute(spans, dev)
    assert len(spans) == 1000
    assert [stats.get(s.id, {}).get("launches") for s in spans] == [1] * 1000
    assert stats[0]["launches"] == 2 * N_MARKS  # the marks alone lie outside every span


def test_launch_counters_equal_calls(card):
    """B1, B2 and batched B2 launches count in the tracer's counters, each in
    the innermost open span, only while tracing is on."""
    b1 = chip_smoke.b1_inputs(card, P=1000, N=700, seed=1)
    kw = chip_smoke.b2_inputs(card, B=200, seed=2)
    b2 = [kw.pop(k) for k in ("pose_init", "pts3d", "uv", "sigma2", "valid")]
    cam = (500.0, 500.0, 320.0, 240.0)
    batch = chip_smoke.b2_batch_inputs(card, 3, 200)
    before = timers.counters()
    match_kernel.project_match(*b1)  # tracing off: not counted
    with tracing():
        timers.drain()
        with timers.span("outer"):
            for _ in range(3):
                match_kernel.project_match(*b1)
            with timers.span("inner"):
                for _ in range(2):
                    lm_kernel.motion_only_lm_fused(*b2, *cam, **kw)
                lm_kernel.motion_only_lm_fused_batched(*batch, *cam, iters=10, rounds=2)
        spans = {s.name: s for s in timers.drain()}
    after = timers.counters()
    assert {k: after.get(k, 0) - before.get(k, 0) for k in ("B1", "B2", "B2_batched")} == \
        {"B1": 3, "B2": 3, "B2_batched": 1}
    assert spans["outer"].counts == {"B1": 3}
    assert spans["inner"].counts == {"B2": 3, "B2_batched": 1}
