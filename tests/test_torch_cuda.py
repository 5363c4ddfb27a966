"""The port's CUDA kernels against their plain versions on the card.

Marked `cuda`: each test skips without a CUDA device. This file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import chip_smoke
from ucoslam_tpu_torch.ops.cuda import lm_kernel, match_kernel
from ucoslam_tpu_torch.slam.system import disable_tf32

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    disable_tf32()
    return torch.device("cuda")


def _assert_b1_equal(args):
    before = match_kernel.launches
    got = match_kernel.project_match(*args)
    assert match_kernel.launches == before + 1
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
