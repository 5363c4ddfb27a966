"""The port's CUDA kernels against their plain versions on the card.

Marked `cuda`: each test skips without a CUDA device. This file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

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


@pytest.mark.parametrize("P,N", [(1, 1), (1000, 700), (16384, 2048)])
def test_match_kernel_equals_plain(card, P, N):
    args = chip_smoke.b1_inputs(card, P=P, N=N, seed=P)
    before = match_kernel.launches
    got = match_kernel.project_match(*args)
    assert match_kernel.launches == before + 1
    want = match_kernel.project_match_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_match_kernel_rejects_bad_input(card):
    args = list(chip_smoke.b1_inputs(card, P=64, N=64))
    args[1] = args[1].double()
    with pytest.raises(TypeError):
        match_kernel.project_match(*args)


@pytest.mark.parametrize("with_depth", [False, True])
# B=200: fewer rows than the block's 256 threads, with 121 valid rows. Fewer
# keypoint rows leave the 6-dof problem ill-posed: at B=70 (6 rows) the plain
# version on the CPU and on the card disagree by ~1e-2, as the kernel does.
@pytest.mark.parametrize("B", [200, 2112])  # and the slice's B
def test_lm_kernel_equals_plain(card, with_depth, B):
    kw = chip_smoke.b2_inputs(card, B=B, seed=B, with_depth=with_depth)
    extra = dict(bf=50.0, has_depth=True) if with_depth else {}
    args = [kw.pop(k) for k in ("pose_init", "pts3d", "uv", "sigma2", "valid")]
    pose_k, inl_k = lm_kernel.motion_only_lm_fused(*args, 500.0, 500.0, 320.0, 240.0, **kw, **extra)
    pose_p, inl_p = lm_kernel.motion_only_lm_plain(*args, 500.0, 500.0, 320.0, 240.0, **kw, **extra)
    assert float((pose_k - pose_p).abs().max()) < 1e-4
    assert torch.equal(inl_k, inl_p)
