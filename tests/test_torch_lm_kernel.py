"""Kernel B2: the port's plain version against the Pallas kernel (interpret
mode) on the same numpy inputs, mono and stereo, as
tests/test_pnp.py::TestFusedLMKernel runs the reference. Pose within 1e-4
(float32 sums in another order) and the same inlier mask."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucoslam_tpu.ops.pallas.lm_kernel import motion_only_lm_fused as ref_fused
from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.geometry.se3 import se3_exp
from ucoslam_tpu_torch.ops.cuda import lm_kernel
from ucoslam_tpu_torch.optim.pnp import motion_only_lm
from ucoslam_tpu_torch.utils.timers import timers, tracing

torch.set_num_threads(2)

FX, FY, CX, CY = 500.0, 500.0, 320.0, 240.0


def _scene(n=257, seed=7, outlier_frac=0.2):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    X[:, 2] = rng.uniform(3, 10, n)
    T_true = se3_exp(torch.tensor([0.1, -0.05, 0.02, 0.03, -0.02, 0.01])).numpy()
    q = X @ T_true[:3, :3].T + T_true[:3, 3]
    uv = np.c_[FX * q[:, 0] / q[:, 2] + CX, FY * q[:, 1] / q[:, 2] + CY]
    uv += rng.normal(0, 0.4, uv.shape)
    out = rng.random(n) < outlier_frac
    uv[out] += rng.uniform(25, 90, (int(out.sum()), 2))
    sigma2 = (1.2 ** (2 * rng.integers(0, 4, n))).astype(np.float32)
    valid = rng.random(n) < 0.95
    T0 = se3_exp(torch.tensor([0.08, -0.03, 0.0, 0.02, 0.0, 0.0])).numpy()
    return dict(
        pose_init=T0.astype(np.float32), pts3d=X, uv=uv.astype(np.float32),
        sigma2=sigma2, valid=valid,
    ), T_true, q[:, 2].astype(np.float32)


def _run_both(kw, depth=None, bf=None, rounds=4):
    has_depth = depth is not None
    ref_pose, ref_inl = ref_fused(
        *(jnp.asarray(kw[k]) for k in ("pose_init", "pts3d", "uv", "sigma2", "valid")),
        FX, FY, CX, CY, depth=None if depth is None else jnp.asarray(depth), bf=bf,
        rounds=rounds, has_depth=has_depth, interpret=True,
    )
    pose, inl = lm_kernel.motion_only_lm_plain(
        *(torch.from_numpy(kw[k]) for k in ("pose_init", "pts3d", "uv", "sigma2", "valid")),
        FX, FY, CX, CY, depth=None if depth is None else torch.from_numpy(depth), bf=bf,
        rounds=rounds, has_depth=has_depth,
    )
    return (np.asarray(ref_pose), np.asarray(ref_inl)), (pose.numpy(), inl.numpy())


@pytest.mark.parametrize("seed,rounds", [(7, 4), (11, 2)])
def test_plain_matches_pallas_mono(seed, rounds):
    kw, T_true, _ = _scene(seed=seed)
    (rp, ri), (pp, pi) = _run_both(kw, rounds=rounds)
    assert np.abs(pp - rp).max() < 1e-4
    np.testing.assert_array_equal(pi, ri)
    assert np.abs(pp - T_true).max() < 0.01  # it converged


def test_plain_matches_pallas_stereo():
    rng = np.random.default_rng(11)
    kw, _, z = _scene(seed=11)
    depth = np.where(rng.random(len(z)) < 0.4, 0.0, z).astype(np.float32)
    (rp, ri), (pp, pi) = _run_both(kw, depth=depth, bf=0.1 * 500.0)
    assert np.abs(pp - rp).max() < 1e-4
    np.testing.assert_array_equal(pi, ri)


def test_motion_only_lm_dispatch_on_cpu():
    kw, _, _ = _scene(seed=3)
    t = {k: torch.from_numpy(v) for k, v in kw.items()}
    with tracing():
        before = timers.counters()
        res = motion_only_lm(
            t["pose_init"], t["pts3d"], t["uv"], t["sigma2"], t["valid"],
            CameraParams.create(FX, FY, CX, CY),
        )
        assert timers.counters() == before
    pose, inl = lm_kernel.motion_only_lm_plain(
        t["pose_init"], t["pts3d"], t["uv"], t["sigma2"], t["valid"], FX, FY, CX, CY
    )
    assert torch.equal(res.pose_f2g, pose) and torch.equal(res.inliers, inl)
    assert int(res.n_inliers) == int(inl.sum())

