"""The port's PnP RANSAC and batched kernel B2 against the JAX package, on
the CPU.

- `pnp_ransac` on tests/test_pnp.py::TestRansac's problems, with the
  reference's own draws (its `jax.random.split` / `categorical` calls,
  rebuilt here) handed to the port as `sample_idx`: the best hypothesis
  supports as many inliers, the refined inlier counts are within 1 and the
  poses within 1e-3; garbage input fails without NaN, and so does a
  rank-deficient draw.
- `_dlt_pose` does not depend on the sign of the eigenvector: the
  hypotheses the reference gets right, the port gets right too (but for a
  few near-degenerate draws), and half as many again (the reference loses
  those whose null vector comes out negative; see optim/pnp.py).
- `motion_only_lm_plain_batched` (the CPU path of the batched B2) against
  `jax.vmap` of the Pallas kernel in interpret mode at C=3: poses within
  1e-4 and the same inlier masks; on CPU tensors the batched wrapper runs
  it and launches nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_lm_kernel import CX, CY, FX, FY, _scene
from ucoslam_tpu.geometry import CameraParams as RefCamera
from ucoslam_tpu.geometry import se3_apply, se3_exp
from ucoslam_tpu.ops.pallas.lm_kernel import motion_only_lm_fused as ref_fused
from ucoslam_tpu.optim.pnp import _dlt_pose as ref_dlt_pose
from ucoslam_tpu.optim.pnp import pnp_ransac as ref_pnp_ransac
from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.ops.cuda import lm_kernel
from ucoslam_tpu_torch.optim.pnp import _dlt_pose, pnp_ransac
from ucoslam_tpu_torch.utils.timers import timers, tracing

torch.set_num_threads(2)

REF_CAM = RefCamera.create(500.0, 500.0, 320.0, 240.0, width=640, height=480)
CAM = CameraParams.create(500.0, 500.0, 320.0, 240.0, width=640, height=480)


def ref_sample_idx(key, valid, n_hypotheses=256, sample_size=6):
    """The rows the reference's pnp_ransac draws with `key`."""
    logits = jnp.where(jnp.asarray(valid), 0.0, -1e9)
    keys = jax.random.split(key, n_hypotheses)
    idx = jax.vmap(lambda k: jax.random.categorical(k, logits, shape=(sample_size,)))(keys)
    return np.asarray(idx).astype(np.int64)


def scene(rng, n, outliers=0.0, invalid=0.0):
    """tests/test_pnp.py's scene, with outliers and invalid rows."""
    X = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    X[:, 2] = rng.uniform(3, 10, n)
    T = se3_exp(jnp.asarray((0.1, -0.05, 0.02, 0.03, -0.02, 0.01), jnp.float32))
    uv = np.asarray(REF_CAM.project(se3_apply(T, jnp.asarray(X)))).copy()
    out = rng.random(n) < outliers
    uv[out] = rng.uniform(0, 640, (int(out.sum()), 2))
    sigma2 = (1.2 ** (2 * rng.integers(0, 3, n))).astype(np.float32)
    return X, uv.astype(np.float32), sigma2, rng.random(n) >= invalid, np.asarray(T)


def run_both(X, uv, sigma2, valid, key):
    ref = ref_pnp_ransac(jnp.asarray(X), jnp.asarray(uv), jnp.asarray(sigma2), jnp.asarray(valid), REF_CAM, key)
    idx = ref_sample_idx(key, valid)
    got = pnp_ransac(torch.from_numpy(X), torch.from_numpy(uv), torch.from_numpy(sigma2), torch.from_numpy(valid),
                     CAM, torch.from_numpy(idx))
    return ref, got, idx


@pytest.mark.parametrize("n,outliers,invalid,seed", [(200, 0.4, 0.0, 0), (100, 0.0, 0.0, 7), (300, 0.3, 0.2, 3)])
def test_pnp_ransac_matches_reference(n, outliers, invalid, seed):
    rng = np.random.default_rng(21 + seed)
    X, uv, sigma2, valid, T = scene(rng, n, outliers, invalid)
    ref, got, idx = run_both(X, uv, sigma2, valid, jax.random.PRNGKey(seed))
    assert abs(int(got.n_inliers) - int(ref.n_inliers)) <= 1
    assert int(ref.n_inliers) > 0.5 * valid.sum() * (1 - outliers)
    np.testing.assert_allclose(got.pose_f2g.numpy(), np.asarray(ref.pose_f2g), atol=1e-3)
    assert int((got.inliers.numpy() != np.asarray(ref.inliers)).sum()) <= 1
    # the best hypothesis: the reference's best-supported, scored as both score
    uvn = np.stack([(uv[:, 0] - 320.0) / 500.0, (uv[:, 1] - 240.0) / 500.0], -1).astype(np.float32)
    hyp_ref = np.asarray(jax.vmap(ref_dlt_pose)(jnp.asarray(X[idx]), jnp.asarray(uvn[idx])))
    hyp = _dlt_pose(torch.from_numpy(X[idx]), torch.from_numpy(uvn[idx])).numpy()

    def support(P):
        q = X @ P[:3, :3].T + P[:3, 3]
        r = np.stack([500 * q[:, 0] / q[:, 2] + 320, 500 * q[:, 1] / q[:, 2] + 240], -1) - uv
        return int((valid & ((r * r).sum(-1) / sigma2 < 5.991) & (q[:, 2] > 0)).sum())

    best_ref = max(support(P) for P in hyp_ref)
    best = max(support(P) for P in hyp)
    assert best >= best_ref - 1


def test_dlt_pose_independent_of_eigenvector_sign():
    rng = np.random.default_rng(21)
    X, uv, _, valid, T = scene(rng, 200)
    idx = ref_sample_idx(jax.random.PRNGKey(0), valid)
    uvn = np.stack([(uv[:, 0] - 320.0) / 500.0, (uv[:, 1] - 240.0) / 500.0], -1).astype(np.float32)
    hyp_ref = np.asarray(jax.vmap(ref_dlt_pose)(jnp.asarray(X[idx]), jnp.asarray(uvn[idx])))
    hyp = _dlt_pose(torch.from_numpy(X[idx]), torch.from_numpy(uvn[idx])).numpy()
    good_ref = np.abs(hyp_ref - T).max((1, 2)) < 0.05
    good = np.abs(hyp - T).max((1, 2)) < 0.05
    assert good_ref.sum() > 50
    # the hypotheses the reference gets right, but for a few near-degenerate
    # draws where two float32 eigensolvers part ...
    assert (good & good_ref).sum() >= 0.9 * good_ref.sum()
    # ... and the ones its eigenvector sign lost
    assert good.sum() > 1.5 * good_ref.sum()


def test_pnp_ransac_fails_gracefully():
    rng = np.random.default_rng(22)
    X = rng.uniform(-2, 2, (100, 3)).astype(np.float32)
    uv = rng.uniform(0, 640, (100, 2)).astype(np.float32)
    valid = np.ones(100, bool)
    ref, got, _ = run_both(X, uv, np.ones(100, np.float32), valid, jax.random.PRNGKey(1))
    assert int(got.n_inliers) < 30 and int(ref.n_inliers) < 30
    assert np.isfinite(got.pose_f2g.numpy()).all()
    # every hypothesis drawn from one row twice over: rank-deficient systems
    Xs, uvs, s2, v, _ = scene(rng, 50)
    idx = np.zeros((256, 6), np.int64)
    idx[:, 3:] = 1
    res = pnp_ransac(torch.from_numpy(Xs), torch.from_numpy(uvs), torch.from_numpy(s2), torch.from_numpy(v), CAM,
                     torch.from_numpy(idx))
    assert np.isfinite(res.pose_f2g.numpy()).all()


def test_batched_plain_matches_vmapped_pallas():
    scenes = [_scene(seed=s)[0] for s in (7, 11, 13)]
    stack = {k: np.stack([sc[k] for sc in scenes]) for k in scenes[0]}
    names = ("pose_init", "pts3d", "uv", "sigma2", "valid")
    ref_pose, ref_inl = jax.vmap(
        lambda p, x, u, s, v: ref_fused(p, x, u, s, v, FX, FY, CX, CY, iters=10, rounds=2, interpret=True)
    )(*(jnp.asarray(stack[k]) for k in names))
    with tracing():
        before = timers.counters()
        pose, inl = lm_kernel.motion_only_lm_fused_batched(
            *(torch.from_numpy(stack[k]) for k in names), FX, FY, CX, CY, iters=10, rounds=2
        )
        assert timers.counters() == before  # CPU tensors: the plain version
    assert np.abs(pose.numpy() - np.asarray(ref_pose)).max() < 1e-4
    np.testing.assert_array_equal(inl.numpy(), np.asarray(ref_inl))
    # problem by problem, the same as the single plain version
    for c in range(3):
        p1, i1 = lm_kernel.motion_only_lm_plain(*(torch.from_numpy(stack[k][c]) for k in names), FX, FY, CX, CY,
                                                iters=10, rounds=2)
        assert torch.equal(p1, pose[c]) and torch.equal(i1, inl[c])


def test_dlt_pose_far_from_the_world_origin():
    """The DLT of points a few of their spreads from the world origin (a map
    far from where it started, as the 150-frame `loop` run's): exact
    projections, and nearly every hypothesis must be the true pose. In
    float32 the null vector of A^T A is lost there (none of 256 right at an
    offset of (20, 10, 30)); the port computes it in float64. The
    reference's float32 DLT is printed beside it (a fault there too)."""
    rng = np.random.default_rng(5)
    offset = np.array([20.0, 10.0, 30.0], np.float32)
    X = (rng.uniform(-2, 2, (300, 3)) + offset).astype(np.float32)
    T = np.asarray(se3_exp(jnp.asarray((0.1, -0.05, 0.02, 0.03, -0.02, 0.01), jnp.float32))).copy()
    T[:3, 3] += -T[:3, :3] @ offset + np.array([0.0, 0.0, 6.0], np.float32)
    q = X @ T[:3, :3].T + T[:3, 3]
    uv = np.stack([500 * q[:, 0] / q[:, 2] + 320, 500 * q[:, 1] / q[:, 2] + 240], -1).astype(np.float32)
    uvn = np.stack([(uv[:, 0] - 320.0) / 500.0, (uv[:, 1] - 240.0) / 500.0], -1).astype(np.float32)
    idx = rng.integers(0, 300, (256, 6))
    hyp = _dlt_pose(torch.from_numpy(X[idx]), torch.from_numpy(uvn[idx]))
    assert hyp.dtype == torch.float32
    good = np.abs(hyp.numpy() - T).max((1, 2)) < 0.01
    hyp_ref = np.asarray(jax.vmap(ref_dlt_pose)(jnp.asarray(X[idx]), jnp.asarray(uvn[idx])))
    print(f"hypotheses right: port {good.sum()} / 256, reference {(np.abs(hyp_ref - T).max((1, 2)) < 0.01).sum()}")
    assert good.sum() >= 0.9 * 256
    # and RANSAC finds every row an inlier
    res = pnp_ransac(torch.from_numpy(X), torch.from_numpy(uv), torch.ones(300), torch.ones(300, dtype=torch.bool),
                     CAM, torch.from_numpy(idx))
    assert int(res.n_inliers) == 300
