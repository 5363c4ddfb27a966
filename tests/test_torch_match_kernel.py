"""Kernel B1: the port's plain version against the Pallas kernel (interpret
mode), and match_points_to_frame against the reference, on the same numpy
inputs. Exact equality throughout (integer outputs, f32 gates)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucoslam_tpu.geometry.camera import CameraParams as RefCamera
from ucoslam_tpu.mapping.frame import empty_frame as ref_empty_frame
from ucoslam_tpu.matching.projection import match_points_to_frame as ref_match
from ucoslam_tpu.ops.pallas.match_kernel import project_match_pallas
from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.mapping.frame import frame_from_numpy
from ucoslam_tpu_torch.matching.projection import match_points_to_frame
from ucoslam_tpu_torch.ops.cuda import match_kernel
from ucoslam_tpu_torch.utils.timers import timers, tracing

torch.set_num_threads(2)


def make_inputs(P=512, N=768, seed=0):
    """Numpy inputs with gated pairs, all-masked rows and duplicate
    descriptors at nearby keypoints (ties between columns)."""
    rng = np.random.default_rng(seed)
    desc_b = rng.integers(0, 2**32, (N, 8), dtype=np.uint32)
    dup = rng.choice(N, N // 4, replace=False)
    desc_b[dup[1::2]] = desc_b[dup[0::2]]
    uv_b = rng.uniform([0, 0], [640, 480], (N, 2)).astype(np.float32)
    uv_b[dup[1::2]] = uv_b[dup[0::2]] + 1.5
    oct_b = rng.integers(0, 8, N).astype(np.int32)
    valid_b = rng.random(N) < 0.9
    src = rng.integers(0, N, P)
    desc_a = desc_b[src].copy()
    for _ in range(10):
        w, b = rng.integers(0, 8, P), rng.integers(0, 32, P).astype(np.uint32)
        desc_a[np.arange(P), w] ^= np.uint32(1) << b
    uv_a = (uv_b[src] + rng.normal(0, 5.0, (P, 2))).astype(np.float32)
    oct_a = np.clip(oct_b[src] + rng.integers(-2, 3, P), 0, 7).astype(np.int32)
    valid_a = rng.random(P) < 0.85
    uv_a[:16] = -1000.0  # all-masked rows: outside every radius
    radius2 = ((15.0 * 1.2**oct_b) ** 2).astype(np.float32)
    return desc_a, uv_a, oct_a, valid_a, desc_b, uv_b, oct_b, valid_b, radius2


def _torch(args):
    return [torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a) for a in args]


@pytest.mark.parametrize("P,N,seed", [(512, 768, 0), (256, 512, 1)])
def test_plain_matches_pallas_interpret(P, N, seed):
    args = make_inputs(P, N, seed)
    want = project_match_pallas(*map(jnp.asarray, args), interpret=True)
    got = match_kernel.project_match_plain(*_torch(args))
    idx = np.asarray(want[0])
    assert (idx < 0).sum() >= 16, "all-masked rows present"
    ties = (np.asarray(want[1]) == np.asarray(want[2])) & (idx >= 0)
    assert ties.any(), "ties present"
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_wrapper_on_cpu_runs_plain_and_counts_nothing():
    args = _torch(make_inputs(256, 512, 2))
    with tracing():
        before = timers.counters()
        got = match_kernel.project_match(*args)
        assert timers.counters() == before
    want = match_kernel.project_match_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _scene(seed=5, P=600, N=512):
    rng = np.random.default_rng(seed)
    pos = np.c_[rng.uniform(-3, 3, (P, 2)), rng.uniform(3, 9, P)].astype(np.float32)
    desc = rng.integers(0, 2**32, (P, 8), dtype=np.uint32)
    normal = np.zeros((P, 3), np.float32)
    normal[: P // 2] = pos[: P // 2] / np.linalg.norm(pos[: P // 2], axis=1, keepdims=True)
    min_d = rng.uniform(1.0, 3.0, P).astype(np.float32)
    max_d = (min_d * rng.uniform(2.0, 6.0, P)).astype(np.float32)
    active = rng.random(P) < 0.9
    # the frame observes a subset of the points with noise and a few bit flips
    obs = rng.choice(P, N, replace=False)
    uv = np.c_[500 * pos[obs, 0] / pos[obs, 2] + 320, 500 * pos[obs, 1] / pos[obs, 2] + 240]
    uv = (uv + rng.normal(0, 1.0, uv.shape)).astype(np.float32)
    kd = desc[obs].copy()
    kd[np.arange(N), rng.integers(0, 8, N)] ^= np.uint32(1) << rng.integers(0, 32, N).astype(np.uint32)
    frame = dict(
        fseq=np.int32(3), xy=uv, und_xy=uv, octave=rng.integers(0, 4, N).astype(np.int32),
        angle=np.zeros(N, np.float32), response=np.ones(N, np.float32), desc=kd,
        depth=np.zeros(N, np.float32), valid=rng.random(N) < 0.95,
        ids=np.full(N, -1, np.int32), pose_f2g=np.eye(4, dtype=np.float32),
    )
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.02, -0.01, 0.03]
    return (pos, desc, normal, min_d, max_d, active), frame, pose


@pytest.mark.parametrize("thr", [15.0, 37.5])
def test_match_points_to_frame_matches_reference(thr):
    pts, frame_np, pose = _scene()
    ref_cam = RefCamera.create(500.0, 500.0, 320.0, 240.0)
    ref_frame = ref_empty_frame(frame_np["xy"].shape[0])._replace(
        **{k: jnp.asarray(v) for k, v in frame_np.items()}
    )
    want = ref_match(
        *map(jnp.asarray, pts), ref_frame, ref_cam, jnp.asarray(pose),
        jnp.float32(thr), jnp.float32(60.0), jnp.float32(1.2),
    )
    got = match_points_to_frame(
        *_torch(pts), frame_from_numpy(frame_np, "cpu"),
        CameraParams.create(500.0, 500.0, 320.0, 240.0), torch.from_numpy(pose),
        torch.tensor(thr), 60.0, 1.2,
    )
    assert int(want.n_matched) > 50
    np.testing.assert_array_equal(got.kpt_idx.numpy(), np.asarray(want.kpt_idx))
    np.testing.assert_array_equal(got.point_valid.numpy(), np.asarray(want.point_valid))
    assert int(got.n_visible) == int(want.n_visible)
    assert int(got.n_matched) == int(want.n_matched)

