"""The port's stereo and RGB-D frontend against the JAX package, on the same
seeded inputs:

- `bilinear_sample` (both modes, points on and past the borders, half-pixel
  ties): exact against the reference run op by op (`jax.disable_jit`), and
  within 2 float32 ulp of the jitted reference, whose CPU compiler fuses
  the bilinear weights' multiply-adds into FMAs;
- `mutual_best` (ties on both axes, all-invalid columns): exact;
- `process_rgbd` on the reference's base frame (the same keypoints) and the
  same uint16 depth image: exact;
- `stereo_depth` on the reference's left frame and right keypoints of a
  rendered pair: the same keypoints with depth, except at most 1% (the SAD
  sums run in another order), depth within 1e-4 relative on the rest;
- the counterparts of tests/test_stereo.py's frontend tests, each also run
  by the reference on the same images: depths that land on the scene, and
  subpixel depth within 1% RMS of the z-buffer (its metric stereo SLAM test
  is in tests/test_torch_depth_slam.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from ucoslam_tpu.config import Params as RefParams
from ucoslam_tpu.features import frame_extractor as ref_fe
from ucoslam_tpu.io.synthetic import SyntheticSequence as RefSequence
from ucoslam_tpu.ops import hamming as ref_hamming
from ucoslam_tpu.ops import image as ref_image
from ucoslam_tpu_torch.config import Params
from ucoslam_tpu_torch.features import frame_extractor as fe
from ucoslam_tpu_torch.io.synthetic import SyntheticSequence
from ucoslam_tpu_torch.mapping.frame import frame_from_numpy
from ucoslam_tpu_torch.ops import hamming, image

torch.set_num_threads(2)

PARAMS = Params().replace(maxMapPoints=4096, maxKeyFrames=32, maxKeyPointsPerFrame=512, maxDescDistance=60.0,
                          detectMarkers=False, nOctaveLevels=4)
REF_PARAMS = RefParams.from_dict(PARAMS.to_dict())
PAIR_SCENE = dict(n_frames=4, seed=31, n_points=600)


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(np.array(a.view(np.int32) if a.dtype == np.uint32 else a))


def _port_frame(f):
    return frame_from_numpy({k: np.asarray(v) for k, v in f._asdict().items() if k != "markers"}, "cpu")


@pytest.fixture(scope="module")
def scenes():
    return SyntheticSequence(**PAIR_SCENE), RefSequence(**PAIR_SCENE)


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
def test_bilinear_sample_exact(mode):
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (48, 64)).astype(np.float32)
    xy = np.concatenate([
        rng.uniform(-3, 67, (400, 2)),  # inside and past every border
        np.stack(np.meshgrid(np.arange(-1.5, 65.0, 0.5), [0.5, 46.5, 47.0]), -1).reshape(-1, 2),  # half-pixel ties
        [[0, 0], [63, 47], [62.999, 46.999], [64, 48], [-0.5, -0.5]],
    ]).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(ref_image.bilinear_sample(jnp.asarray(img), jnp.asarray(xy), mode=mode))
    got = image.bilinear_sample(torch.from_numpy(img), torch.from_numpy(xy), mode=mode).numpy()
    np.testing.assert_array_equal(got, want)
    jitted = np.asarray(ref_image.bilinear_sample(jnp.asarray(img), jnp.asarray(xy), mode=mode))
    np.testing.assert_allclose(got, jitted, rtol=2 * np.finfo(np.float32).eps, atol=0)
    # a stack of images, each at its own points: each as sampled alone
    img2 = rng.uniform(0, 255, (48, 64)).astype(np.float32)
    xy2 = xy[::-1].copy()
    both = image.bilinear_sample(torch.from_numpy(np.stack([img, img2])), torch.from_numpy(np.stack([xy, xy2])),
                                 mode=mode).numpy()
    np.testing.assert_array_equal(both[0], got)
    np.testing.assert_array_equal(both[1], image.bilinear_sample(torch.from_numpy(img2), torch.from_numpy(xy2),
                                                                 mode=mode).numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mutual_best_exact(seed):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 6, (40, 30)).astype(np.int32)  # many ties on both axes
    d[:, rng.choice(30, 5, replace=False)] = ref_hamming.INVALID_DIST  # all-invalid columns
    d[rng.choice(40, 4, replace=False)] = ref_hamming.INVALID_DIST  # all-invalid rows
    want = np.asarray(ref_hamming.mutual_best(jnp.asarray(d)))
    got = hamming.mutual_best(torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want >= 0).any() and (want < 0).any()


def test_process_rgbd_exact(scenes):
    """The port's depth sampling on the reference's base frame: exact."""
    seq, ref_seq = scenes
    img, z = seq.render_with_depth(1)
    ref_img, ref_z = ref_seq.render_with_depth(1)
    np.testing.assert_array_equal(z, ref_z)
    raw = np.clip(z * 5000.0, 0, 65535).astype(np.uint16)
    ref_ext = ref_fe.FrameExtractor(REF_PARAMS, ref_seq.cam)
    want = ref_ext.process_rgbd(ref_img, raw, 1)
    ext = fe.FrameExtractor(PARAMS, seq.cam, "cpu")
    base = _port_frame(want._replace(depth=jnp.zeros_like(want.depth)))
    ext._base_frame = lambda img, fseq: (base, None)
    got = ext.process_rgbd(img, raw, 1)
    np.testing.assert_array_equal(got.depth.numpy(), np.asarray(want.depth))
    assert (np.asarray(want.depth) > 0).sum() > 100


@pytest.mark.parametrize("frame", [0, 3])
def test_stereo_depth_on_shared_inputs(scenes, frame):
    seq, ref_seq = scenes
    left, right = seq.render_stereo(frame)
    ref_left, ref_right = ref_seq.render_stereo(frame)
    np.testing.assert_array_equal(left, ref_left)
    np.testing.assert_array_equal(right, ref_right)
    ref_ext = ref_fe.FrameExtractor(REF_PARAMS, ref_seq.cam)
    f = ref_ext._base_frame(ref_left, frame)
    gl, gr = ref_image.rgb_to_gray(jnp.asarray(ref_left)), ref_image.rgb_to_gray(jnp.asarray(ref_right))
    kr = ref_ext.orb.detect_and_compute(gr)
    cam = ref_seq.cam
    want = np.asarray(ref_fe._stereo_depth(
        f, gl, gr, kr.xy, kr.desc, kr.octave, kr.valid, jnp.float32(cam.bf), jnp.float32(cam.bf / cam.bl),
        jnp.float32(PARAMS.maxDescDistance)))
    pc = seq.cam
    got = fe.stereo_depth(
        _port_frame(f), _t(gl), _t(gr), _t(kr.xy), _t(kr.desc), _t(kr.octave), _t(kr.valid), pc.bf,
        float(np.float32(pc.bf) / np.float32(pc.bl)), PARAMS.maxDescDistance).numpy()
    a, b = want > 0, got > 0
    assert a.sum() > 100
    assert (a ^ b).sum() <= 0.01 * a.sum()
    both = a & b
    np.testing.assert_allclose(got[both], want[both], rtol=1e-4, atol=0)


def test_stereo_depth_from_row_matching(scenes):
    """Counterpart of test_stereo.py's: > 100 depths, which put the keypoints
    near a true scene point (median < 0.4), in both packages."""
    seq, ref_seq = scenes
    left, right = seq.render_stereo(0)
    T_inv = np.linalg.inv(seq.gt_pose(0))
    tree = cKDTree(seq.points)
    got = fe.FrameExtractor(PARAMS, seq.cam, "cpu").process_stereo(left, right, 0)
    want = ref_fe.FrameExtractor(REF_PARAMS, ref_seq.cam).process_stereo(left, right, 0)
    counts = []
    for uv, depth, valid in ((got.und_xy.numpy(), got.depth.numpy(), got.valid.numpy()),
                             (np.asarray(want.und_xy), np.asarray(want.depth), np.asarray(want.valid))):
        sel = valid & (depth > 0)
        counts.append(int(sel.sum()))
        assert sel.sum() > 100, f"only {sel.sum()} stereo depths"
        cam_pts = seq.cam.unproject(torch.from_numpy(uv[sel]), torch.from_numpy(depth[sel])).numpy()
        dist, _ = tree.query(cam_pts @ T_inv[:3, :3].T + T_inv[:3, 3])
        assert np.median(dist) < 0.4, f"median nearest-scene distance {np.median(dist)}"
    # the ORB passes differ in a few keypoints (test_torch_frontend.py), so the counts agree within 5%
    assert abs(counts[0] - counts[1]) <= 0.05 * counts[1], counts


def test_stereo_subpixel_depth_accuracy():
    """Counterpart of test_stereo.py's metric gate: relative depth RMS < 1%
    against the z-buffer on surface-interior keypoints out to 20x the
    baseline (0.3 m), in both packages."""
    import dataclasses

    scene = dict(PAIR_SCENE)
    seq, ref_seq = SyntheticSequence(**scene), RefSequence(**scene)
    seq.cam = dataclasses.replace(seq.cam, bl=0.3)
    ref_seq.cam = ref_seq.cam._replace(bl=0.3)
    port_ext = fe.FrameExtractor(PARAMS, seq.cam, "cpu")
    ref_ext = ref_fe.FrameExtractor(REF_PARAMS, ref_seq.cam)
    rels = {"port": [], "ref": []}
    for i in range(seq.n_frames):
        left, right = seq.render_stereo(i)
        _, dep = seq.render_with_depth(i)
        got = port_ext.process_stereo(left, right, i)
        want = ref_ext.process_stereo(left, right, i)
        for name, xy, depth, valid in (("port", got.xy.numpy(), got.depth.numpy(), got.valid.numpy()),
                                       ("ref", np.asarray(want.xy), np.asarray(want.depth), np.asarray(want.valid))):
            xi = np.clip(np.round(xy[:, 0]).astype(int), 2, dep.shape[1] - 3)
            yi = np.clip(np.round(xy[:, 1]).astype(int), 2, dep.shape[0] - 3)
            neigh = np.stack([dep[yi + dy, xi + dx] for dy in range(-2, 3) for dx in range(-2, 3)], -1)
            flat = (neigh > 0).all(-1) & ((neigh.max(-1) - neigh.min(-1)) < 0.02 * neigh.min(-1).clip(1e-6))
            true_d = neigh.mean(-1)
            sel = valid & (depth > 0) & flat & (true_d < 20.0 * 0.3)
            rels[name].append((depth[sel] - true_d[sel]) / true_d[sel])
    for name, r in rels.items():
        rel = np.concatenate(r)
        assert len(rel) > 40, f"{name}: only {len(rel)} interior stereo depths"
        rms = float(np.sqrt(np.mean(rel**2)))
        assert rms < 0.01, f"{name}: relative depth RMS {rms:.4f} at <= 20x baseline"
