"""The port's frontend against the reference on the same rendered images:
renderer, image ops, FAST/NMS/top-k, and the ORB frame ingest.

Measured on this suite's frames (seed 13 sequence, 640x480, CPU): keypoint
sets (x, y, octave) agree 99.61-100% (intersection over union) at 4 levels
x 512 keypoints, and 99.42-99.80% at the library's 8 levels x 2048;
descriptor bits on the shared keypoints agree 100% in both. The floors below
are 99% and 98%. The float32 pyramid sums run in another order in each
framework, so a FAST score at the threshold or a tie in the grid selection
can tip, and a bit whose two bf16 samples are one rounding step apart can
flip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucoslam_tpu.config import Params
from ucoslam_tpu.features.frame_extractor import FrameExtractor as RefExtractor
from ucoslam_tpu.features.orb import ORBExtractor as RefORB
from ucoslam_tpu.geometry.camera import CameraParams as RefCamera
from ucoslam_tpu.io.synthetic import SyntheticSequence as RefSequence
from ucoslam_tpu.ops import fast as ref_fast
from ucoslam_tpu.ops import image as ref_image
from ucoslam_tpu_torch.config import Params as PortParams
from ucoslam_tpu_torch.features.frame_extractor import FrameExtractor
from ucoslam_tpu_torch.features.orb import BLUR_K, EDGE_MARGIN, PATCH_RADIUS, ORBExtractor
from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.io.synthetic import SyntheticSequence
from ucoslam_tpu_torch.ops import fast, image
from ucoslam_tpu_torch.ops.cuda import fast_kernel
from ucoslam_tpu_torch.utils.timers import timers, tracing

torch.set_num_threads(2)

SEQ = dict(n_frames=12, seed=13, n_points=700, motion_scale=0.6, roll_deg=12.0,
           brightness_drift=0.15)
FRAMES = (0, 5, 11)


@pytest.fixture(scope="module")
def seqs():
    ref = RefSequence(cam=RefCamera.create(500.0, 500.0, 320.0, 240.0), **SEQ)
    port = SyntheticSequence(cam=CameraParams.create(500.0, 500.0, 320.0, 240.0), **SEQ)
    return ref, port


def test_render_byte_identical(seqs):
    ref, port = seqs
    np.testing.assert_array_equal(port.gt_positions(), ref.gt_positions())
    for i in FRAMES:
        a, b = port.render(i), ref.render(i)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        np.testing.assert_array_equal(port.gt_pose(i), ref.gt_pose(i))


def test_image_ops_match(seqs):
    img = seqs[1].render(5).astype(np.float32)  # float64 under brightness drift
    t, j = torch.from_numpy(img), jnp.asarray(img)
    bgr = np.stack([img, img * 0.5, img * 0.25], -1)
    np.testing.assert_allclose(
        image.rgb_to_gray(torch.from_numpy(bgr)).numpy(),
        np.asarray(ref_image.rgb_to_gray(jnp.asarray(bgr))), rtol=1e-6, atol=1e-4)
    pyr = image.Pyramid(*t.shape, 4, 1.2, t.device)
    levels = pyr(t)
    for lv, b in enumerate(ref_image.build_pyramid(j, 4, 1.2)):
        a = pyr.level(levels, lv)
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(
        image.gaussian_blur(t).numpy(), np.asarray(ref_image.gaussian_blur(j)), rtol=1e-5, atol=1e-3)
    xy = np.random.default_rng(0).uniform([0, 0], [640, 480], (50, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        image.extract_patches(t, torch.from_numpy(xy), 18).numpy(),
        np.asarray(ref_image.extract_patches(j, jnp.asarray(xy), 18)))


def test_fast_nms_topk_exact(seqs):
    """On the same input image the detector stages are exact, ties included."""
    img = seqs[1].render(11).astype(np.float32)
    t, j = torch.from_numpy(img), jnp.asarray(img)
    s_port, s_ref = fast.fast_score_map(t, 7.0), ref_fast.fast_score_map(j, 7.0)
    np.testing.assert_array_equal(s_port.numpy(), np.asarray(s_ref))
    n_port, n_ref = fast.nms3x3(s_port), ref_fast.nms3x3(s_ref)
    np.testing.assert_array_equal(n_port.numpy(), np.asarray(n_ref))
    # quantized scores force many equal values: the order must still agree
    q = np.floor(np.asarray(n_ref) / 8.0).astype(np.float32)
    vals, idx = fast.cell_topk(torch.from_numpy(q), 32, 4)
    for got, want in zip(fast.grid_topk(vals, idx, -(-q.shape[1] // 32), 32, 300),
                         ref_fast.topk_grid(jnp.asarray(q), 32, 4, 300)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the detect stage over every level (kernels F1 and F2's plain versions) --

# (image crop, cell, k_per_cell, threshold, levels): the library's frame;
# the non-maxima-suppression cells; a crop whose levels have fewer candidate
# slots than their budgets and whose last level is smaller than a patch
DETECT_CASES = [((480, 640), 32, 4, 7.0, 8), ((480, 640), 64, 1, 7.0, 8), ((60, 75), 32, 4, 3.0, 4)]


def _detect_all_levels(orb, img):
    """The port's detect stage as the extractor runs it: the packed pyramid,
    then F1 and F2 (the plain versions on a CPU tensor)."""
    pyr = orb._pyramid(img)
    levels = pyr(img)
    cand = fast_kernel.fast_cells(levels, pyr, orb.fast_threshold, orb.cell, orb.k_per_cell, EDGE_MARGIN)
    return pyr, levels, fast_kernel.select_keypoints(levels, pyr, *cand, orb.cell, orb.k_per_cell,
                                                     orb.budgets, orb.scales, PATCH_RADIUS + BLUR_K // 2)


@pytest.mark.parametrize("crop,cell,k,threshold,n_levels", DETECT_CASES)
def test_all_level_detect_equals_jax_per_level(seqs, crop, cell, k, threshold, n_levels):
    """On the same level images, the plain F1 + F2 over all levels give JAX's
    per-level detector rows exactly: xy at level 0, response, octave, valid
    and the support patches, in every slot."""
    img = torch.from_numpy(np.ascontiguousarray(seqs[1].render(11).astype(np.float32)[: crop[0], : crop[1]]))
    kw = dict(cell=cell, k_per_cell=k, fast_threshold=threshold, n_levels=n_levels)
    orb, ref = ORBExtractor(**kw), RefORB(**kw)
    pyr, levels, got = _detect_all_levels(orb, img)
    detect = jax.jit(ref._detect_level, static_argnums=1)
    want = [[], [], [], [], []]
    for lv in range(orb.n_levels):
        level = jnp.asarray(pyr.level(levels, lv).numpy())
        xy, resp, valid = detect(level, ref.budgets[lv], jnp.float32(threshold))
        for out, v in zip(want, (xy * ref.scales[lv], resp, jnp.full((ref.budgets[lv],), lv, jnp.int32), valid,
                                 ref._extract_support_patches(level, xy))):
            out.append(np.asarray(v))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.concatenate(w))
    assert int(got[3].sum()) > (1500 if crop == (480, 640) and k == 4 else 0)


def test_detect_wrappers_on_cpu_run_plain_and_count_nothing(seqs):
    orb = ORBExtractor()
    img = torch.from_numpy(seqs[1].render(5).astype(np.float32))
    with tracing():
        before = timers.counters()
        pyr, levels, got = _detect_all_levels(orb, img)
        assert timers.counters() == before
    cand = fast_kernel.fast_cells_plain(levels, pyr, 7.0, 32, 4, EDGE_MARGIN)
    want = fast_kernel.select_keypoints_plain(levels, pyr, *cand, 32, 4, orb.budgets, orb.scales,
                                              PATCH_RADIUS + BLUR_K // 2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_packed_pyramid_equals_per_level_resize(seqs):
    """The packed levels are bit-equal to each level's own two matmuls."""
    img = torch.from_numpy(seqs[1].render(0).astype(np.float32))
    pyr = image.Pyramid(480, 640, 8, 1.2, "cpu")
    levels = pyr(img)
    assert torch.equal(pyr.level(levels, 0), img)
    for lv in range(1, 8):
        (oh, ow), (ah, aw) = pyr.shapes[lv], pyr.weights[lv]
        assert ah.shape == (oh, 480) and aw.shape == (ow, 640)
        assert torch.equal(pyr.level(levels, lv), (ah @ img) @ aw.T)


def _agreement(port_frame, ref_frame):
    """-> (keypoint-set agreement, descriptor-bit agreement over shared kpts)."""
    def keyset(xy, octave, valid):
        return {(float(x), float(y), int(o)): k
                for k, ((x, y), o, v) in enumerate(zip(xy, octave, valid)) if v}

    kp_p = keyset(port_frame.xy.numpy(), port_frame.octave.numpy(), port_frame.valid.numpy())
    kp_r = keyset(np.asarray(ref_frame.xy), np.asarray(ref_frame.octave), np.asarray(ref_frame.valid))
    shared = kp_p.keys() & kp_r.keys()
    kp_agree = len(shared) / max(len(kp_p.keys() | kp_r.keys()), 1)
    dp = port_frame.desc.numpy().view(np.uint32)
    dr = np.asarray(ref_frame.desc)
    ip = np.array([kp_p[k] for k in shared])
    ir = np.array([kp_r[k] for k in shared])
    diff = np.unpackbits((dp[ip] ^ dr[ir]).view(np.uint8)).sum()
    return kp_agree, 1.0 - diff / (len(shared) * 256)


def test_frame_extractor_agreement(seqs):
    params = Params().replace(detectMarkers=False, maxKeyPointsPerFrame=512, nOctaveLevels=4)
    ref = RefExtractor(params, RefCamera.create(500.0, 500.0, 320.0, 240.0))
    port_params = PortParams.from_dict(params.to_dict())
    port = FrameExtractor(port_params, CameraParams.create(500.0, 500.0, 320.0, 240.0), device="cpu")
    for i in FRAMES:
        img = seqs[1].render(i)
        f_port, f_ref = port.process(img, i), ref.process(img, i)
        assert f_port.xy.shape == (512, 2) and f_port.desc.dtype == torch.int32
        assert int(f_port.valid.sum()) > 300
        kp_agree, bit_agree = _agreement(f_port, f_ref)
        assert kp_agree >= 0.99, f"frame {i}: keypoint-set agreement {kp_agree:.4f}"
        assert bit_agree >= 0.98, f"frame {i}: descriptor-bit agreement {bit_agree:.5f}"


# -- the frontend options: detector-resolution scaling and sensitivity --------
#
# Measured here (CPU): at kptImageScaleFactor 0.5 all 512 keypoints of each
# frame match the reference's (same octave, xy within 1e-3); at 0.75, 511 or
# 512 of 512 (one FAST score at the threshold tips). The floor is the 99%
# above.


@pytest.mark.parametrize("ksf", [0.5, 0.75])
def test_detector_resize_matches_jax(seqs, ksf):
    import jax

    img = seqs[1].render(5).astype(np.float32) / 255.0  # the resize is linear: held on [0, 1]
    small = (max(8, int(round(480 * ksf))), max(8, int(round(640 * ksf))))
    got = image.resize_linear(torch.from_numpy(img), small).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(img), small, method="linear"))
    assert got.shape == want.shape == small
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _matched(port_frame, ref_frame, tol=1e-3):
    """-> (share of the union matched, max xy difference of the matches):
    keypoints of equal octave within `tol` pixels."""
    vp, vr = port_frame.valid.numpy(), np.asarray(ref_frame.valid)
    xp, xr = port_frame.xy.numpy()[vp], np.asarray(ref_frame.xy)[vr]
    op, orr = port_frame.octave.numpy()[vp], np.asarray(ref_frame.octave)[vr]
    d = np.abs(xp[:, None, :] - xr[None, :, :]).max(-1) + np.where(op[:, None] != orr[None, :], np.inf, 0.0)
    best = d.min(1)
    n = int((best <= tol).sum())
    return n / max(len(xp) + len(xr) - n, 1), float(best[best <= tol].max(initial=0.0))


@pytest.mark.parametrize("ksf,target_focus", [(0.5, 0.0), (0.75, 0.0), (1.0, 375.0)])
def test_scaled_detector_extract_matches_reference(seqs, ksf, target_focus):
    params = Params().replace(detectMarkers=False, maxKeyPointsPerFrame=512, nOctaveLevels=4,
                              kptImageScaleFactor=ksf, targetFocus=target_focus)
    ref = RefExtractor(params, RefCamera.create(500.0, 500.0, 320.0, 240.0))
    port = FrameExtractor(PortParams.from_dict(params.to_dict()), CameraParams.create(500.0, 500.0, 320.0, 240.0),
                          device="cpu")
    assert port.ksf == (ksf if target_focus == 0 else 0.75)
    for i in FRAMES:
        img = seqs[1].render(i)
        f_port, f_ref = port.process(img, i), ref.process(img, i)
        assert int(f_port.valid.sum()) > 300
        agree, err = _matched(f_port, f_ref)
        assert agree >= 0.99, f"frame {i}: keypoint agreement {agree:.4f} at ksf {port.ksf}"
        assert err <= 1e-3


def test_auto_adjust_sensitivity_follows_reference(seqs):
    """A low-texture stretch (five nearly flat frames) lowers the FAST
    threshold a step a frame down to 3, one frame late; texture raises it
    back to 7."""
    params = Params().replace(detectMarkers=False, maxKeyPointsPerFrame=512, nOctaveLevels=4,
                              autoAdjustKpSensitivity=True)
    ref = RefExtractor(params, RefCamera.create(500.0, 500.0, 320.0, 240.0))
    port = FrameExtractor(PortParams.from_dict(params.to_dict()), CameraParams.create(500.0, 500.0, 320.0, 240.0),
                          device="cpu")
    flat = np.full((480, 640), 40.0, np.float32) + (np.arange(640)[None, :] % 7)
    frames = [seqs[1].render(0), seqs[1].render(1)] + [flat] * 5 + [seqs[1].render(i) for i in range(2, 8)]
    got, want, fills = [], [], []
    for i, img in enumerate(frames):
        f_port, f_ref = port.process(img, i), ref.process(img, i)
        got.append(port.orb.fast_threshold)
        want.append(float(ref.orb.fast_threshold))
        fills.append(int(f_port.valid.sum()) == int(np.asarray(f_ref.valid).sum()))
    assert got == want
    assert min(got) == 3.0 and got[-1] == 7.0
    assert all(fills)
