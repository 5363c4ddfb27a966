"""The port's epipolar, triangulation and two-view functions against the
reference's on the same seeded inputs.

The reference solves its 8- and 4-point null vectors in float32, where
their squared condition number leaves percent-level errors that no other
eigensolver reproduces; the port solves them in float64. So the hypothesis
search is held against the reference's function evaluated in float64, with
the reference's own float32-mode draws injected, where both are accurate.
The port also gives each homography the sign that maps its own sample in
front (w > 0): the reference's transfer score counts an H only under that
sign and keeps whichever sign LAPACK returned, so its H scores are checked
against its own helpers with that one sign fixed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucoslam_tpu.geometry import epipolar as ref_epi
from ucoslam_tpu.geometry import triangulate as ref_tri
from ucoslam_tpu.geometry import twoview as ref_tv
from ucoslam_tpu.geometry.camera import CameraParams as RefCamera
from ucoslam_tpu.io import SyntheticSequence as RefSequence
from ucoslam_tpu.matching.matcher import match_frames as ref_match_frames
from ucoslam_tpu_torch.geometry import epipolar, triangulate, twoview
from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.geometry.se3 import se3_exp

torch.set_num_threads(2)

REF_CAM = RefCamera.create(500.0, 500.0, 320.0, 240.0)
CAM = CameraParams.create(500.0, 500.0, 320.0, 240.0)


def t(a):
    return torch.from_numpy(np.array(a))


def _poses(rng, n):
    xi = np.c_[rng.normal(0, 0.3, (n, 3)), rng.normal(0, 0.1, (n, 3))].astype(np.float32)
    return se3_exp(torch.from_numpy(xi)).numpy()


def _rel_err(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()


def test_epipolar_functions_match_reference():
    rng = np.random.default_rng(0)
    T1, T2 = _poses(rng, 2)
    E_ref = ref_epi.essential_from_relative(jnp.asarray(T2))
    assert _rel_err(epipolar.essential_from_relative(t(T2)).numpy(), E_ref) < 1e-5
    F_ref = ref_epi.fundamental_from_poses(jnp.asarray(T1), jnp.asarray(T2), REF_CAM, REF_CAM)
    F = epipolar.fundamental_from_poses(t(T1), t(T2), CAM, CAM)
    assert _rel_err(F.numpy(), F_ref) < 1e-5
    uv1 = rng.uniform([0, 0], [640, 480], (50, 2)).astype(np.float32)
    uv2 = rng.uniform([0, 0], [640, 480], (40, 2)).astype(np.float32)
    d_ref = ref_epi.epipolar_line_sq_dist(F_ref, jnp.asarray(uv1), jnp.asarray(uv2))
    d = epipolar.epipolar_line_sq_dist(t(np.asarray(F_ref)), t(uv1), t(uv2))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=1e-5, atol=1e-5 * float(np.abs(d_ref).max()))


def _two_views(rng, n=400):
    """Points in front of two cameras 0.5 apart, observed with 0.5 px noise."""
    X = np.c_[rng.uniform(-3, 3, (n, 2)), rng.uniform(4, 9, n)].astype(np.float32)
    T1 = np.eye(4, dtype=np.float32)
    T2 = se3_exp(torch.tensor([-0.5, 0.05, 0.1, 0.01, 0.06, -0.02])).numpy()
    uv = []
    for T in (T1, T2):
        q = X @ T[:3, :3].T + T[:3, 3]
        uv.append((np.c_[500 * q[:, 0] / q[:, 2] + 320, 500 * q[:, 1] / q[:, 2] + 240]
                   + rng.normal(0, 0.5, (n, 2))).astype(np.float32))
    octave = rng.integers(0, 4, n).astype(np.int32)
    return X, T1, T2, uv[0], uv[1], (1.2 ** (2 * octave)).astype(np.float32)


def test_triangulate_checked_matches_reference():
    rng = np.random.default_rng(1)
    X, T1, T2, uv1, uv2, sigma2 = _two_views(rng)
    uv2[:20] += rng.normal(0, 20, (20, 2)).astype(np.float32)  # rejected by the chi2 gate
    X_ref, ok_ref = ref_tri.triangulate_checked(
        jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(T1), jnp.asarray(T2), REF_CAM, REF_CAM,
        jnp.asarray(sigma2), jnp.asarray(sigma2),
    )
    X_p, ok = triangulate.triangulate_checked(t(uv1), t(uv2), t(T1), t(T2), CAM, CAM, t(sigma2), t(sigma2))
    ok_ref = np.asarray(ok_ref)
    np.testing.assert_array_equal(ok.numpy(), ok_ref)
    assert 300 < ok_ref.sum() < 400
    assert _rel_err(X_p.numpy()[ok_ref], np.asarray(X_ref)[ok_ref]) < 1e-4


def test_triangulate_batched_equals_pairs():
    """A leading batch axis of second views gives each pair's result."""
    rng = np.random.default_rng(2)
    X, T1, T2, uv1, uv2, sigma2 = _two_views(rng, 100)
    T3 = T2.copy()
    T3[:3, 3] *= 1.5
    uv2b = torch.stack([t(uv2), t(uv2) + 1.0])
    Xb, okb = triangulate.triangulate_checked(
        t(uv1), uv2b, t(T1), torch.stack([t(T2), t(T3)]), CAM, CAM, t(sigma2), torch.stack([t(sigma2)] * 2)
    )
    for i, (T, u) in enumerate(((T2, uv2b[0]), (T3, uv2b[1]))):
        Xi, oki = triangulate.triangulate_checked(t(uv1), u, t(T1), t(T), CAM, CAM, t(sigma2), t(sigma2))
        assert torch.equal(okb[i], oki)
        assert torch.allclose(Xb[i], Xi, rtol=1e-6, atol=1e-6)


def test_null_vector_bounds_each_eigensolver_call(monkeypatch):
    """A keyframe's 6 x 2048 epipolar systems are solved in calls of at most
    EIGH_CHUNK systems (one call of all of them reserved 6.3 GiB of
    eigensolver workspace a SLAM process on the card, and four processes
    ran it out of memory), with each system's vector as in one call."""
    A = torch.from_numpy(np.random.default_rng(3).normal(size=(6, 2048, 4, 4)).astype(np.float32))
    Ad = A.double()
    whole = torch.linalg.eigh(Ad.transpose(-1, -2) @ Ad)[1][..., :, 0].float()
    sizes, eigh = [], torch.linalg.eigh

    def counted(m):
        sizes.append(m.shape[0])
        return eigh(m)

    monkeypatch.setattr(torch.linalg, "eigh", counted)
    got = triangulate.null_vector(A)
    assert torch.equal(got, whole)
    assert sum(sizes) == 6 * 2048 and max(sizes) <= triangulate.EIGH_CHUNK < 6 * 2048


@pytest.fixture(scope="module", params=[2, 8, 12])
def matched_views(request):
    """Frame 0 and frame j of an oracle sequence, matched by the reference."""
    seq = RefSequence(n_frames=40, seed=1)
    f0, f1 = seq.frame(0), seq.frame(request.param)
    m = ref_match_frames(f0, f1, jnp.float32(60.0), nn_ratio=0.9)
    t_idx, valid = np.asarray(m.train_idx), np.asarray(m.valid)
    uv1 = np.asarray(f0.und_xy)
    uv2 = np.asarray(f1.und_xy)[np.where(t_idx >= 0, t_idx, 0)]
    sigma2 = np.asarray(jnp.exp(2.0 * f0.octave.astype(jnp.float32) * jnp.log(jnp.float32(1.2))))
    # the reference's own draws, as its estimate_two_view makes them
    key = jax.random.PRNGKey(request.param)
    logits = jnp.where(valid, 0.0, -1e9)
    idx = np.asarray(jax.vmap(lambda k: jax.random.categorical(k, logits, shape=(8,)))(
        jax.random.split(key, 256)))
    return uv1, uv2, valid, sigma2, idx


def _ref_estimate_f64(monkeypatch, uv1, uv2, valid, sigma2, idx):
    """The reference's estimate_two_view in float64, fed the draws `idx`."""
    table = jnp.asarray(idx)
    with jax.enable_x64(True):
        monkeypatch.setattr(jax.random, "split", lambda key, n: jnp.arange(n))
        monkeypatch.setattr(jax.random, "categorical", lambda k, logits, shape: table[k])
        d = lambda a: jnp.asarray(a, jnp.float64)  # noqa: E731
        ref_tv.estimate_two_view.clear_cache()  # trace afresh with these draws
        model = ref_tv.estimate_two_view(d(uv1), d(uv2), jnp.asarray(valid), d(sigma2), jnp.zeros(2, jnp.uint32))
        ref_tv.estimate_two_view.clear_cache()
        monkeypatch.undo()
        n1, T1 = ref_tv._normalize_points(d(uv1), jnp.asarray(valid))
        n2, T2 = ref_tv._normalize_points(d(uv2), jnp.asarray(valid))

        def h_score(i):  # the reference's helpers, with the sign fixed to w > 0
            Hn = ref_tv._homography_4pt(n1[i[:4]], n2[i[:4]])
            w = jnp.sum(jnp.concatenate([n1[i[:4]], jnp.ones((4, 1))], -1) @ Hn[2])
            H = jnp.linalg.inv(T2) @ (Hn * jnp.where(w < 0, -1.0, 1.0)) @ T1
            e1, e2 = ref_tv._sym_transfer_chi2(H, d(uv1), d(uv2))
            c1, c2 = e1 / d(sigma2), e2 / d(sigma2)
            sc = jnp.where(c1 < ref_tv.TH_H, ref_tv.TH_SCORE - c1, 0.0) + jnp.where(
                c2 < ref_tv.TH_H, ref_tv.TH_SCORE - c2, 0.0)
            return jnp.sum(sc * jnp.asarray(valid, jnp.float64))

        def f_score(i):  # the reference's helpers: which draw won
            F = T2.T @ ref_tv._fundamental_8pt(n1[i], n2[i]) @ T1
            e1, e2 = ref_tv._sym_epipolar_chi2(F, d(uv1), d(uv2))
            c1, c2 = e1 / d(sigma2), e2 / d(sigma2)
            sc = jnp.where(c1 < ref_tv.TH_F, ref_tv.TH_SCORE - c1, 0.0) + jnp.where(
                c2 < ref_tv.TH_F, ref_tv.TH_SCORE - c2, 0.0)
            return jnp.sum(sc * jnp.asarray(valid, jnp.float64))

        sf = np.asarray(jax.vmap(f_score)(table))
        sh = np.asarray(jax.vmap(h_score)(table))
        assert abs(sf.max() - float(model.score_f)) <= 1e-9 * sf.max()
        return (int(np.argmax(sf)), float(model.score_f), np.asarray(model.inliers_f),
                int(np.argmax(sh)), float(sh.max()))


def _port_model(uv1, uv2, valid, sigma2, idx):
    return twoview.estimate_two_view(t(uv1), t(uv2), t(valid), t(sigma2), t(idx).long())


def test_estimate_two_view_matches_reference(monkeypatch, matched_views):
    uv1, uv2, valid, sigma2, idx = matched_views
    best_f, score_f, inliers_f, best_h, score_h = _ref_estimate_f64(monkeypatch, uv1, uv2, valid, sigma2, idx)
    model = _port_model(uv1, uv2, valid, sigma2, idx)
    assert int(model.best_f) == best_f
    assert abs(float(model.score_f) - score_f) <= 1e-4 * score_f
    assert int(model.best_h) == best_h
    assert abs(float(model.score_h) - score_h) <= 1e-4 * score_h
    np.testing.assert_array_equal(model.inliers_f.numpy(), inliers_f)


def test_reconstruct_two_view_matches_reference(matched_views):
    uv1, uv2, valid, sigma2, idx = matched_views
    model = _port_model(uv1, uv2, valid, sigma2, idx)
    rec = twoview.reconstruct_two_view(model, t(uv1), t(uv2), t(valid), t(sigma2), CAM, CAM)
    ref_model = ref_tv.TwoViewModel(*(jnp.asarray(getattr(model, k).numpy()) for k in (
        "F", "H", "score_f", "score_h", "inliers_f", "inliers_h")))
    want = ref_tv.reconstruct_two_view(
        ref_model, jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(valid), jnp.asarray(sigma2),
        REF_CAM, REF_CAM, min_triangulated=jnp.int32(50), min_parallax_deg=jnp.float32(1.0),
    )
    assert bool(rec.ok) == bool(want.ok)
    assert np.abs(rec.pose_21.numpy() - np.asarray(want.pose_21)).max() < 1e-4
    # point_ok equal except rows within 1e-3 of one of its thresholds
    X = np.asarray(want.points)
    R, tr = np.asarray(want.pose_21)[:3, :3], np.asarray(want.pose_21)[:3, 3]
    Xc2 = X @ R.T + tr
    near = np.zeros(len(X), bool)
    for q, u in ((X, uv1), (Xc2, uv2)):
        c = ((np.c_[500 * q[:, 0] / q[:, 2] + 320, 500 * q[:, 1] / q[:, 2] + 240] - u) ** 2).sum(1) / sigma2
        near |= np.abs(c - 2 * 5.991) < 1e-3 * 2 * 5.991
        near |= np.abs(q[:, 2]) < 1e-3
    differ = rec.point_ok.numpy() != np.asarray(want.point_ok)
    assert not (differ & ~near).any(), np.nonzero(differ & ~near)
