"""The port's vocabulary trainer against the reference's, on the CPU.

On the same descriptors and seed the two trainers give the same centroids
bit for bit and the same idf (held within 1e-6; equal here), through
empty-cluster re-seeding; the `.fbow` files they write are byte-equal. The
harvest runs each package's own ORB, which agrees with the reference's to
the frontend tests' tolerance (test_torch_frontend.py): measured here on
the harvest's first frame of seeds 11 and 23 (8 levels x 1500 keypoints),
the per-image descriptor counts are equal (1500) and 99.80-99.87% of the port's
descriptors are among the reference's; the floor is 98%.
"""

import numpy as np
import pytest
import torch

from ucoslam_tpu.features import vocab_trainer as ref_vt
from ucoslam_tpu.io.fbow import load_fbow as ref_load_fbow
from ucoslam_tpu.io.fbow import save_fbow as ref_save_fbow
from ucoslam_tpu_torch.features import vocab_trainer
from ucoslam_tpu_torch.io.fbow import save_fbow

torch.set_num_threads(2)


def clustered_descriptors(seed=5, n=6000, centres=60, images=30):
    """Descriptors around `centres` random words (half of them exact
    copies, so that equal centroids leave clusters empty), with image ids."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 2**32, (centres, 8), dtype=np.uint32)
    desc = base[rng.integers(0, centres, n)]
    noisy = rng.random(n) < 0.5
    m = int(noisy.sum())
    desc[noisy] ^= (rng.integers(0, 2**32, (m, 8), dtype=np.uint32) & rng.integers(0, 2**32, (m, 8), dtype=np.uint32)
                    & rng.integers(0, 2**32, (m, 8), dtype=np.uint32))
    return desc, np.repeat(np.arange(images), n // images).astype(np.int32), images


def test_majority_update_matches_reference():
    desc, _, _ = clustered_descriptors()
    assign = np.random.default_rng(1).integers(0, 100, len(desc)).astype(np.int32)
    assign[assign == 7] = 8  # one empty cluster
    want, want_counts = ref_vt._majority_update(desc, assign, 100)
    got, got_counts = vocab_trainer._majority_update(
        torch.from_numpy(desc.view(np.int32)), torch.from_numpy(assign.astype(np.int64)), 100)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(got_counts.numpy(), want_counts)
    assert want_counts[7] == 0


def test_assignment_matches_reference():
    desc, _, _ = clustered_descriptors()
    cent = desc[::37][:128]  # duplicates among the centroids: ties go to the lowest index
    want = ref_vt._hamming_assign(desc, cent)
    got = vocab_trainer._hamming_assign(torch.from_numpy(desc.view(np.int32)), torch.from_numpy(cent.view(np.int32)),
                                        chunk=1000)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,iters", [(128, 3), (256, 5)])
def test_train_vocabulary_matches_reference(k, iters):
    desc, ids, n_img = clustered_descriptors()
    # the first update leaves clusters empty, so the re-seeding draw is reached
    cent0 = desc[np.random.default_rng(0).choice(len(desc), k, replace=False)]
    _, counts = ref_vt._majority_update(desc, ref_vt._hamming_assign(desc, cent0), k)
    assert (counts == 0).sum() > 0
    want_c, want_w = ref_vt.train_vocabulary(desc, ids, n_img, k=k, iters=iters, seed=0)
    got_c, got_w = vocab_trainer.train_vocabulary(desc, ids, n_img, k=k, iters=iters, seed=0, device="cpu")
    assert got_c.dtype == np.uint32 and got_w.dtype == np.float32
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_allclose(got_w, want_w, rtol=0, atol=1e-6)


def test_fbow_bytes_equal_reference(tmp_path):
    desc, ids, n_img = clustered_descriptors()
    c, w = vocab_trainer.train_vocabulary(desc, ids, n_img, k=200, iters=2, device="cpu")
    rc, rw = ref_vt.train_vocabulary(desc, ids, n_img, k=200, iters=2)
    save_fbow(str(tmp_path / "port.fbow"), c, w)
    ref_save_fbow(str(tmp_path / "ref.fbow"), rc, rw)
    assert (tmp_path / "port.fbow").read_bytes() == (tmp_path / "ref.fbow").read_bytes()


def test_harvest_matches_reference():
    seeds = (11, 23)
    got, got_ids, n = vocab_trainer.harvest_descriptors(2, seeds=seeds, device="cpu")
    want, want_ids, n_ref = ref_vt.harvest_descriptors(2, seeds=seeds)
    assert n == n_ref == 2 and got.dtype == np.uint32
    for img in range(n):
        a, b = got[got_ids == img], want[want_ids == img]
        assert len(a) > 1000 and abs(len(a) - len(b)) <= 0.01 * len(b), (len(a), len(b))
        ref_set = {r.tobytes() for r in b}
        share = np.mean([r.tobytes() in ref_set for r in a])
        assert share >= 0.98, f"image {img}: {share:.4f} of the port's descriptors among the reference's"


def test_main_writes_a_vocabulary_the_reference_reads(tmp_path, capsys):
    out = str(tmp_path / "v.fbow")
    assert vocab_trainer.main(["--out", out, "--words", "64", "--frames", "4", "--iters", "2", "--device", "cpu"]) == 0
    assert "wrote" in capsys.readouterr().out
    v = ref_load_fbow(out)
    assert v.desc.shape == (64, 8) and v.weight.shape == (64,)
    assert np.isfinite(v.weight).all() and (v.weight >= 1e-3).all()
