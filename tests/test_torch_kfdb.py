"""The port's keyframe database against the reference's on seeded
descriptors: the same vocabulary bits, word ids and postings, and the same
relocalization candidates, with and without covisibility grouping."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucoslam_tpu.mapping import kfdatabase as ref_kfdb
from ucoslam_tpu_torch.mapping import kfdatabase
from ucoslam_tpu_torch.mapping.frame import tensor_from_numpy

torch.set_num_threads(2)

K, N = 16, 300


def test_vocabulary_bits_equal():
    np.testing.assert_array_equal(kfdatabase.make_vocabulary(), np.asarray(ref_kfdb.make_vocabulary()))


def test_quantize_words_equal():
    rng = np.random.default_rng(0)
    vocab = ref_kfdb.make_vocabulary()
    desc = rng.integers(0, 2**32, (500, 8), dtype=np.uint32)
    desc[:50] = np.asarray(vocab)[:50]  # distance 0 to a word
    want = np.asarray(ref_kfdb.quantize_words(jnp.asarray(desc), vocab))
    got = kfdatabase.quantize_words(tensor_from_numpy(desc, "cpu"), tensor_from_numpy(np.asarray(vocab), "cpu"))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def databases():
    """Both databases after 12 keyframes were added and 2 removed. Each
    keyframe draws its descriptors from a few "places" (pools), so
    keyframes of one place share words and a query finds them."""
    rng = np.random.default_rng(1)
    pools = rng.integers(0, 2**32, (4, 400, 8), dtype=np.uint32)
    ref = ref_kfdb.KeyFrameDataBase(K)
    port = kfdatabase.KeyFrameDataBase(K, device="cpu")
    frames = []
    for s in range(12):
        desc = pools[s % 4][rng.integers(0, 400, N)]
        valid = rng.random(N) < 0.9
        frames.append((desc, valid))
        ref.add(s, jnp.asarray(desc), jnp.asarray(valid))
        port.add(s, tensor_from_numpy(desc, "cpu"), torch.from_numpy(valid))
    ref.remove([3, 7])
    port.remove([3, 7])
    query = pools[1][rng.integers(0, 400, N)]
    return ref, port, frames, query


def test_postings_equal(databases):
    ref, port, _, _ = databases
    np.testing.assert_array_equal(port.word_ids.numpy(), np.asarray(ref.word_ids))
    np.testing.assert_array_equal(port.word_w.numpy(), np.asarray(ref.word_w))


def test_query_scores_close(databases):
    ref, port, _, query = databases
    valid = np.ones(N, bool)
    want = ref.query(jnp.asarray(query), jnp.asarray(valid))
    got = port.query(tensor_from_numpy(query, "cpu"), torch.from_numpy(valid))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("exclude", [frozenset(), frozenset({1, 9})])
def test_relocalization_candidates_equal(databases, grouped, exclude):
    ref, port, _, query = databases
    valid = np.ones(N, bool)
    kf_active = np.ones(K, bool)
    kf_active[[3, 7]] = False
    kf_active[12:] = False
    covis = None
    if grouped:  # keyframes of one place are covisible
        idx = np.arange(K)
        covis = np.where((idx[:, None] % 4 == idx[None, :] % 4) & (idx[:, None] != idx[None, :]), 30, 0)
    want = ref.relocalization_candidates(jnp.asarray(query), jnp.asarray(valid), kf_active,
                                         covis=covis, exclude=set(exclude))
    got = port.relocalization_candidates(tensor_from_numpy(query, "cpu"), torch.from_numpy(valid), kf_active,
                                         covis=covis, exclude=set(exclude))
    assert len(want) > 0
    assert got == want


def test_dummy_database_gives_nothing():
    db = kfdatabase.KeyFrameDataBase(4, dummy=True, device="cpu")
    desc = torch.zeros(10, 8, dtype=torch.int32)
    db.add(0, desc, torch.ones(10, dtype=torch.bool))
    assert (db.word_ids == -1).all()
    assert db.relocalization_candidates(desc, torch.ones(10, dtype=torch.bool), np.ones(4, bool)) == []
