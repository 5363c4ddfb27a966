"""Port's Hamming ops against ucoslam_tpu.ops.hamming: exact integer equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucoslam_tpu.ops import hamming as ref
from ucoslam_tpu_torch.ops import hamming as port

torch.set_num_threads(2)


def _descs(rng, n):
    d = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    d[: n // 4] = d[n // 4 : 2 * (n // 4)]  # duplicates -> ties
    d[0] = 0xFFFFFFFF  # every bit set, incl. the sign bit of each int32 word
    return d


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


@pytest.mark.parametrize("seed", [0, 1])
def test_hamming_matrix_exact(seed):
    rng = np.random.default_rng(seed)
    a, b = _descs(rng, 67), _descs(rng, 130)
    want = np.asarray(ref.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    got = port.hamming_matrix(_t(a), _t(b)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("masks", ["none", "rows_cols", "extra"])
def test_match_best2_exact(masks):
    rng = np.random.default_rng(3)
    d = rng.integers(0, 40, (50, 33)).astype(np.int32)  # many ties
    kw_ref, kw_port = {}, {}
    if masks == "rows_cols":
        rows, cols = rng.random(50) < 0.8, rng.random(33) < 0.7
        kw_ref = dict(valid_rows=jnp.asarray(rows), valid_cols=jnp.asarray(cols))
        kw_port = dict(valid_rows=_t(rows), valid_cols=_t(cols))
    elif masks == "extra":
        m = rng.random((50, 33)) < 0.3
        m[:5] = False  # all-masked rows
        kw_ref, kw_port = dict(extra_mask=jnp.asarray(m)), dict(extra_mask=_t(m))
    want = ref.match_best2(jnp.asarray(d), **kw_ref)
    got = port.match_best2(_t(d), **kw_port)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_filter_ambiguous_exact():
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 20, 200).astype(np.int32)
    dist = rng.integers(0, 30, 200).astype(np.int32)
    dist[::7] = ref.INVALID_DIST
    want = ref.filter_ambiguous_train_sized(jnp.asarray(idx), jnp.asarray(dist), 20)
    got = port.filter_ambiguous_train_sized(_t(idx), _t(dist), 20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert port.INVALID_DIST == ref.INVALID_DIST
