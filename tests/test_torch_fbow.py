"""The port's `.fbow` vocabularies against the JAX package, on the CPU.

- `io/fbow.load_fbow` on the repository's `data/vocab.fbow` (16384 words,
  k = 128): the same centroid bits, weights, word ids, k and descriptor
  size as the reference's reader;
- a `save_fbow` -> `load_fbow` round trip, read back by both packages;
- the chunked `quantize_words` (4096-word chunks above 8192 words) equal to
  the reference's on 1024 seeded descriptors against that vocabulary, and on
  a copy of it with words duplicated across chunk boundaries, hit exactly
  and at equal distance (the lowest word wins, in both);
- `KeyFrameDataBase.load_vocabulary` upgrades a dummy database and drops
  the postings;
- a map the JAX package built with that vocabulary (oracle frames, saved
  with `saveToFile`) read back by the port and localized: after
  `resetTracker()` the port
  relocalizes the frames the reference relocalizes, through the same BoW
  candidates, to poses within 1e-3 of the reference's. (The port used to
  raise on the first query: vocabularies over 8192 words were not ported.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucoslam_tpu.api import UcoSlam as RefSlam
from ucoslam_tpu.config import Mode as RefMode, Params
from ucoslam_tpu.io import SyntheticSequence as RefSequence
from ucoslam_tpu.io import fbow as ref_fbow
from ucoslam_tpu.mapping import kfdatabase as ref_kfdb
from ucoslam_tpu_torch import Mode
from ucoslam_tpu_torch.api import UcoSlam
from ucoslam_tpu_torch.io import fbow
from ucoslam_tpu_torch.io.synthetic import SyntheticSequence
from ucoslam_tpu_torch.mapping import kfdatabase
from ucoslam_tpu_torch.mapping.frame import tensor_from_numpy

torch.set_num_threads(2)

VOCAB = fbow.default_vocab_path()
PARAMS = Params().replace(
    maxMapPoints=4096, maxKeyFrames=32, maxKeyPointsPerFrame=512, maxDescDistance=60.0, ransacIters=256,
    detectMarkers=False,
)


@pytest.fixture(scope="module")
def vocab():
    return fbow.load_fbow(VOCAB)


def test_load_fbow_equals_reference(vocab):
    ref = ref_fbow.load_fbow(ref_fbow.default_vocab_path())
    assert VOCAB == ref_fbow.default_vocab_path()
    assert vocab.desc.shape == (16384, 8) and vocab.desc.dtype == np.uint32
    assert np.array_equal(vocab.desc, ref.desc)
    assert np.array_equal(vocab.weight, ref.weight)
    assert np.array_equal(vocab.word_id, ref.word_id)
    assert (vocab.k, vocab.desc_size, vocab.desc_name) == (ref.k, ref.desc_size, ref.desc_name)
    assert (vocab.k, vocab.desc_size) == (128, 32)


def test_save_load_round_trip(vocab, tmp_path):
    rng = np.random.default_rng(5)
    desc = rng.integers(0, 2**32, (1000, 8), dtype=np.uint32)
    weight = rng.random(1000).astype(np.float32)
    path = str(tmp_path / "small.fbow")
    fbow.save_fbow(path, desc, weight)
    for reader in (fbow.load_fbow, ref_fbow.load_fbow):
        back = reader(path)
        assert np.array_equal(back.desc, desc)
        assert np.array_equal(back.weight, weight)
        assert np.array_equal(back.word_id, np.arange(1000))


def _quantize_both(desc_u32, vocab_u32):
    port = kfdatabase.quantize_words(tensor_from_numpy(desc_u32, "cpu"), tensor_from_numpy(vocab_u32, "cpu"))
    ref = ref_kfdb.quantize_words(jnp.asarray(desc_u32), jnp.asarray(vocab_u32))
    return port.numpy(), np.asarray(ref)


def test_chunked_quantize_equals_reference(vocab):
    rng = np.random.default_rng(11)
    desc = rng.integers(0, 2**32, (1024, 8), dtype=np.uint32)
    # real-looking descriptors too: trained words with a few bits flipped
    near = vocab.desc[rng.integers(0, 16384, 512)].copy()
    near[:, 0] ^= rng.integers(0, 2**32, 512, dtype=np.uint32) & np.uint32(0x00010101)
    desc[:512] = near
    port, ref = _quantize_both(desc, vocab.desc)
    assert np.array_equal(port, ref)


def test_chunked_quantize_ties_across_chunks(vocab):
    """Words duplicated across the 4096-word chunk boundaries: descriptors
    equal to them (distance 0) and one bit off (equal distance to both)
    go to the lowest word, in both packages."""
    v = vocab.desc.copy()
    pairs = [(4095, 4096), (5, 8192 + 5), (100, 16383), (8191, 12288)]
    for lo, hi in pairs:
        v[hi] = v[lo]
    rng = np.random.default_rng(3)
    desc = rng.integers(0, 2**32, (1024, 8), dtype=np.uint32)
    for j, (lo, _) in enumerate(pairs):
        desc[2 * j] = v[lo]
        desc[2 * j + 1] = v[lo] ^ np.asarray([1, 0, 0, 0, 0, 0, 0, 0], np.uint32)
    port, ref = _quantize_both(desc, v)
    assert np.array_equal(port, ref)
    for j, (lo, _) in enumerate(pairs):
        assert port[2 * j] == lo
    # the whole search (no chunks) agrees where the vocabulary fits it
    small = v[:8192]
    whole_p, whole_r = _quantize_both(desc, small)
    assert np.array_equal(whole_p, whole_r)


def test_load_vocabulary_upgrades_a_dummy_database(vocab):
    db = kfdatabase.KeyFrameDataBase(8, dummy=True, device="cpu")
    db.word_ids[2, :3] = torch.tensor([1, 2, 3], dtype=torch.int32)
    db.word_w[2, :3] = 0.5
    db.load_vocabulary(VOCAB)
    assert not db.dummy
    assert db.vocab.shape == (16384, 8)
    assert np.array_equal(db.vocab.numpy().view(np.uint32), vocab.desc)
    assert np.array_equal(db.weights.numpy(), vocab.weight)
    assert (db.word_ids == -1).all() and (db.word_w == 0).all()
    assert db.word_ids.shape == (8, kfdatabase.WORDS_PER_FRAME)


@pytest.fixture(scope="module")
def jax_vocab_map(tmp_path_factory):
    """The JAX package's map of frames 0-13 of an oracle sequence, with the
    trained vocabulary in its keyframe database, saved."""
    seq = RefSequence(n_frames=30, seed=7)
    slam = RefSlam()
    slam.setParams(None, PARAMS, seq.cam, vocabulary=VOCAB)
    for i in range(14):
        slam.process_frame(seq.frame(i))
    assert slam.map.n_keyframes >= 3
    path = str(tmp_path_factory.mktemp("vocmap") / "map.slm")
    slam.saveToFile(path)
    return seq, path


def _recorded(slam_system):
    """Wrap the keyframe database's candidate query to record its results."""
    log, kfdb = [], slam_system.manager.kfdb
    query = kfdb.relocalization_candidates
    kfdb.relocalization_candidates = lambda *a, **k: log.append(list(query(*a, **k))) or log[-1]
    return log


def test_jax_vocabulary_map_relocalizes_in_port(jax_vocab_map):
    ref_seq, path = jax_vocab_map
    seq = SyntheticSequence(n_frames=30, seed=7)
    ref = RefSlam()
    ref.readFromFile(path, ref_seq.cam)
    port = UcoSlam(device="cpu")
    port.readFromFile(path, seq.cam)
    assert port._system.manager.kfdb.vocab.shape[0] == 16384 and not port._system.manager.kfdb.dummy
    ref.setMode(RefMode.LOCALIZATION)
    port.setMode(Mode.LOCALIZATION)
    ref_log, port_log = _recorded(ref._system), _recorded(port._system)
    for i in (12, 5, 9):
        ref.resetTracker()
        port.resetTracker()
        ref_pose = ref.process_frame(ref_seq.frame(i))
        port_pose = port.process_frame(seq.frame(i, device="cpu"))
        assert ref_log[-1] == port_log[-1], f"frame {i}: candidates {port_log[-1]} vs {ref_log[-1]}"
        assert ref_log[-1], f"frame {i}: no BoW candidates"
        assert (port_pose is None) == (ref_pose is None), f"frame {i}"
        if ref_pose is not None:
            assert np.abs(port_pose - np.asarray(ref_pose)).max() < 1e-3, f"frame {i}"
    assert len(port_log) == 3
