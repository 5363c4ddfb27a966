"""Keyframe database: bag-of-binary-words relocalization and loop candidates.

Port of `ucoslam_tpu/mapping/kfdatabase.py`. The built-in vocabulary is a
flat set of 512 random binary centroids from `numpy.random.default_rng(1234)`,
bit-identical to the reference's; `load_vocabulary` replaces it with a
trained `.fbow` file's leaf words (`io/fbow.py`; the repository's
`data/vocab.fbow` holds 16384). A descriptor's word is its nearest centroid
(an exact Hamming argmin, lowest word on ties); above 8192 words the search
runs over 4096-word chunks, so no (N, V) distance matrix exists whole. Each
keyframe keeps its top WORDS_PER_FRAME (word, weight) postings of the
L2-normalized histogram; a query scores every keyframe slot with one
gather. Word histograms are summed per word in a fixed order, so the card
gives the same scores on every run. The postings are guarded by a lock: in
async mode the mapping worker adds and removes keyframes while the tracker
queries.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ucoslam_tpu_torch.io.fbow import load_fbow
from ucoslam_tpu_torch.mapping.frame import fetch_to_host, tensor_from_numpy
from ucoslam_tpu_torch.mapping.map import ordered_segment_sum
from ucoslam_tpu_torch.ops.hamming import hamming_matrix

VOCAB_SIZE = 512

#: sparse BoW width: words stored per keyframe
WORDS_PER_FRAME = 256
#: vocabularies above WHOLE_SEARCH_MAX words are searched CHUNK words at a time
WHOLE_SEARCH_MAX, CHUNK = 8192, 4096


def make_vocabulary(size: int = VOCAB_SIZE, seed: int = 1234) -> np.ndarray:
    """(V, 8) uint32 random binary centroids (deterministic)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, (size, 8), dtype=np.uint32)


def quantize_words(desc: torch.Tensor, vocab: torch.Tensor) -> torch.Tensor:
    """(N, 8) descriptors -> (N,) nearest vocabulary word ids (int64), the
    lowest word on ties. Above WHOLE_SEARCH_MAX words, chunk by chunk: a
    chunk's minimum replaces the running one only when strictly smaller,
    so the lowest index still wins across chunks (the reference pads the
    last chunk with rows that cannot win; a slice leaves them out)."""
    V = vocab.shape[0]
    if V <= WHOLE_SEARCH_MAX:
        return torch.argmin(hamming_matrix(desc, vocab), dim=1)
    best_d = torch.full((desc.shape[0],), 2**31 - 1, dtype=torch.int32, device=desc.device)
    best_i = torch.zeros(desc.shape[0], dtype=torch.int64, device=desc.device)
    for base in range(0, V, CHUNK):
        d = hamming_matrix(desc, vocab[base : base + CHUNK])  # (N, <= CHUNK)
        i = torch.argmin(d, dim=1)
        dm = torch.gather(d, 1, i[:, None])[:, 0]
        upd = dm < best_d
        best_d = torch.where(upd, dm, best_d)
        best_i = torch.where(upd, base + i, best_i)
    return best_i


def bow_vector(desc, valid, vocab, weights=None) -> torch.Tensor:
    """Descriptor set -> L2-normalized word histogram (V,)."""
    V = vocab.shape[0]
    word = quantize_words(desc, vocab)
    w = torch.ones(V, dtype=torch.float32, device=desc.device) if weights is None else weights
    contrib = valid.to(torch.float32) * w[word]
    # per-word sums in input order (a scatter-add's order is not fixed on the card)
    hist = ordered_segment_sum(contrib[:, None], word, V)[:, 0]
    return hist / torch.linalg.norm(hist).clamp(min=1e-9)


def _sparse_scores(q_dense, word_ids, word_w):
    """Query histogram (V,) x sparse postings (K, W) -> (scores, commons)."""
    V = q_dense.shape[0]
    safe = torch.where(word_ids >= 0, word_ids, V).long()
    qg = torch.cat([q_dense, q_dense.new_zeros(1)])[safe]  # (K, W)
    scores = (qg * word_w).sum(1)
    common = ((qg > 0) & (word_ids >= 0)).sum(1)
    return scores, common


class KeyFrameDataBase:
    """Per-keyframe sparse BoW postings, kept beside the Map arenas.
    `dummy=True` is the reference's DummyDataBase: no candidates, ever."""

    def __init__(self, max_keyframes: int, vocab=None, weights=None, dummy: bool = False, device="cuda"):
        self.device = torch.device(device)
        self._lock = threading.Lock()  # the postings: the worker writes, the tracker reads
        self.dummy = dummy
        self.vocab = tensor_from_numpy(make_vocabulary() if vocab is None else np.asarray(vocab), self.device)
        self.weights = None if weights is None else tensor_from_numpy(np.asarray(weights, np.float32), self.device)
        self.word_ids = torch.full((max_keyframes, WORDS_PER_FRAME), -1, dtype=torch.int32, device=self.device)
        self.word_w = torch.zeros(max_keyframes, WORDS_PER_FRAME, dtype=torch.float32, device=self.device)

    def __getstate__(self) -> dict:  # copies and pickles get a lock of their own
        return {k: v for k, v in self.__dict__.items() if k != "_lock"}

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def load_vocabulary(self, path: str) -> None:
        """Replace the vocabulary with a .fbow file's leaf words and weights;
        a real vocabulary upgrades a dummy database, and the postings of the
        old words are dropped."""
        v = load_fbow(path)
        with self._lock:
            self.dummy = False
            self.vocab = tensor_from_numpy(v.desc, self.device)
            self.weights = tensor_from_numpy(v.weight, self.device)
            self.word_ids = torch.full_like(self.word_ids, -1)
            self.word_w = torch.zeros_like(self.word_w)

    def grow(self, new_max_keyframes: int) -> None:
        """Extend the per-keyframe posting table (keyframe arena growth)."""
        with self._lock:
            K = self.word_ids.shape[0]
            if new_max_keyframes > K:
                n = new_max_keyframes - K
                self.word_ids = torch.cat([self.word_ids, self.word_ids.new_full((n, WORDS_PER_FRAME), -1)])
                self.word_w = torch.cat([self.word_w, self.word_w.new_zeros(n, WORDS_PER_FRAME)])

    def _scores(self, desc: torch.Tensor, valid: torch.Tensor):
        """(scores (K,), commons (K,)) of the frame against every slot."""
        vec = bow_vector(desc, valid, self.vocab, self.weights)
        with self._lock:  # one posting table, never a row half written
            return _sparse_scores(vec, self.word_ids, self.word_w)

    def _sparse_entry(self, desc: torch.Tensor, valid: torch.Tensor):
        """Frame descriptors -> (ids (W,), weights (W,)) sparse histogram."""
        words = quantize_words(desc, self.vocab).cpu().numpy()
        words = words[valid.cpu().numpy()]
        uniq, counts = np.unique(words, return_counts=True)
        w = counts.astype(np.float32)
        if self.weights is not None:
            w = w * self.weights.cpu().numpy()[uniq]
        norm = float(np.linalg.norm(w))
        if norm > 1e-9:
            w = w / norm
        if len(uniq) > WORDS_PER_FRAME:
            top = np.argsort(-w)[:WORDS_PER_FRAME]
            uniq, w = uniq[top], w[top]
        ids = np.full(WORDS_PER_FRAME, -1, np.int32)
        ww = np.zeros(WORDS_PER_FRAME, np.float32)
        ids[: len(uniq)] = uniq
        ww[: len(uniq)] = w
        return ids, ww

    def add(self, kf_slot: int, desc: torch.Tensor, valid: torch.Tensor) -> None:
        if self.dummy:
            return
        ids, ww = self._sparse_entry(desc, valid)
        with self._lock:
            self.word_ids[kf_slot] = torch.from_numpy(ids).to(self.device)
            self.word_w[kf_slot] = torch.from_numpy(ww).to(self.device)

    def remove(self, kf_slots) -> None:
        idx = torch.as_tensor(np.asarray(kf_slots, np.int64), device=self.device)
        with self._lock:
            self.word_ids[idx] = -1
            self.word_w[idx] = 0.0

    def query(self, desc: torch.Tensor, valid: torch.Tensor) -> np.ndarray:
        """(K,) similarity of every keyframe slot to the given frame."""
        return self._scores(desc, valid)[0].cpu().numpy()

    def relocalization_candidates(
        self,
        desc: torch.Tensor,
        valid: torch.Tensor,
        kf_active: np.ndarray,
        covis: np.ndarray | None = None,
        exclude: set[int] = frozenset(),
        min_score_ratio: float = 0.75,
        max_candidates: int = 5,
        min_common_ratio: float = 0.8,
    ) -> list[int]:
        """Candidate keyframes for relocalization / loop detection: gate by
        shared words (>= 0.8 x the best), score by BoW similarity, and with
        `covis` return the best member of each covisibility group whose
        accumulated score is >= 0.75 x the best group's."""
        if self.dummy:
            return []
        s, c = self._scores(desc, valid)
        scores, common = fetch_to_host(s, c)
        ok = np.asarray(kf_active, bool).copy()
        if exclude:
            ok[np.fromiter(exclude, int)] = False
        ok &= scores > 0
        if not ok.any():
            return []
        max_common = common[ok].max()
        ok &= common >= max(min_common_ratio * max_common, 1.0)
        if not ok.any():
            return []
        cand = np.nonzero(ok)[0]
        if covis is None:
            best = scores[cand].max()
            cand = cand[scores[cand] >= min_score_ratio * best]
            cand = cand[np.argsort(-scores[cand])]
            return [int(c) for c in cand[:max_candidates]]
        acc = np.zeros(len(cand))
        best_of = np.zeros(len(cand), int)
        for j, i in enumerate(cand):
            w = covis[i].copy()
            w[~ok] = 0
            nb = np.argsort(-w)[:10]
            group = np.concatenate([[i], nb[w[nb] > 0]])
            acc[j] = scores[group].sum()
            best_of[j] = int(group[np.argmax(scores[group])])
        best_acc = acc.max()
        out: list[int] = []
        for j in np.argsort(-acc):
            if acc[j] < min_score_ratio * best_acc:
                break
            if best_of[j] not in out:
                out.append(int(best_of[j]))
        return out[:max_candidates]
