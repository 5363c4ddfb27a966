"""fbow vocabulary file I/O (.fbow), reference-format compatible.

A copy of `ucoslam_tpu/io/fbow.py` (numpy only), so the port imports
nothing of the JAX package. A `.fbow` file (fbow::Vocabulary, fbow.h:97) is
a uint64 magic 55824124, a params struct, then `_total_size` bytes of
fixed-size blocks; each block is `N | isLeaf | parentId | pad | F0..FN |
C0W0..CNWN` (fbow.h:163-172), where a leaf node's info carries its word id
(msb set) and weight (fbow.h:138-158). `load_fbow` flattens the tree to its
leaf words (feature, word id, weight): the port quantizes by an exact
Hamming argmin over the flat set (`mapping/kfdatabase.py`). `save_fbow`
writes a valid 2-level tree. The descriptors stay uint32 here; the port's
(n, 8) int32 tensors hold the same bits (`.view(np.int32)`).
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

FBOW_MAGIC = 55824124
# char[50] name, pad2, u32 aligment, u32 nblocks, pad4, 5x u64 (desc_size_wp,
# block_size_wp, feature_off, child_off, total_size), i32 desc_type,
# i32 desc_size, u32 m_k, pad4  -> 120 bytes (C default alignment)
_PARAMS_FMT = "<50s2xII4xQQQQQiiI4x"
assert struct.calcsize(_PARAMS_FMT) == 120


class FbowVocab(NamedTuple):
    """Flattened vocabulary: one row per leaf word."""

    desc: np.ndarray  # (W, D_u32) uint32 binary centroids
    weight: np.ndarray  # (W,) float32 word weight (idf-style from training)
    word_id: np.ndarray  # (W,) int32 original fbow word ids
    desc_name: str = "orb"
    k: int = 0  # branching factor of the source tree
    desc_size: int = 32  # descriptor bytes (without padding)


def load_fbow(path: str) -> FbowVocab:
    """Parse a .fbow file and flatten the tree to its leaf words."""
    with open(path, "rb") as f:
        raw = f.read()
    (magic,) = struct.unpack_from("<Q", raw, 0)
    if magic != FBOW_MAGIC:
        raise ValueError(f"{path}: not a fbow file (magic {magic})")
    (
        name_b, aligment, nblocks, desc_size_wp, block_size_wp,
        feature_off, child_off, total_size, desc_type, desc_size, m_k,
    ) = struct.unpack_from(_PARAMS_FMT, raw, 8)
    data = np.frombuffer(raw, np.uint8, count=total_size, offset=8 + 120)
    desc_name = name_b.split(b"\0")[0].decode("ascii", "replace")

    descs, weights, ids = [], [], []
    for b in range(nblocks):
        base = b * block_size_wp
        n = int(np.frombuffer(data, np.uint16, 1, base)[0])
        nodes = np.frombuffer(
            data, np.dtype([("id", "<u4"), ("w", "<f4")]), n, base + child_off
        )
        feats = data[base + feature_off: base + feature_off + n * desc_size_wp]
        feats = feats.reshape(n, desc_size_wp)[:, :desc_size]
        leaf = (nodes["id"] & 0x80000000) != 0
        if leaf.any():
            descs.append(feats[leaf])
            weights.append(nodes["w"][leaf])
            ids.append((nodes["id"][leaf] & 0x7FFFFFFF).astype(np.int32))
    if not descs:
        raise ValueError(f"{path}: vocabulary has no leaf words")
    desc8 = np.concatenate(descs)
    pad = (-desc8.shape[1]) % 4
    if pad:
        desc8 = np.pad(desc8, ((0, 0), (0, pad)))
    desc_u32 = np.ascontiguousarray(desc8).view("<u4").reshape(desc8.shape[0], -1)
    return FbowVocab(
        desc=desc_u32,
        weight=np.concatenate(weights).astype(np.float32),
        word_id=np.concatenate(ids),
        desc_name=desc_name,
        k=int(m_k),
        desc_size=int(desc_size),
    )


def save_fbow(
    path: str,
    desc_u32: np.ndarray,
    weight: np.ndarray | None = None,
    desc_name: str = "orb",
) -> None:
    """Write a flat vocabulary as a valid 2-level .fbow tree.

    The root block routes to ceil(W/k) child blocks (node feature = the
    chunk's first centroid); each child block holds up to k leaf words.
    Readable by the reference fbow and by load_fbow.
    """
    desc_u32 = np.ascontiguousarray(desc_u32, dtype="<u4")
    W = desc_u32.shape[0]
    desc_size = desc_u32.shape[1] * 4
    if weight is None:
        weight = np.ones(W, np.float32)
    k = int(np.ceil(np.sqrt(W)))
    k = max(2, min(k, 0x7FFF))
    n_child = -(-W // k)
    nblocks = 1 + n_child

    aligment = 8
    desc_size_wp = -(-desc_size // aligment) * aligment
    feature_off = 8  # u16 N, u16 isLeaf, u32 parentId
    max_n = max(k, n_child)
    child_off = feature_off + max_n * desc_size_wp
    block_size_wp = child_off + max_n * 8
    block_size_wp = -(-block_size_wp // aligment) * aligment
    total_size = nblocks * block_size_wp

    data = np.zeros(total_size, np.uint8)
    desc8 = desc_u32.view(np.uint8).reshape(W, desc_size)

    def write_block(b, n, is_leaf, parent, feats, node_ids, node_ws):
        base = b * block_size_wp
        data[base:base + 2] = np.frombuffer(struct.pack("<H", n), np.uint8)
        data[base + 2:base + 4] = np.frombuffer(
            struct.pack("<H", 1 if is_leaf else 0), np.uint8
        )
        data[base + 4:base + 8] = np.frombuffer(struct.pack("<I", parent), np.uint8)
        for i in range(n):
            o = base + feature_off + i * desc_size_wp
            data[o:o + desc_size] = feats[i]
            no = base + child_off + i * 8
            data[no:no + 8] = np.frombuffer(
                struct.pack("<If", node_ids[i], node_ws[i]), np.uint8
            )

    # root: one non-leaf node per child block (id = child block index)
    reps = desc8[np.arange(n_child) * k]
    write_block(
        0, n_child, False, 0, reps,
        [b + 1 for b in range(n_child)], [0.0] * n_child,
    )
    for b in range(n_child):
        lo, hi = b * k, min((b + 1) * k, W)
        ids = [0x80000000 | w for w in range(lo, hi)]
        write_block(
            b + 1, hi - lo, True, 0, desc8[lo:hi], ids, weight[lo:hi],
        )

    params = struct.pack(
        _PARAMS_FMT, desc_name.encode()[:49], aligment, nblocks,
        desc_size_wp, block_size_wp, feature_off, child_off, total_size,
        0, desc_size, k,
    )
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", FBOW_MAGIC))
        f.write(params)
        f.write(data.tobytes())


def default_vocab_path() -> str | None:
    """Bundled trained vocabulary (data/vocab.fbow), if present.

    The repository's trained vocabulary (16384 words, k = 128, ORB), the
    one the reference harness loads with `--voc auto`.
    """
    import os

    root = os.path.dirname(os.path.dirname(os.path.dirname(__file__)))
    p = os.path.join(root, "data", "vocab.fbow")
    return p if os.path.exists(p) else None
