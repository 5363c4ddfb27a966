"""Binary-descriptor vocabulary trainer (k-majority clustering) on the device.

Port of `ucoslam_tpu/features/vocab_trainer.py`, the tool that trains the
repository's `data/vocab.fbow`: ORB descriptors harvested from rendered
scenes, flat k-majority clustering (assignment by the nearest centroid in
Hamming distance, the lowest word on ties; update by a per-bit majority
vote, re-seeding empty clusters), and idf word weights from each word's
document frequency over the training images. The result is written with
`io.fbow.save_fbow`.

The assignment is `mapping.kfdatabase.quantize_words` over chunks of 8192
descriptors (the word search chunked over the vocabulary with strict `<`
across chunks, as `jnp.argmin` breaks ties); the majority sums are integer
sums, exact in any order, on the device. The random draws (the initial
centroids, the donors of empty clusters) and the idf's `np.unique` stay on
the host in numpy with the reference's seed, so that a device and the CPU
give the same vocabulary as the reference on the same descriptors.

    python -m ucoslam_tpu_torch.features.vocab_trainer --out data/vocab.fbow \\
        [--words 2048] [--iters 8] [--frames 120] [--seed 0] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ucoslam_tpu_torch.mapping.kfdatabase import quantize_words

#: descriptors a word search takes at a time
ASSIGN_CHUNK = 8192


def harvest_descriptors(n_frames: int = 120, max_features: int = 1500, seeds=(11, 23, 37, 51), device="cuda"):
    """-> (descriptors (M, 8) uint32, image id (M,) int32, images): the
    port's ORB on `device` over rendered scenes of the reference's seeds,
    trajectories and roll, n_frames // len(seeds) frames each."""
    from ucoslam_tpu_torch.features.orb import ORBExtractor
    from ucoslam_tpu_torch.io.synthetic import SyntheticSequence

    orb = ORBExtractor(max_features=max_features)
    descs, img_ids = [], []
    img = 0
    per_seq = max(1, n_frames // len(seeds))
    trajs = ["arc", "line", "loop", "orbit_out"]
    for si, seed in enumerate(seeds):
        seq = SyntheticSequence(n_frames=per_seq, n_points=1500, seed=seed, trajectory=trajs[si % len(trajs)],
                                roll_deg=20.0 * (si % 2))
        for i in range(per_seq):
            kps = orb.detect_and_compute(torch.from_numpy(np.asarray(seq.render(i), np.float32)).to(device))
            d = kps.desc[kps.valid].cpu().numpy().view(np.uint32)
            descs.append(d)
            img_ids.append(np.full(len(d), img, np.int32))
            img += 1
    return np.concatenate(descs), np.concatenate(img_ids), img


def _hamming_assign(desc: torch.Tensor, cent: torch.Tensor, chunk: int = ASSIGN_CHUNK) -> torch.Tensor:
    """(N,) int64 nearest-centroid index of each (N, 8) int32 descriptor,
    the lowest index on ties."""
    return torch.cat([quantize_words(desc[lo : lo + chunk], cent) for lo in range(0, desc.shape[0], chunk)])


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """(N, 8) int32 words -> (N, 256) int32 bits, bit j of word w at w * 32 + j."""
    shifts = torch.arange(32, device=desc.device, dtype=torch.int32)
    return ((desc[:, :, None] >> shifts) & 1).reshape(desc.shape[0], -1)


def _majority_update(desc: torch.Tensor, assign: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (new centroids (k, 8) int32: each bit set where more than half
    of the cluster's members have it, counts (k,) int64)."""
    from ucoslam_tpu_torch.features.orb import pack_bits

    sums = torch.zeros((k, 256), dtype=torch.int32, device=desc.device).index_add_(0, assign, unpack_bits(desc))
    counts = torch.bincount(assign, minlength=k)
    return pack_bits(sums * 2 > counts[:, None]), counts


def train_vocabulary(desc_u32: np.ndarray, img_ids: np.ndarray, n_images: int, k: int = 2048, iters: int = 8,
                     seed: int = 0, device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """-> (centroids (k, 8) uint32, idf weights (k,) float32)."""
    rng = np.random.default_rng(seed)
    n = desc_u32.shape[0]
    k = min(k, n)
    desc = torch.from_numpy(np.ascontiguousarray(desc_u32).view(np.int32)).to(device)
    cent = desc[torch.from_numpy(rng.choice(n, k, replace=False)).to(device)]
    for _ in range(iters):
        cent, counts = _majority_update(desc, _hamming_assign(desc, cent), k)
        empty = np.nonzero(counts.cpu().numpy() == 0)[0]
        if len(empty):  # re-seeded from random descriptors
            donors = rng.choice(n, len(empty), replace=False)
            cent[torch.from_numpy(empty).to(device)] = desc[torch.from_numpy(donors).to(device)]
    assign = _hamming_assign(desc, cent).cpu().numpy()
    # idf: log(images / images containing the word), DBoW2-style
    pairs = np.unique(np.stack([assign, img_ids[: len(assign)]]), axis=1)
    df = np.bincount(pairs[0], minlength=k).astype(np.float64)
    idf = np.clip(np.log(n_images / np.clip(df, 1, None)).astype(np.float32), 1e-3, None)
    return cent.cpu().numpy().view(np.uint32), idf


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="data/vocab.fbow")
    ap.add_argument("--words", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ucoslam_tpu_torch.io.fbow import save_fbow

    print("harvesting descriptors ...", flush=True)
    t0 = time.perf_counter()
    desc, img_ids, n_images = harvest_descriptors(args.frames, device=args.device)
    t1 = time.perf_counter()
    print(f"  {len(desc)} descriptors from {n_images} images in {t1 - t0:.3f} s", flush=True)
    cent, w = train_vocabulary(desc, img_ids, n_images, k=args.words, iters=args.iters, seed=args.seed,
                               device=args.device)
    t2 = time.perf_counter()  # train_vocabulary ends with a copy to the host
    print(f"  trained {args.iters} iterations in {t2 - t1:.3f} s ({(t2 - t1) / (args.iters + 1):.3f} s for each "
          f"of {args.iters + 1} assignments)", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    save_fbow(args.out, cent, w)
    print(f"wrote {args.out}: {len(cent)} words")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
