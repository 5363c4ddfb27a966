"""Plain reference of the frontend's answers: the keypoints a frame should
have, and each keypoint's orientation and rotated-BRIEF descriptor, worked
out again from the input image.

The semantics are those the configuration states for the ORB family (the
reference package's `ORBExtractor`). Detection: on every pyramid level, the
FAST-9/16 score (the largest threshold at which 9 contiguous circle pixels
are all brighter, or all darker, than the centre; 0 unless above the FAST
threshold), 3x3 non-maximum suppression (strict maxima; a plateau keeps its
first pixel in scan order), no keypoint within 19 px of the level's border,
then the best `k_per_cell` of each `cell`-sized tile and the best of those
up to the level's share of the keypoint budget (shares proportional to the
level's area), lower index first among equal scores. Description: an image
pyramid of levels resized
directly from level 0 by the anti-aliased triangle filter
(`jax.image.resize(..., "linear")`), a 31x31 patch around the keypoint's
rounded level position (clamped into the level), the intensity-centroid
angle over the radius-15 disc, a 7x7 Gaussian blur (sigma 2) of the patch,
and 256 comparisons of the blurred samples at the seeded BRIEF pattern
rotated to the nearest of 32 angle bins, both samples rounded to bfloat16
before they are compared. Everything here is float64 (the rounding to
bfloat16 is the format's own step, not a loss of precision in the check)
and plain torch; it imports nothing of the program.

`compare` reads the program's keypoints (level-0 position, octave) and
judges its angles and descriptors against this reference; `keypoint_gap`
sets the keypoints the program found against those `detect` finds.
"""

from __future__ import annotations

import numpy as np
import torch

PATCH_RADIUS, BLUR_K, BLUR_SIGMA, N_PAIRS, PATTERN_RADIUS, DESC_BINS = 15, 7, 2.0, 256, 13, 32
EDGE_MARGIN = 19
#: the FAST circle of radius 3, in circular order, as (dy, dx)
CIRCLE = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
          (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1))
#: a bin boundary this close (in bins) to an angle is within float32 rounding
#: of the bin formula: one keypoint of 150 x 2048 on the card lay at -7.5000
#: bins, where the card and the CPU round the quotient to neighbouring bins
TIE_BINS = 1e-4


def brief_pattern(seed: int = 42) -> np.ndarray:
    """(256, 2, 2) sample-pair offsets: normal draws (sigma 6 px) from the
    seed, pulled inside radius 13, rounded."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, PATCH_RADIUS / 5.0 * 2.0, size=(N_PAIRS, 2, 2))
    norm = np.linalg.norm(pts, axis=-1, keepdims=True).clip(1e-9)
    return np.round(pts * np.minimum(1.0, PATTERN_RADIUS / norm))


def rotated_index() -> np.ndarray:
    """(32, 512) flat index into the 31x31 patch of every pattern sample
    rotated by each bin's angle, nearest pixel."""
    P = 2 * PATCH_RADIUS + 1
    flat = brief_pattern().reshape(-1, 2)
    out = np.zeros((DESC_BINS, 2 * N_PAIRS), np.int64)
    for b in range(DESC_BINS):
        a = 2.0 * np.pi * b / DESC_BINS
        rx = np.clip(np.round(np.cos(a) * flat[:, 0] - np.sin(a) * flat[:, 1]).astype(int) + PATCH_RADIUS, 0, P - 1)
        ry = np.clip(np.round(np.sin(a) * flat[:, 0] + np.cos(a) * flat[:, 1]).astype(int) + PATCH_RADIUS, 0, P - 1)
        out[b] = ry * P + rx
    return out


def triangle_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) anti-aliased linear resize weights, rows summing to 1."""
    scale = n_out / n_in
    kernel_scale = max(1.0, 1.0 / scale)
    sample = (np.arange(n_out) + 0.5) / scale - 0.5
    w = np.maximum(0.0, 1.0 - np.abs(sample[:, None] - np.arange(n_in)[None, :]) / kernel_scale)
    total = w.sum(1, keepdims=True)
    w = np.where(np.abs(total) > 1e-6, w / np.where(total == 0, 1.0, total), 0.0)
    in_span = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(in_span[:, None], w, 0.0)


def pyramid(img: torch.Tensor, n_levels: int, scale_factor: float) -> list[torch.Tensor]:
    h, w = img.shape
    out = [img]
    for lv in range(1, n_levels):
        s = 1.0 / scale_factor**lv
        oh, ow = int(round(h * s)), int(round(w * s))
        ah = torch.from_numpy(triangle_resize_matrix(h, oh)).to(img)
        aw = torch.from_numpy(triangle_resize_matrix(w, ow)).to(img)
        out.append(ah @ img @ aw.T)
    return out


def level_budgets(total: int, n_levels: int, scale_factor: float) -> list[int]:
    """Keypoints a level may keep: `total` shared in proportion to the
    levels' areas (at least 8 each), the remainder to level 0."""
    w = np.array([scale_factor ** (-2 * lv) for lv in range(n_levels)])
    budgets = [max(8, int(round(r))) for r in w / w.sum() * total]
    budgets[0] += total - sum(budgets)
    return budgets


def fast_scores(lvl: torch.Tensor, threshold: float) -> torch.Tensor:
    """(H, W) -> FAST-9/16 scores after 3x3 non-maximum suppression, 0 within
    EDGE_MARGIN of the border."""
    h, w = lvl.shape
    r = 3
    pad = torch.nn.functional.pad(lvl[None, None], (r, r, r, r), mode="replicate")[0, 0]
    circ = torch.stack([pad[r + dy:r + dy + h, r + dx:r + dx + w] for dy, dx in CIRCLE])
    best = torch.zeros_like(lvl)
    for diff in (circ - lvl, lvl - circ):
        for start in range(16):
            arc = diff[[(start + i) % 16 for i in range(9)]].amin(0)
            best = torch.maximum(best, arc)
    score = torch.where(best > threshold, best, torch.zeros_like(best))
    p = torch.nn.functional.pad(score, (1, 1, 1, 1), value=-1.0)
    keep = torch.ones_like(score, dtype=torch.bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if (dy, dx) == (0, 0):
                continue
            nb = p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            earlier = dy < 0 or (dy == 0 and dx < 0)
            keep &= (score > nb) if earlier else (score >= nb)
    out = torch.where(keep, score, torch.zeros_like(score))
    inner = torch.zeros_like(keep)
    inner[EDGE_MARGIN:h - EDGE_MARGIN, EDGE_MARGIN:w - EDGE_MARGIN] = True
    return torch.where(inner, out, torch.zeros_like(out))


def detect(img_u8: np.ndarray, n_levels: int, scale_factor: float, max_features: int, cell: int, k_per_cell: int,
           threshold: float, device="cpu") -> set[tuple[int, int, int]]:
    """The keypoints the reference finds: {(octave, x, y)} in the level's
    integer pixels."""
    img = torch.from_numpy(np.asarray(img_u8, np.float64)).to(device)
    found = set()
    for lv, (lvl, budget) in enumerate(zip(pyramid(img, n_levels, scale_factor),
                                           level_budgets(max_features, n_levels, scale_factor))):
        score = fast_scores(lvl, threshold).cpu().numpy()
        h, w = score.shape
        gh, gw = -(-h // cell), -(-w // cell)
        cand = []  # (score, y, x) in the order the tiles are read: tile by tile, each tile's best first
        for ty in range(gh):
            for tx in range(gw):
                tile = score[ty * cell:(ty + 1) * cell, tx * cell:(tx + 1) * cell]
                full = np.zeros((cell, cell))
                full[:tile.shape[0], :tile.shape[1]] = tile
                flat = full.reshape(-1)
                for i in np.argsort(-flat, kind="stable")[:k_per_cell]:
                    cand.append((flat[i], ty * cell + i // cell, tx * cell + i % cell))
        vals = np.array([c[0] for c in cand])
        for i in np.argsort(-vals, kind="stable")[:budget]:
            if vals[i] > 0:
                found.add((lv, int(cand[i][2]), int(cand[i][1])))
    return found


def keypoint_gap(img_u8, xy, octave, n_levels: int, scale_factor: float, max_features: int, cell: int,
                 k_per_cell: int, threshold: float, device="cpu") -> tuple[int, int]:
    """The program's keypoints of one image (level-0 xy, octave) against the
    reference's -> (keypoints of either set with none of the other set on
    their level within one pixel, keypoints of both sets together). The
    pixel of slack is rounding: on a float level two neighbouring pixels
    can score alike to the last bits, and suppression keeps whichever
    rounds higher."""
    ref = detect(img_u8, n_levels, scale_factor, max_features, cell, k_per_cell, threshold, device)
    got = {(int(o), int(x), int(y)) for o, (x, y) in
           zip(octave, np.round(np.asarray(xy, np.float64) / scale_factor ** np.asarray(octave)[:, None]))}

    def unmatched(a, b):
        return sum(1 for o, x, y in a if not any((o, x + dx, y + dy) in b for dx in (-1, 0, 1) for dy in (-1, 0, 1)))

    return unmatched(ref, got) + unmatched(got, ref), len(ref) + len(got)


def to_bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to the nearest bfloat16 (ties to even), returned as float64."""
    return x.to(torch.float32).to(torch.bfloat16).to(torch.float64)


def describe(img_u8: np.ndarray, xy: np.ndarray, octave: np.ndarray, n_levels: int, scale_factor: float,
             device="cpu", angle_for_bins: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (angle (N,), descriptor words (N, 8) as uint32, the words at the
    neighbouring bin where the angle lies within TIE_BINS of a bin boundary,
    else the same words) of keypoints at level-0 positions xy (N, 2) found
    on level `octave` (N,). The pattern is rotated to the bin of
    `angle_for_bins` when given, else to the bin of the angle worked out
    here."""
    img = torch.from_numpy(np.asarray(img_u8, np.float64)).to(device)
    levels = pyramid(img, n_levels, scale_factor)
    P, r = 2 * PATCH_RADIUS + 1, PATCH_RADIUS + BLUR_K // 2
    need = 2 * r + 1
    ys, xs = np.mgrid[-PATCH_RADIUS:PATCH_RADIUS + 1, -PATCH_RADIUS:PATCH_RADIUS + 1]
    disc = (xs * xs + ys * ys) <= PATCH_RADIUS * PATCH_RADIUS
    mx = torch.from_numpy((xs * disc).reshape(-1).astype(np.float64)).to(device)
    my = torch.from_numpy((ys * disc).reshape(-1).astype(np.float64)).to(device)
    k = np.exp(-((np.arange(BLUR_K) - BLUR_K // 2) ** 2) / (2 * BLUR_SIGMA**2))
    k = torch.from_numpy(k / k.sum()).to(device)
    index = torch.from_numpy(rotated_index()).to(device)
    ang_out = np.zeros(len(xy))
    desc_out = np.zeros((len(xy), 8), np.uint32)
    alt_out = np.zeros((len(xy), 8), np.uint32)
    for lv in np.unique(octave):
        sel = np.nonzero(octave == lv)[0]
        lvl = levels[int(lv)]
        h, w = lvl.shape
        if h < need or w < need:
            lvl = torch.nn.functional.pad(lvl, (0, max(0, need - w), 0, max(0, need - h)))
            h, w = lvl.shape
        q = torch.from_numpy(np.round(xy[sel].astype(np.float64) / scale_factor ** int(lv))).to(device)
        y0 = (q[:, 1].long() - r).clamp(0, h - need)
        x0 = (q[:, 0].long() - r).clamp(0, w - need)
        offs = torch.arange(need, device=device)
        patch = lvl[y0[:, None, None] + offs[None, :, None], x0[:, None, None] + offs[None, None, :]]
        b = BLUR_K // 2
        raw = patch[:, b:b + P, b:b + P].reshape(-1, P * P)
        ang = torch.atan2(raw @ my, raw @ mx)
        tmp = sum(k[i] * patch[:, i:i + P, :] for i in range(BLUR_K))
        blur = sum(k[i] * tmp[:, :, i:i + P] for i in range(BLUR_K)).reshape(-1, P * P)
        a = ang if angle_for_bins is None else torch.from_numpy(np.asarray(angle_for_bins, np.float64)[sel]).to(device)
        pos = a / (2 * np.pi) * DESC_BINS
        bins = torch.round(pos).long() % DESC_BINS
        # a bin boundary within float32 rounding: either neighbour is the bin
        tie = (pos - torch.floor(pos) - 0.5).abs() < TIE_BINS
        other = torch.where(pos - torch.round(pos) > 0, bins + 1, bins - 1) % DESC_BINS
        for j, b in enumerate((bins, other)):
            samp = to_bf16(torch.gather(blur, 1, index[b]))
            bits = (samp[:, 0::2] < samp[:, 1::2]).cpu().numpy().reshape(-1, 8, 32).astype(np.uint64)
            words = ((bits << np.arange(32, dtype=np.uint64)).sum(-1)).astype(np.uint32)
            if j == 0:
                desc_out[sel] = words
                ang_out[sel] = ang.cpu().numpy()
            else:
                alt_out[sel] = np.where(tie.cpu().numpy()[:, None], words, desc_out[sel])
    return ang_out, desc_out, alt_out


def compare(img_u8, xy, octave, angle, desc, n_levels: int, scale_factor: float, device="cpu") -> dict:
    """The program's keypoints of one image against the reference ->
    {"angle_gaps": (N,) radians, "bit_diffs": (N,) differing bits of 256}.
    The angle is judged on its own; the descriptor is judged at the
    program's angle bin, so that a keypoint whose angle lies within rounding
    of a bin boundary (float32 and float64 moments may fall either side,
    which rotates the pattern and changes 35-80 bits) does not count its
    bin against its bits; where the program's own angle sits on a boundary
    within float32 rounding, the nearer of the two bins' descriptors
    counts."""
    ref_ang, ref_desc, alt_desc = describe(img_u8, xy, octave, n_levels, scale_factor, device, angle_for_bins=angle)
    d = np.asarray(angle, np.float64) - ref_ang
    gaps = np.abs(np.arctan2(np.sin(d), np.cos(d)))
    got = np.asarray(desc).astype(np.uint32)

    def ndiff(ref):
        return np.unpackbits((got ^ ref).view(np.uint8), axis=1).sum(1)

    return {"angle_gaps": gaps, "bit_diffs": np.minimum(ndiff(ref_desc), ndiff(alt_desc))}
