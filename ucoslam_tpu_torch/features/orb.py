"""ORB keypoints: FAST per pyramid level, IC angle, rotated BRIEF.

Port of the ORB family of `ucoslam_tpu/features/orb.py`
(`ORBExtractor._detect_and_compute`). The sampling pattern, the rotation
bins and the in-patch blur are the reference's. Where the reference selects
the rotated samples with a one-hot bf16 matmul, this port gathers them: a
one-hot product selects one value, so both give the blurred intensity
rounded to bf16, and both compare in bf16 (the one deliberate bf16 site of
the engine).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ucoslam_tpu_torch.ops.fast import fast_score_map, nms3x3, topk_grid
from ucoslam_tpu_torch.ops.image import build_pyramid, extract_patches, gaussian_kernel1d

PATCH_RADIUS = 15
EDGE_MARGIN = 19  # keypoints closer than this to a level border are dropped
N_PAIRS = 256
PATTERN_RADIUS = 13  # max pattern norm: rotated samples stay inside the patch
DESC_BINS = 32  # rotation tables (11.25 degree quantization)
BLUR_K = 7  # in-patch Gaussian (the reference's GaussianBlur(7, 7, 2))
BLUR_SIGMA = 2.0


def _brief_pattern(seed: int = 42) -> np.ndarray:
    """(256, 2, 2) sampling-pair offsets (the reference's seeded pattern)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, PATCH_RADIUS / 5.0 * 2.0, size=(N_PAIRS, 2, 2))
    norm = np.linalg.norm(pts, axis=-1, keepdims=True).clip(1e-9)
    pts = pts * np.minimum(1.0, PATTERN_RADIUS / norm)
    return np.round(pts).astype(np.float32)


def _rotated_sample_index() -> np.ndarray:
    """(DESC_BINS, 512) flat patch index of each pattern sample rotated by
    2*pi*b/DESC_BINS, nearest pixel (the reference's rotation tables)."""
    P = 2 * PATCH_RADIUS + 1
    flat = _brief_pattern().reshape(-1, 2)  # (512, 2) pair-major
    out = np.zeros((DESC_BINS, 2 * N_PAIRS), np.int64)
    for b in range(DESC_BINS):
        a = 2.0 * np.pi * b / DESC_BINS
        ca, sa = np.cos(a), np.sin(a)
        rx = np.clip(np.round(ca * flat[:, 0] - sa * flat[:, 1]).astype(int) + PATCH_RADIUS, 0, P - 1)
        ry = np.clip(np.round(sa * flat[:, 0] + ca * flat[:, 1]).astype(int) + PATCH_RADIUS, 0, P - 1)
        out[b] = ry * P + rx
    return out


def _moment_kernel() -> np.ndarray:
    """(P*P, 2) disc-masked (x, y) weights for IC moments."""
    r = PATCH_RADIUS
    ys, xs = np.mgrid[-r : r + 1, -r : r + 1]
    disc = ((xs * xs + ys * ys) <= r * r).astype(np.float32)
    return np.stack([(xs * disc).reshape(-1), (ys * disc).reshape(-1)], -1).astype(np.float32)


SAMPLE_INDEX = _rotated_sample_index()
MOMENT_KERNEL = _moment_kernel()


@dataclass
class Keypoints:
    """Fixed-capacity keypoint batch of one frame (level-0 pixel coords)."""

    xy: torch.Tensor  # (N, 2) float32 raw (distorted) level-0 coords
    response: torch.Tensor  # (N,) float32 FAST score
    octave: torch.Tensor  # (N,) int32
    angle: torch.Tensor  # (N,) float32 radians
    desc: torch.Tensor  # (N, 8) int32 (uint32 bits)
    valid: torch.Tensor  # (N,) bool


def _level_budgets(total: int, n_levels: int, scale_factor: float) -> list[int]:
    """Features per level proportional to level area (geometric decay)."""
    inv = 1.0 / scale_factor
    weights = np.array([inv ** (2 * lv) for lv in range(n_levels)])
    raw = weights / weights.sum() * total
    budgets = [max(8, int(round(r))) for r in raw]
    budgets[0] += total - sum(budgets)
    return budgets


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N, 256) {0, 1} -> (N, 8) int32 words, bit 0 of word 0 first."""
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = (bits.to(torch.int64).reshape(-1, 8, 32) << shifts).sum(-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


class ORBExtractor:
    """ORB detector + rBRIEF descriptor; configuration fixed at construction."""

    def __init__(
        self,
        max_features: int = 2048,
        n_levels: int = 8,
        scale_factor: float = 1.2,
        fast_threshold: float = 7.0,
        cell: int = 32,
        k_per_cell: int = 4,
    ):
        self.max_features = max_features
        self.n_levels = n_levels
        self.scale_factor = scale_factor
        self.fast_threshold = fast_threshold
        self.cell = cell
        self.k_per_cell = k_per_cell
        self.budgets = _level_budgets(max_features, n_levels, scale_factor)
        self.scales = [scale_factor**lv for lv in range(n_levels)]

    def _detect_level(self, level_img: torch.Tensor, budget: int, threshold):
        score = nms3x3(fast_score_map(level_img, threshold))
        h, w = level_img.shape
        interior = torch.zeros_like(score, dtype=torch.bool)
        interior[EDGE_MARGIN : h - EDGE_MARGIN, EDGE_MARGIN : w - EDGE_MARGIN] = True
        return topk_grid(torch.where(interior, score, 0.0), self.cell, self.k_per_cell, budget)

    def _extract_support_patches(self, level_img: torch.Tensor, xy: torch.Tensor):
        """(N, 37, 37) raw patches: descriptor patch + blur support ring."""
        support = PATCH_RADIUS + BLUR_K // 2
        need = 2 * support + 1
        h, w = level_img.shape
        if h < need or w < need:
            # levels smaller than one patch yield no valid keypoints
            level_img = torch.nn.functional.pad(
                level_img, (0, max(0, need - w), 0, max(0, need - h))
            )
        return extract_patches(level_img, xy, support)

    def _orient_and_describe(self, patches: torch.Tensor):
        """Patch batch (all levels) -> IC angles (N,) + descriptors (N, 8)."""
        P = 2 * PATCH_RADIUS + 1
        b = BLUR_K // 2
        dev = patches.device
        raw = patches[:, b : b + P, b : b + P].reshape(-1, P * P)
        mom = raw @ torch.from_numpy(MOMENT_KERNEL).to(dev)
        ang = torch.atan2(mom[:, 1], mom[:, 0])
        bidx = torch.round(ang / (2.0 * np.pi) * DESC_BINS).to(torch.int64) % DESC_BINS
        k = gaussian_kernel1d(BLUR_K, BLUR_SIGMA)
        tmp = sum(float(k[i]) * patches[:, i : i + P, :] for i in range(BLUR_K))
        blur = sum(float(k[i]) * tmp[:, :, i : i + P] for i in range(BLUR_K))
        index = torch.from_numpy(SAMPLE_INDEX).to(dev)[bidx]  # (N, 512)
        samp = torch.gather(blur.reshape(-1, P * P).to(torch.bfloat16), 1, index)
        bits = samp[:, 0::2] < samp[:, 1::2]  # (N, 256) pair-major endpoints
        return ang, pack_bits(bits)

    def detect_and_compute(self, img: torch.Tensor) -> Keypoints:
        """img: (H, W) float32 grayscale -> Keypoints with n = max_features."""
        levels = build_pyramid(img, self.n_levels, self.scale_factor)
        xys, resps, octs, valids, patches = [], [], [], [], []
        for lv, level_img in enumerate(levels):
            budget = self.budgets[lv]
            xy, resp, valid = self._detect_level(level_img, budget, self.fast_threshold)
            patches.append(self._extract_support_patches(level_img, xy))
            xys.append(xy * self.scales[lv])
            resps.append(resp)
            octs.append(torch.full((budget,), lv, dtype=torch.int32, device=img.device))
            valids.append(valid)
        ang, desc = self._orient_and_describe(torch.cat(patches))
        return Keypoints(
            xy=torch.cat(xys), response=torch.cat(resps), octave=torch.cat(octs),
            angle=ang, desc=desc, valid=torch.cat(valids),
        )
