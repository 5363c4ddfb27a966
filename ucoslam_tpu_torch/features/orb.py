"""Keypoints: FAST per pyramid level, IC angle, and a 256-bit descriptor.

Port of `ucoslam_tpu/features/orb.py` (`ORBExtractor._detect_and_compute`)
with its three descriptor families, which share detection, the support
patches and the angle:

- "orb", rotated BRIEF: the reference's sampling pattern, 32 rotation bins
  and in-patch blur. Where the reference selects the rotated samples with a
  one-hot bf16 matmul, this port gathers them: a one-hot product selects one
  value, so both give the blurred intensity rounded to bf16, and both
  compare in bf16.
- "freak" and "surf" (`features/descriptors.py`): the angle is quantized to
  the tables' own 64 bins. Each retina sample or subregion sum weighs all
  961 patch pixels, so the reference's one-hot einsum (bf16 operands, the
  result in bf16) becomes one float32 product of the bf16-rounded patch
  with every bin's bf16-rounded table, `(N, 961) @ (961, 64 * S)`, the
  keypoint's bin selected and rounded to bf16; no per-keypoint table is
  gathered. The sums run in another order than XLA's, so a sample can
  round to the neighbouring bf16 value and a comparison near a tie can
  flip. SURF's LSH signs come from a float32 product: TF32 is turned off
  (`slam.system.disable_tf32`), since it flips signs near zero.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ucoslam_tpu_torch.features import descriptors
from ucoslam_tpu_torch.ops.cuda.fast_kernel import fast_cells, select_keypoints
from ucoslam_tpu_torch.ops.image import Pyramid, gaussian_kernel1d
from ucoslam_tpu_torch.utils.timers import timers

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
        descriptor: str = "orb",
    ):
        if descriptor not in ("orb", "freak", "surf"):
            raise ValueError(f"unknown descriptor family {descriptor!r}")
        if descriptor != "orb":
            from ucoslam_tpu_torch.slam.system import disable_tf32

            disable_tf32()
        self.descriptor = descriptor
        self._tables = {}  # device -> the descriptor's tables there
        self.max_features = max_features
        self.n_levels = n_levels
        self.scale_factor = scale_factor
        self.fast_threshold = fast_threshold
        self.cell = cell
        self.k_per_cell = k_per_cell
        self.budgets = _level_budgets(max_features, n_levels, scale_factor)
        self.scales = [scale_factor**lv for lv in range(n_levels)]

    def _pyramid(self, img: torch.Tensor) -> Pyramid:
        return Pyramid(*img.shape, self.n_levels, self.scale_factor, img.device)

    def _orient_and_describe(self, patches: torch.Tensor):
        """Patch batch (all levels) -> IC angles (N,) + descriptors (N, 8)."""
        P = 2 * PATCH_RADIUS + 1
        b = BLUR_K // 2
        t = self._device_tables(patches.device)
        raw = patches[:, b : b + P, b : b + P].reshape(-1, P * P)
        mom = raw @ t["moment"]
        ang = torch.atan2(mom[:, 1], mom[:, 0])
        if self.descriptor != "orb":
            return ang, self._describe_table_family(patches, raw, ang, t)
        bidx = torch.round(ang / (2.0 * np.pi) * DESC_BINS).to(torch.int64) % DESC_BINS
        k = gaussian_kernel1d(BLUR_K, BLUR_SIGMA)
        tmp = sum(float(k[i]) * patches[:, i : i + P, :] for i in range(BLUR_K))
        blur = sum(float(k[i]) * tmp[:, :, i : i + P] for i in range(BLUR_K))
        index = t["sample_index"][bidx]  # (N, 512)
        samp = torch.gather(blur.reshape(-1, P * P).to(torch.bfloat16), 1, index)
        bits = samp[:, 0::2] < samp[:, 1::2]  # (N, 256) pair-major endpoints
        return ang, pack_bits(bits)

    def _device_tables(self, dev: torch.device) -> dict:
        """The descriptor's tables on `dev`, once: the IC moment weights, and
        ORB's rotated sample index or the family's tables, each bin's table
        rounded to bf16 (as the reference's operands) and laid out
        (P*P, BINS * S)."""
        key = str(dev)
        if key not in self._tables:
            t = {"moment": torch.from_numpy(MOMENT_KERNEL).to(dev)}
            if self.descriptor == "orb":
                t["sample_index"] = torch.from_numpy(SAMPLE_INDEX).to(dev)
                self._tables[key] = t
                return t
            if self.descriptor == "freak":
                t["pairs"] = torch.from_numpy(descriptors.FREAK_PAIRS.astype(np.int64)).to(dev)
                src = descriptors.freak_tables()
            else:
                t["proj"] = torch.from_numpy(descriptors.surf_lsh_projection()).to(dev)
                src = descriptors.surf_tables()
            bins, pp, s = src.shape
            w = torch.from_numpy(src).to(torch.bfloat16).to(torch.float32)
            t["table"] = w.permute(1, 0, 2).reshape(pp, bins * s).contiguous().to(dev)
            t["width"] = s
            self._tables[key] = t
        return self._tables[key]

    @staticmethod
    def _binned(x: torch.Tensor, t: dict, bidx: torch.Tensor) -> torch.Tensor:
        """(N, P*P) pixels -> (N, S): the bf16-rounded pixels through each
        keypoint's bin of the table, summed in float32, rounded to bf16."""
        s = t["width"]
        full = x.to(torch.bfloat16).to(torch.float32) @ t["table"]  # (N, BINS * S)
        sel = full.view(x.shape[0], -1, s).gather(1, bidx[:, None, None].expand(-1, 1, s))[:, 0]
        return sel.to(torch.bfloat16)

    def _describe_table_family(self, patches: torch.Tensor, raw: torch.Tensor, ang: torch.Tensor, t: dict):
        """FREAK or SURF descriptors (N, 8), the angle quantized to the
        tables' DESC_BINS (`t`: the tables on the patches' device)."""
        P = 2 * PATCH_RADIUS + 1
        b = BLUR_K // 2
        nb = descriptors.DESC_BINS
        bidx = torch.round(ang / (2.0 * np.pi) * nb).to(torch.int64) % nb
        if self.descriptor == "freak":
            samp = self._binned(raw, t, bidx)  # (N, 43) smoothed retina samples
            bits = samp[:, t["pairs"][:, 0]] < samp[:, t["pairs"][:, 1]]
            return pack_bits(bits)
        # SURF: central differences on the support patch, valid over the
        # 31x31 centre, rotated into the keypoint's frame by its bin's angle
        gx = (patches[:, b : b + P, b + 1 : b + 1 + P] - patches[:, b : b + P, b - 1 : b - 1 + P]) * 0.5
        gy = (patches[:, b + 1 : b + 1 + P, b : b + P] - patches[:, b - 1 : b - 1 + P, b : b + P]) * 0.5
        a_q = 2.0 * np.pi * bidx.to(torch.float32) / nb
        ca, sa = torch.cos(a_q)[:, None], torch.sin(a_q)[:, None]
        gxf, gyf = gx.reshape(-1, P * P), gy.reshape(-1, P * P)
        gxr = ca * gxf + sa * gyf
        gyr = -sa * gxf + ca * gyf
        feats = torch.cat([self._binned(m, t, bidx) for m in (gxr, gxr.abs(), gyr, gyr.abs())], -1).to(torch.float32)
        feats = feats / torch.linalg.norm(feats, dim=-1, keepdim=True).clamp(min=1e-6)
        return pack_bits(feats @ t["proj"] > 0.0)

    def detect_and_compute(self, img: torch.Tensor) -> Keypoints:
        """img: (H, W) float32 grayscale -> Keypoints with n = max_features."""
        with timers.span("frontend.detect"):
            pyr = self._pyramid(img)
            levels = pyr(img)
            cand = fast_cells(levels, pyr, self.fast_threshold, self.cell, self.k_per_cell, EDGE_MARGIN)
            xy, response, octave, valid, patches = select_keypoints(
                levels, pyr, *cand, self.cell, self.k_per_cell, self.budgets, self.scales,
                PATCH_RADIUS + BLUR_K // 2)
        with timers.span("frontend.describe"):
            ang, desc = self._orient_and_describe(patches)
        return Keypoints(xy=xy, response=response, octave=octave, angle=ang, desc=desc, valid=valid)
