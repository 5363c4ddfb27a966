"""AKAZE and BRISK keypoints through OpenCV, tiled over an image grid.

Port of `ucoslam_tpu/features/grid_extractor.py` (the reference's
GridExtractor, gridextractor.{h:29,cpp:36-285}): cv2's detector on the host,
the budget split over a 4x4 tile lattice (best response first in each tile,
the rest of the budget filled by response), cv2's octave decoded, and each
descriptor cut or zero-padded to the unified 256 bits, so that B1 and the
Hamming code serve these families unchanged. Each family's gate on the
256 bits is `config.hamming_gate_for`'s (the reference's per-family
distances of gridextractor.cpp:36-39 scaled to 256 bits).

This path needs cv2, imported where the reference imports it (the
constructor and `detect_and_compute`); the rest of the port needs none.
Without cv2, AKAZE and BRISK raise cv2's ImportError, as in the reference;
OpenCV 5 moved both detectors out of its main module, so there they raise
its AttributeError, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ucoslam_tpu_torch.config import DescriptorType, Params
from ucoslam_tpu_torch.features.orb import Keypoints


class GridExtractor:
    def __init__(self, params: Params, device="cuda"):
        import cv2

        self.params = params
        self.device = torch.device(device)
        t = params.kpDescriptorType
        if t == DescriptorType.AKAZE:
            self._det = cv2.AKAZE_create()
        elif t == DescriptorType.BRISK:
            self._det = cv2.BRISK_create()
        elif t == DescriptorType.ORB:
            self._det = cv2.ORB_create(nfeatures=params.maxKeyPointsPerFrame)
        else:
            raise ValueError(f"unsupported GridExtractor type {t}")
        self.n_slots = params.maxKeyPointsPerFrame

    @staticmethod
    def _decode_octave(kp_octave: int) -> int:
        """cv2's keypoint octave: BRISK and AKAZE store a small integer; the
        packed form keeps a signed octave in bits 0-7 (-1: the upscaled base
        layer), read as 0."""
        o = int(kp_octave) & 0xFF
        if o >= 128:
            o -= 256
        return max(0, o)

    def _grid_select(self, kps, w: int, h: int, grid: int = 4) -> list[int]:
        """The slots' keypoints: per tile of a grid x grid lattice the best
        n_slots / grid^2 by response, then the rest of the budget by
        response over the whole image."""
        if not kps:
            return []
        per_tile = max(1, self.n_slots // (grid * grid))
        tiles: dict[tuple[int, int], list[int]] = {}
        for i, k in enumerate(kps):
            tx = min(int(k.pt[0] * grid / max(w, 1)), grid - 1)
            ty = min(int(k.pt[1] * grid / max(h, 1)), grid - 1)
            tiles.setdefault((ty, tx), []).append(i)
        chosen: list[int] = []
        leftovers: list[int] = []
        for idx in tiles.values():
            idx = sorted(idx, key=lambda i: -kps[i].response)
            chosen.extend(idx[:per_tile])
            leftovers.extend(idx[per_tile:])
        leftovers.sort(key=lambda i: -kps[i].response)
        chosen.extend(leftovers[: max(0, self.n_slots - len(chosen))])
        return chosen[: self.n_slots]

    def detect_and_compute(self, img) -> Keypoints:
        """(H, W) gray (or (H, W, 3) BGR) image, array or tensor ->
        Keypoints of n_slots rows on the extractor's device."""
        import cv2

        arr = img.detach().cpu().numpy() if isinstance(img, torch.Tensor) else np.asarray(img)
        if arr.dtype != np.uint8:
            arr = np.clip(arr, 0, 255).astype(np.uint8)
        if arr.ndim == 3:
            arr = cv2.cvtColor(arr, cv2.COLOR_BGR2GRAY)
        kps, desc = self._det.detectAndCompute(arr, None)
        order = self._grid_select(kps, arr.shape[1], arr.shape[0])
        xy = np.zeros((self.n_slots, 2), np.float32)
        resp = np.zeros(self.n_slots, np.float32)
        octv = np.zeros(self.n_slots, np.int32)
        ang = np.zeros(self.n_slots, np.float32)
        packed = np.zeros((self.n_slots, 8), np.uint32)
        for j, i in enumerate(order):
            k = kps[i]
            xy[j] = k.pt
            resp[j] = k.response
            octv[j] = self._decode_octave(k.octave)
            ang[j] = np.deg2rad(k.angle) if k.angle >= 0 else 0.0
            raw = np.zeros(32, np.uint8)
            raw[: min(32, len(desc[i]))] = desc[i][:32]
            packed[j] = raw.view(np.uint32)
        valid = np.arange(self.n_slots) < len(order)
        dev = self.device
        return Keypoints(
            xy=torch.from_numpy(xy).to(dev), response=torch.from_numpy(resp).to(dev),
            octave=torch.from_numpy(octv).to(dev), angle=torch.from_numpy(ang).to(dev),
            desc=torch.from_numpy(packed.view(np.int32)).to(dev), valid=torch.from_numpy(valid).to(dev),
        )
