"""Loop detection from keypoints, up to the candidate query.

Port of the first half of `ucoslam_tpu/slam/loopclosure.py`
(`LoopDetector.detect_from_keypoints`): the keyframe database is asked for
candidates, excluding the keyframe's covisible neighbours and the keyframes
within 10 frames of it. No candidate means no loop, as in the reference. A
candidate would need the geometric verification (keyframe matching and PnP
RANSAC) and the map correction (pose graph, Sim3), which are not ported, so
it raises NotImplementedError rather than skip the verification.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ucoslam_tpu_torch.config import Params
from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.mapping.frame import Frame
from ucoslam_tpu_torch.mapping.kfdatabase import KeyFrameDataBase
from ucoslam_tpu_torch.mapping.map import Map


@dataclass
class LoopClosureInfo:
    found: bool
    cur_kf: int
    matched_kf: int
    expected_pose: np.ndarray | None  # corrected pose_f2g of cur_kf
    n_matches: int = 0


class LoopDetector:
    def __init__(self, params: Params, cam: CameraParams, kfdb: KeyFrameDataBase):
        self.params = params
        self.cam = cam
        self.kfdb = kfdb
        self.n_queries = 0  # candidate queries made
        self.n_candidates = 0  # candidates the queries returned

    def detect_from_keypoints(self, world_map: Map, kf_slot: int, frame: Frame, min_fseq_gap: int = 10) -> LoopClosureInfo:
        """BoW candidates for keyframe kf_slot -> (verification: not ported)."""
        covis = world_map.covis_matrix()
        neighbours = set(np.nonzero(covis[kf_slot] > 0)[0].tolist()) | {kf_slot}
        kf_active = world_map.keyframes.active.copy()
        fseqs = world_map.h("kf_fseq")
        cur_seq = int(fseqs[kf_slot])
        recent = set(
            int(s) for s in np.nonzero(kf_active)[0] if abs(cur_seq - int(fseqs[s])) < min_fseq_gap
        )
        cands = self.kfdb.relocalization_candidates(
            frame.desc, frame.valid, kf_active, covis=covis, exclude=neighbours | recent,
        )
        self.n_queries += 1
        self.n_candidates += len(cands)
        if not cands:
            return LoopClosureInfo(False, kf_slot, -1, None)
        raise NotImplementedError(
            f"keyframe {kf_slot} has loop candidates {cands}; their verification (kfmatch, pnp_ransac) "
            "and the map correction (posegraph, sim3) are not ported yet (ROADMAP.md, Queue 1 "
            "items 2 and 5)"
        )
