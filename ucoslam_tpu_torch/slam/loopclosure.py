"""Loop detection and map correction.

Port of `ucoslam_tpu/slam/loopclosure.py`:

- `detect_from_keypoints`: keyframe-database candidates, excluding the
  keyframe's covisible neighbours and the keyframes within 10 frames of it,
  verified in one batch (`matching.kfmatch`: one batched launch of kernel B2
  for their PnP refines) -> the expected pose of the current keyframe;
- `detect_from_markers`: a marker with a map pose seen again at least 15
  frames after any other keyframe saw it -> the expected pose from the
  markers (`best_pose_from_valid_markers`);
- `correct_map`: the essential graph plus the loop edge, a Sim3 pose-graph
  relaxation (scale fixed for stereo/RGB-D), every point moved with its
  reference keyframe, a roll-back if the global reprojection chi2 grows too
  much, then the seam's duplicate points fused (kernel B1, through
  `fuse_duplicates_into_kf`).

The RANSAC rows come from the detector's numpy Generator, seeded with the
reference's PRNG constant.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ucoslam_tpu_torch.config import Params
from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.mapping.frame import Frame
from ucoslam_tpu_torch.mapping.kfdatabase import KeyFrameDataBase
from ucoslam_tpu_torch.mapping.map import Map
from ucoslam_tpu_torch.matching.kfmatch import match_keyframe_points_pnp_batch
from ucoslam_tpu_torch.optim.pnp import draw_rows
from ucoslam_tpu_torch.optim.posegraph import PoseGraphProblem, pose_graph_solve, sim3_to_se3
from ucoslam_tpu_torch.slam.markermap import best_pose_from_valid_markers


@dataclass
class LoopClosureInfo:
    found: bool
    cur_kf: int
    matched_kf: int
    expected_pose: np.ndarray | None  # corrected pose_f2g of cur_kf
    n_matches: int = 0  # geometric support (verified inliers / marker corners)


class LoopDetector:
    def __init__(self, params: Params, cam: CameraParams, kfdb: KeyFrameDataBase):
        self.params = params
        self.cam = cam
        self.kfdb = kfdb
        self.n_queries = 0  # candidate queries made
        self.n_candidates = 0  # candidates the queries returned
        self._rng = np.random.default_rng(0x100B)  # RANSAC rows, in call order

    def _draw(self, valid: np.ndarray, n_hypotheses: int) -> np.ndarray:
        return draw_rows(self._rng, valid, n_hypotheses)

    def detect_from_keypoints(self, world_map: Map, kf_slot: int, frame: Frame, min_fseq_gap: int = 10) -> LoopClosureInfo:
        """BoW candidates -> descriptor matching -> PnP verification."""
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
        cms = match_keyframe_points_pnp_batch(
            world_map, frame, cands, self.cam, self.params, self._draw, min_matches=25, min_inliers=20
        )
        cm, cand = max(zip(cms, cands), key=lambda t: (t[0].ok, t[0].n_inliers))
        if not cm.ok:
            return LoopClosureInfo(False, kf_slot, -1, None)
        return LoopClosureInfo(True, kf_slot, cand, cm.pose_f2g, cm.n_inliers)

    def detect_from_markers(self, world_map: Map, kf_slot: int, frame: Frame, min_gap: int = 15) -> LoopClosureInfo:
        """A marker with a map pose, last seen by another keyframe at least
        min_gap frames ago -> the loop against the latest such keyframe, its
        expected pose from the frame's markers."""
        mk = frame.markers
        if not mk.valid.any():
            return LoopClosureInfo(False, kf_slot, -1, None)
        kf_active, kf_mk_slot, fseqs, mk_ids_map, mk_pose_valid = world_map.h(
            "kf_active", "kf_mk_slot", "kf_fseq", "mk_id", "mk_pose_valid")
        cur_seq = int(fseqs[kf_slot])
        loop_marker, matched_kf = None, -1
        for i in np.nonzero(mk.valid)[0]:
            slot = np.nonzero((mk_ids_map == int(mk.id[i])) & mk_pose_valid)[0]
            if not len(slot):
                continue
            observers = [int(k) for k in np.nonzero(kf_active)[0] if (kf_mk_slot[k] == slot[0]).any() and k != kf_slot]
            if not observers:
                continue
            if cur_seq - max(int(fseqs[k]) for k in observers) >= min_gap:
                loop_marker = int(slot[0])
                matched_kf = max(observers, key=lambda k: int(fseqs[k]))
        if loop_marker is None:
            return LoopClosureInfo(False, kf_slot, -1, None)
        pose = best_pose_from_valid_markers(world_map, mk, self.cam)
        if pose is None:
            return LoopClosureInfo(False, kf_slot, -1, None)
        # geometric support: 4 corner correspondences per observed marker
        return LoopClosureInfo(True, kf_slot, matched_kf, pose, 4 * int(mk.valid.sum()))

    def correct_map(self, world_map: Map, info: LoopClosureInfo, fix_scale: bool = False,
                    min_covis_weight: int = 15) -> bool:
        """Sim3 pose-graph relaxation + point correction + chi2 validation,
        then the seam's duplicates fused. -> whether the correction stands."""
        if not info.found:
            return False
        chi_before = world_map.global_reproj_chi2(self.cam)
        kf_slots = world_map.keyframes.active_slots()
        slot_index = {int(s): i for i, s in enumerate(kf_slots)}
        kf_pose_all = world_map.h("kf_pose")
        poses = kf_pose_all[kf_slots]

        edges_i, edges_j, meas, weights = [], [], [], []
        for a, b, w in world_map.essential_graph(min_weight=min_covis_weight):
            a_i, b_i = slot_index[a], slot_index[b]
            edges_i.append(a_i)
            edges_j.append(b_i)
            meas.append(poses[a_i] @ np.linalg.inv(poses[b_i]))
            # covisibility weight; the weight-1 temporal bridges get the floor
            weights.append(float(min_covis_weight) if w <= 1.0 else float(w))
        # the loop edge, weighted by its verified support
        ci, mi = slot_index[info.cur_kf], slot_index[info.matched_kf]
        edges_i.append(ci)
        edges_j.append(mi)
        meas.append(info.expected_pose @ np.linalg.inv(poses[mi]))
        weights.append(float(max(info.n_matches, min_covis_weight)))
        fixed = np.zeros(len(kf_slots), bool)
        fixed[mi] = True  # the old side stays

        dev = world_map.device

        def t(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

        problem = PoseGraphProblem(
            poses=t(poses, torch.float32), fixed=t(fixed, torch.bool),
            edge_i=t(np.asarray(edges_i), torch.int64), edge_j=t(np.asarray(edges_j), torch.int64),
            edge_meas=t(np.stack(meas).astype(np.float32), torch.float32),
            edge_weight=t(np.asarray(weights, np.float32), torch.float32),
            edge_valid=torch.ones(len(meas), dtype=torch.bool, device=dev),
        )
        new_poses = sim3_to_se3(pose_graph_solve(problem, iters=25, fix_scale=fix_scale)).cpu().numpy()

        # move each point with its reference keyframe (the earliest that
        # observes it): X' = Tnew^-1 Told X
        st = world_map.state
        kf_ids = world_map.h("kf_ids")
        pt_ref_kf = np.full(st.P, -1, np.int32)
        for s in kf_slots[::-1]:
            ids = kf_ids[s]
            pt_ref_kf[ids[ids >= 0]] = s
        corr_all = np.einsum("kij,kjl->kil", np.linalg.inv(new_poses), poses)
        idx_of_slot = np.zeros(st.K, np.int32)
        idx_of_slot[kf_slots] = np.arange(len(kf_slots))
        has_ref = pt_ref_kf >= 0
        ref_idx = idx_of_slot[np.clip(pt_ref_kf, 0, None)]
        pt_pos = world_map.h("pt_pos")
        moved = np.einsum("pij,pj->pi", corr_all[ref_idx, :3, :3], pt_pos) + corr_all[ref_idx, :3, 3]
        pt_pos = np.where(has_ref[:, None], moved, pt_pos)
        new_kf_pose = kf_pose_all.copy()
        new_kf_pose[kf_slots] = new_poses

        old_state = world_map.state
        world_map.state = st.replace(kf_pose=t(new_kf_pose.astype(np.float32), torch.float32),
                                     pt_pos=t(pt_pos.astype(np.float32), torch.float32))
        chi_after = world_map.global_reproj_chi2(self.cam)
        if not np.isfinite(chi_after) or chi_after > max(chi_before * 3.0, 10.0):
            world_map.state = old_state  # validation failed: roll back
            return False

        # seam fusion: the current keyframe, the matched one and the three
        # strongest covisible neighbours of each
        from ucoslam_tpu_torch.slam.mapmanager import fuse_duplicates_into_kf

        covis = world_map.covis_matrix()
        seam = [info.cur_kf, info.matched_kf]
        for anchor in (info.cur_kf, info.matched_kf):
            w = covis[anchor].copy()
            w[anchor] = 0
            seam.extend(int(s) for s in np.argsort(-w)[:3] if w[s] > 0)
        done = set()
        for s in seam:
            if s in done or not world_map.keyframes.active[s]:
                continue
            done.add(s)
            fuse_duplicates_into_kf(world_map, s, self.cam, self.params)
        return True
