"""Map-point -> frame projection matching.

Port of `ucoslam_tpu/matching/projection.py::match_points_to_frame`: project
the candidate points under a pose prior, gate them by frustum, scale band and
viewing angle, predict their octave, then match each against the keypoints
within its radius (kernel B1 on a CUDA tensor, its plain version on a CPU
tensor) and resolve ambiguities.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.mapping.frame import Frame
from ucoslam_tpu_torch.ops.cuda.match_kernel import project_match
from ucoslam_tpu_torch.ops.hamming import INVALID_DIST, filter_ambiguous_train_sized


@dataclass
class ProjectionMatches:
    kpt_idx: torch.Tensor  # (L,) int32 matched keypoint per point, -1 if none
    point_valid: torch.Tensor  # (L,) bool match accepted
    n_visible: torch.Tensor  # () points that projected into the image
    n_matched: torch.Tensor  # () accepted matches


def match_points_to_frame(
    pt_pos: torch.Tensor,  # (L, 3) world positions of candidate points
    pt_desc: torch.Tensor,  # (L, 8) int32 descriptors
    pt_normal: torch.Tensor,  # (L, 3) mean viewing direction (unit or zero)
    pt_min_dist: torch.Tensor,  # (L,)
    pt_max_dist: torch.Tensor,  # (L,)
    pt_valid: torch.Tensor,  # (L,) bool
    frame: Frame,
    cam: CameraParams,
    pose_f2g: torch.Tensor,  # (4, 4) prior pose
    proj_dist_thr: torch.Tensor,  # () float32 search radius in pixels (level 0)
    max_desc_dist: float,
    scale_factor: float = 1.2,
) -> ProjectionMatches:
    R = pose_f2g[:3, :3]
    t = pose_f2g[:3, 3]
    cam_pts = pt_pos @ R.T + t
    uv = cam.project(cam_pts)
    view_ray = pt_pos - (-R.T @ t)
    dist = torch.sqrt((view_ray * view_ray).sum(-1))

    # frustum, scale-band and viewing-angle gates
    in_img = cam.in_image(uv)
    z_ok = cam_pts[:, 2] > 0.05
    band_ok = (dist > 0.8 * pt_min_dist) & (dist < 1.2 * pt_max_dist)
    view_cos = (view_ray * pt_normal).sum(-1) / dist.clamp(min=1e-9)
    has_normal = torch.sqrt((pt_normal * pt_normal).sum(-1)) > 0.5
    angle_ok = ~has_normal | (view_cos > 0.5)
    visible = pt_valid & in_img & z_ok & band_ok & angle_ok

    # predicted octave from distance (Frame::predictScale)
    log_sf = torch.log(torch.tensor(scale_factor, dtype=torch.float32, device=pt_pos.device))
    pred_octave = torch.ceil(
        torch.log(pt_max_dist.clamp(min=1e-9) / dist.clamp(min=1e-9)) / log_sf
    ).clamp(0, 7).to(torch.int32)

    # search radius per keypoint octave
    radius = proj_dist_thr * torch.exp(frame.octave.to(torch.float32) * log_sf)
    kpt_idx, best, second = project_match(
        pt_desc, uv, pred_octave, visible,
        frame.desc, frame.und_xy, frame.octave, frame.valid, radius * radius,
    )
    # a row with no candidate points at keypoint 0, as in the reference
    kpt_idx = kpt_idx.clamp(min=0)
    accept = (best <= max_desc_dist) & (best.to(torch.float32) < 0.9 * second)
    # one point per keypoint: keep the best-scoring claimant
    keep = filter_ambiguous_train_sized(
        kpt_idx, torch.where(accept, best, INVALID_DIST), frame.n
    )
    accept = accept & keep
    return ProjectionMatches(
        kpt_idx=torch.where(accept, kpt_idx, -1),
        point_valid=accept,
        n_visible=visible.sum(),
        n_matched=accept.sum(),
    )
