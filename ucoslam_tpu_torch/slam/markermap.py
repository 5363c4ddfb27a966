"""Marker-map integration: registration, pose disambiguation, metric scale.

Port of `ucoslam_tpu/slam/markermap.py`:

- `resolve_marker_slots` / `record_marker_observations`: a keyframe's marker
  observations into the map's marker arena;
- `update_marker_poses`: a map pose for each marker that has none yet, from
  the IPPE pose pairs of its observations, accepted when one view is
  unambiguous or enough views agree;
- `estimate_scale_from_pending_markers`: the one-time metric rescale of a
  keypoint-initialized map, from a joint Gauss-Newton fit of a marker's
  pose and apparent side length (`_fit_marker_pose_size`; its Jacobian by
  forward-mode differentiation, as the reference's `jacfwd`);
- `best_pose_from_valid_markers`: a camera pose from the observed markers
  that have a map pose, with the best/second ambiguity test, refined on all
  their corners by the motion-only LM (kernel B2 on the card).

The bookkeeping runs on the host over the map's cached host mirror, as the
reference's does; IPPE, the size fit and the LM run on the map's device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from ucoslam_tpu_torch.config import Params
from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.geometry.se3 import se3_exp
from ucoslam_tpu_torch.mapping.frame import FrameMarkers, fetch_to_host
from ucoslam_tpu_torch.mapping.map import Map
from ucoslam_tpu_torch.markers.ippe import ippe_square_poses, marker_object_points
from ucoslam_tpu_torch.optim.pnp import motion_only_lm


def resolve_marker_slots(world_map: Map, markers: FrameMarkers) -> np.ndarray:
    """Frame marker ids -> map marker slots, allocating new ones.
    -> (Mf,) int32 slots (-1 where no marker)."""
    slots = np.full(len(markers.id), -1, np.int32)
    for i in np.nonzero(markers.valid)[0]:
        mid = int(markers.id[i])
        map_ids, active = world_map.h("mk_id", "mk_active")
        existing = np.nonzero((map_ids == mid) & active)[0]
        if len(existing):
            slots[i] = int(existing[0])
        else:
            slot = world_map.markers.alloc()
            world_map.set_markers([slot], mk_id=[mid], mk_active=[True],
                                  mk_size=[np.float32(world_map.params.aruco_markerSize)])
            slots[i] = slot
    return slots


def record_marker_observations(world_map: Map, kf_slot: int, markers: FrameMarkers, slots: np.ndarray) -> None:
    """Store the keyframe's marker observations into the map arrays."""
    st = world_map.state
    kf_mk_slot, kf_mk_corners = st.kf_mk_slot.clone(), st.kf_mk_corners.clone()
    kf_mk_slot[kf_slot] = torch.from_numpy(np.asarray(slots, np.int32)).to(world_map.device)
    kf_mk_corners[kf_slot] = torch.from_numpy(np.asarray(markers.und_corners, np.float32)).to(world_map.device)
    world_map.state = st.replace(kf_mk_slot=kf_mk_slot, kf_mk_corners=kf_mk_corners)


def _project_np(cam: CameraParams, pts: np.ndarray) -> np.ndarray:
    """CameraParams.project in float32 numpy (the same float32 operations)."""
    pts = np.asarray(pts, np.float32)
    z = pts[:, 2:3]
    inv_z = np.float32(1.0) / np.where(np.abs(z) < 1e-9, np.float32(1e-9), z)
    return np.concatenate([np.float32(cam.fx) * (pts[:, 0:1] * inv_z) + np.float32(cam.cx),
                           np.float32(cam.fy) * (pts[:, 1:2] * inv_z) + np.float32(cam.cy)], -1)


def _reproj_corner_err(g2m: np.ndarray, kf_pose: np.ndarray, corners: np.ndarray, size: float,
                       cam: CameraParams) -> float:
    """RMS pixel error of a marker at g2m seen from kf_pose against corners."""
    obj = marker_object_points(np.float32(size)).numpy()
    T = kf_pose @ g2m  # marker -> camera
    pts = obj @ T[:3, :3].T + T[:3, 3]
    if (pts[:, 2] <= 0.01).any():
        return 1e9
    uv = _project_np(cam, pts)
    return float(np.sqrt(np.mean(np.sum((uv - corners) ** 2, -1))))


def _marker_observations(kf_active, kf_mk_slot, kf_mk_corners, slot: int) -> list[tuple[int, np.ndarray]]:
    """(keyframe slot, undistorted corners) of each active keyframe that
    observes marker `slot`, in keyframe-slot order."""
    obs = []
    for k in np.nonzero(kf_active)[0]:
        sel = np.nonzero(kf_mk_slot[k] == slot)[0]
        if len(sel):
            obs.append((int(k), kf_mk_corners[k, sel[0]]))
    return obs


def _ippe_padded(world_map: Map, corners: list[np.ndarray], size: float, cam: CameraParams, pad: int):
    """IPPE of up to `pad` corner sets (padded with the first) on the map's
    device, fetched in one transfer -> (p1, p2, e1, e2) host arrays."""
    c = np.zeros((pad, 4, 2), np.float32)
    c[: len(corners)] = np.stack(corners)
    c[len(corners):] = c[0]
    dev = world_map.device
    out = ippe_square_poses(torch.from_numpy(c).to(dev), torch.full((pad,), size, dtype=torch.float32, device=dev),
                            cam)
    return fetch_to_host(*out)


def update_marker_poses(world_map: Map, cam: CameraParams, params: Params) -> int:
    """Estimate a map pose for each marker that has none yet: both IPPE
    solutions of every observation give a candidate g2m, scored by corner
    reprojection over all observing keyframes; accepted when one view is
    unambiguous (err_ratio > aruco_minerrratio_valid) or at least
    aruco_minNumFramesRequired views agree within 4 px. -> poses set."""
    mk_active, mk_pose_valid, mk_size = world_map.h("mk_active", "mk_pose_valid", "mk_size")
    pending = np.nonzero(mk_active & ~mk_pose_valid)[0]
    if len(pending) == 0:
        return 0
    kf = world_map.h("kf_active", "kf_mk_slot", "kf_mk_corners")
    kf_pose = world_map.h("kf_pose")
    n_set = 0
    for slot in pending:
        obs = _marker_observations(*kf, int(slot))[:16]
        if not obs:
            continue
        size = float(mk_size[slot])
        p1, p2, e1, e2 = _ippe_padded(world_map, [c for _, c in obs], size, cam, 16)
        ratios = (e2 / np.clip(e1, 1e-9, None))[: len(obs)]
        if not ((ratios > params.aruco_minerrratio_valid).any() or len(obs) >= params.aruco_minNumFramesRequired):
            continue
        best, best_err = None, np.inf
        for i, (k, _) in enumerate(obs):
            for pose_k in (p1[i], p2[i]):
                g2m = np.linalg.inv(kf_pose[k]) @ pose_k
                err = sum(_reproj_corner_err(g2m, kf_pose[kk], cc, size, cam) for kk, cc in obs) / len(obs)
                if err < best_err:
                    best, best_err = g2m, err
        if best is None or best_err > 4.0 or not np.isfinite(best).all():  # px: all views must agree
            continue
        world_map.set_markers([int(slot)], mk_pose=best[None].astype(np.float32), mk_pose_valid=[True])
        n_set += 1
    return n_set


def _size_fit_residual(theta, kf_poses, corners, w, cam: CameraParams, g2m_init, size_init):
    """Corner residuals (..., V * 8) of a marker at exp(theta[:6]) g2m_init
    with side exp(theta[6]) size_init, seen from kf_poses (V, 4, 4)."""
    g2m = se3_exp(theta[..., :6]) @ g2m_init  # (..., 4, 4)
    h = torch.exp(theta[..., 6]) * size_init / 2.0
    z = torch.zeros_like(h)
    obj = torch.stack([torch.stack([-h, h, z], -1), torch.stack([h, h, z], -1),
                       torch.stack([h, -h, z], -1), torch.stack([-h, -h, z], -1)], -2)  # (..., 4, 3)
    T = kf_poses @ g2m[..., None, :, :]  # (..., V, 4, 4)
    pts = obj[..., None, :, :] @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]  # (..., V, 4, 3)
    uv = cam.project(pts)
    r = (uv - corners) * w
    return r.reshape(r.shape[:-3] + (-1,))


def _fit_marker_pose_size(kf_poses, corners, view_valid, cam: CameraParams, g2m_init, size_init, iters: int = 12):
    """Jointly fit a marker's pose and apparent side length to >= 2 views
    (padded to a fixed count; view_valid masks): 12 Gauss-Newton steps on
    [se3 tangent (6), log size], the Jacobian by forward-mode
    differentiation along the 7 directions at once. The fitted size is in
    map units; physical / fitted size is the map's metric correction.
    -> (g2m (4, 4), size (), rms ())."""
    dev = kf_poses.device
    w = view_valid.to(torch.float32)[:, None, None]
    args = (kf_poses, corners, w, cam, g2m_init, size_init)
    eye7 = torch.eye(7, dtype=torch.float32, device=dev)
    theta = torch.zeros(7, dtype=torch.float32, device=dev)
    for _ in range(iters):
        with fwAD.dual_level():
            r, dr = fwAD.unpack_dual(_size_fit_residual(fwAD.make_dual(theta.expand(7, 7).contiguous(), eye7), *args))
        r, J = r[0], dr.T  # (V * 8,), (V * 8, 7)
        theta = theta - torch.linalg.solve(J.T @ J + 1e-6 * eye7, J.T @ r)
    g2m = se3_exp(theta[:6]) @ g2m_init
    size = torch.exp(theta[6]) * size_init
    n = (view_valid.sum() * 8.0).clamp(min=1.0)
    rms = torch.sqrt((_size_fit_residual(theta, *args) ** 2).sum() / n)
    return g2m, size, rms


def estimate_scale_from_pending_markers(world_map: Map, cam: CameraParams, params: Params) -> float | None:
    """Metric-scale correction of a map that is not metric yet, from the
    markers that have no pose: for each one with >= 2 views, the best IPPE
    candidate (metric) is fitted jointly with a free size to the map-scale
    keyframes; physical / fitted size, gated by the views' parallax in map
    units, is one estimate. -> their median, or None."""
    mk_active, mk_pose_valid, mk_size = world_map.h("mk_active", "mk_pose_valid", "mk_size")
    kf = world_map.h("kf_active", "kf_mk_slot", "kf_mk_corners", "kf_pose")
    kf_pose = kf[3]
    ratios = []
    for slot in np.nonzero(mk_active & ~mk_pose_valid)[0]:
        obs = _marker_observations(*kf[:3], int(slot))
        if len(obs) < 2:
            continue
        centers = np.stack([-kf_pose[k][:3, :3].T @ kf_pose[k][:3, 3] for k, _ in obs])
        spread = np.linalg.norm(centers - centers.mean(0), axis=1).max()
        size = float(mk_size[slot])
        PAD = 8
        obs = obs[:PAD]
        p1, p2, _, _ = _ippe_padded(world_map, [c for _, c in obs], size, cam, PAD)
        best, best_self = None, np.inf
        for i, (k, c) in enumerate(obs):
            for pose_k in (p1[i], p2[i]):
                g2m = np.linalg.inv(kf_pose[k]) @ pose_k
                err = _reproj_corner_err(g2m, kf_pose[k], c, size, cam)
                if err < best_self:
                    best, best_self = g2m, err
        if best is None or not np.isfinite(best).all():
            continue
        vposes = np.tile(np.eye(4, dtype=np.float32), (PAD, 1, 1))
        vcorners = np.zeros((PAD, 4, 2), np.float32)
        for i, (k, c) in enumerate(obs):
            vposes[i] = kf_pose[k]
            vcorners[i] = c
        dev = world_map.device
        g2m_f, size_f, rms = _fit_marker_pose_size(
            torch.from_numpy(vposes).to(dev), torch.from_numpy(vcorners).to(dev),
            torch.from_numpy(np.arange(PAD) < len(obs)).to(dev), cam,
            torch.from_numpy(best.astype(np.float32)).to(dev), torch.tensor(size, dtype=torch.float32, device=dev),
        )
        g2m_np, size_f, rms = fetch_to_host(g2m_f, size_f, rms)
        if float(rms) > 3.0 or float(size_f) <= 1e-6 or not np.isfinite(g2m_np).all():
            continue
        # parallax gate in map units: the keyframe centres and the fitted
        # marker position are both at map scale
        mk_dist = float(np.linalg.norm(centers.mean(0) - g2m_np[:3, 3]))
        if spread < 0.03 * max(mk_dist, 1e-6):
            continue
        ratios.append(size / float(size_f))
    if not ratios:
        return None
    return float(np.median(ratios))


def best_pose_from_valid_markers(world_map: Map, markers: FrameMarkers, cam: CameraParams,
                                 min_err_ratio: float = 1.5) -> np.ndarray | None:
    """Camera pose from the observed markers whose map pose is known. Every
    (marker, IPPE solution) gives a candidate, scored by the corner error
    over all those markers; the winner must beat the runner-up (unless they
    agree) by min_err_ratio, and is refined on all their corners (<= 64
    rows) by the motion-only LM. -> pose_f2g (4, 4) float32, or None."""
    mk_ids, mk_pose, mk_pose_valid, mk_size = world_map.h("mk_id", "mk_pose", "mk_pose_valid", "mk_size")
    obs_idx = []
    for i in np.nonzero(markers.valid)[0]:
        sel = np.nonzero((mk_ids == markers.id[i]) & mk_pose_valid)[0]
        if len(sel):
            obs_idx.append((int(i), int(sel[0])))
    if not obs_idx:
        return None
    und = markers.und_corners
    candidates = []
    for i, slot in obs_idx:
        g2m_inv = np.linalg.inv(mk_pose[slot])
        for pose_k in (markers.pose1[i], markers.pose2[i]):
            candidates.append(pose_k @ g2m_inv)
    scores = [
        sum(_reproj_corner_err(mk_pose[slot], T, und[i], float(mk_size[slot]), cam) for i, slot in obs_idx)
        / len(obs_idx)
        for T in candidates
    ]
    order = np.argsort(scores)
    best = order[0]
    if len(order) > 1:
        # the runner-up must be clearly worse, or agree with the winner
        agree = np.linalg.norm(candidates[order[1]] - candidates[best]) < 0.05
        if not agree and scores[order[1]] < min_err_ratio * max(scores[best], 1e-6):
            return None
    if scores[best] > 5.0:
        return None
    PAD = 64  # a fixed row count for any number of markers
    pts3d = np.zeros((PAD, 3), np.float32)
    uv = np.zeros((PAD, 2), np.float32)
    k = 0
    for i, slot in obs_idx:
        if k + 4 > PAD:
            break
        obj = marker_object_points(np.float32(mk_size[slot])).numpy()
        pts3d[k : k + 4] = obj @ mk_pose[slot][:3, :3].T + mk_pose[slot][:3, 3]
        uv[k : k + 4] = und[i]
        k += 4
    dev = world_map.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    res = motion_only_lm(t(candidates[best].astype(np.float32)), t(pts3d), t(uv), torch.ones(PAD, device=dev),
                         t(np.arange(PAD) < k), cam, iters=10, rounds=2)
    pose, n_inliers = fetch_to_host(res.pose_f2g, res.n_inliers)
    if int(n_inliers) >= 4:
        return pose.astype(np.float32)
    return candidates[best].astype(np.float32)
