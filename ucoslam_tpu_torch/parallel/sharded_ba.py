"""Schur-complement bundle adjustment sharded over a mesh of ranks.

Port of `ucoslam_tpu/parallel/sharded_ba.py`: map-point blocks and their
observations shard over the ranks of a `Mesh`; keyframe poses and marker
vertices are replicated. Each rank computes the residuals and Jacobians of
its observations, marginalizes its own 3x3 point blocks, assembles its part
of the reduced camera system, and all-reduces it (one packed all_reduce a
LM step, plus the acceptance cost, plus one (V, 6) vector in each PCG
iteration on the CG route); the replicated marker and planar edges are added
after the reduction, every rank solves the same reduced system, and
back-substitutes its own points. The LM loop is `optim.ba._staged_lm`
itself with the mesh's `psum`, so the sharded path cannot drift from the
single-device solver.

`shard_ba_problem` regroups a problem so that every observation of a point
lives on that point's rank, as the reference's does (the same bucketing and
order). `sharded_ba_solve` runs on every rank of the mesh with the same
sharded problem (each rank takes its own block) and returns the whole
result on every rank: one more collective assembles the point and
observation outputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.optim.ba import BAProblem, BAResult, _build_cam_obs, _bucket, _staged_lm


def shard_ba_problem(problem: BAProblem, n_shards: int) -> BAProblem:
    """Regroup a BAProblem so points (and their observations) block-shard
    evenly: points keep their order, padded to a multiple of n_shards;
    observations are reordered by point shard and padded so each shard holds
    exactly its points' observations (pad rows are invalid and point at the
    shard's first point). cam_obs becomes the n_shards per-shard local
    tables stacked on dim 0. Marker and planar fields pass through."""
    dev = problem.pt_pos.device
    P_ = problem.pt_pos.shape[0]
    pt_per = -(-P_ // n_shards)
    P_pad = pt_per * n_shards
    obs_pt = problem.obs_pt.cpu().numpy()
    obs_shard = (np.arange(P_pad) // pt_per)[obs_pt]
    counts = np.bincount(obs_shard, minlength=n_shards)
    o_per = _bucket(int(counts.max()) if len(counts) else 1, 128)
    by_shard = np.argsort(obs_shard, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)])
    order = np.zeros(n_shards * o_per, np.int64)  # pad rows reuse observation 0
    real = np.zeros(n_shards * o_per, bool)
    for s in range(n_shards):
        ix = by_shard[starts[s]:starts[s + 1]]
        order[s * o_per:s * o_per + len(ix)] = ix
        real[s * o_per:s * o_per + len(ix)] = True
    row_shard = np.repeat(np.arange(n_shards), o_per)
    new_obs_pt = np.where(real, obs_pt[order], row_shard * pt_per)

    # the per-point observation table in the new order
    MO = problem.pt_obs.shape[1]
    pt_obs = np.full((P_pad, MO), -1, np.int64)
    rows = np.nonzero(real)[0]
    pts = new_obs_pt[rows]
    o2 = np.argsort(pts, kind="stable")
    rows_s, pts_s = rows[o2], pts[o2]
    if len(pts_s):
        first = np.concatenate([[True], pts_s[1:] != pts_s[:-1]])
        rank = np.arange(len(pts_s)) - np.maximum.accumulate(np.where(first, np.arange(len(pts_s)), 0))
        keep = rank < MO
        pt_obs[pts_s[keep], rank[keep]] = rows_s[keep]

    K = problem.cam_pose.shape[0]
    new_obs_cam = problem.obs_cam.cpu().numpy()[order]
    new_obs_valid = problem.obs_valid.cpu().numpy()[order] & real
    tables = []
    for s in range(n_shards):
        loc = new_obs_cam[s * o_per:(s + 1) * o_per].copy()
        loc[~new_obs_valid[s * o_per:(s + 1) * o_per]] = -1  # pad rows left out
        tables.append(_build_cam_obs(loc, K))
    co = max(t.shape[1] for t in tables)
    cam_obs = np.full((n_shards * K, co), -1, np.int64)
    for s, t in enumerate(tables):
        cam_obs[s * K:(s + 1) * K, :t.shape[1]] = t

    order_t = torch.from_numpy(order).to(dev)

    def pad_pts(x, fill=0):
        pad = x.new_full((P_pad - P_,) + x.shape[1:], fill)
        return torch.cat([x, pad])

    def t(a):
        return torch.from_numpy(a).to(dev)

    return dataclasses.replace(
        problem,
        pt_pos=pad_pts(problem.pt_pos), pt_valid=pad_pts(problem.pt_valid, False),
        obs_cam=t(new_obs_cam), obs_pt=t(new_obs_pt.astype(np.int64)),
        obs_uv=problem.obs_uv[order_t], obs_sigma2=problem.obs_sigma2[order_t],
        obs_depth=problem.obs_depth[order_t], obs_valid=t(new_obs_valid),
        pt_obs=t(pt_obs), cam_obs=t(cam_obs),
    )


def local_shard(problem: BAProblem, n: int, rank: int) -> BAProblem:
    """Rank `rank`'s block of a shard_ba_problem problem, with its
    observation and point indices made local."""
    O, P_ = problem.obs_cam.shape[0], problem.pt_pos.shape[0]
    o_per, pt_per = O // n, P_ // n
    K = problem.cam_pose.shape[0]
    ob, pb = slice(rank * o_per, (rank + 1) * o_per), slice(rank * pt_per, (rank + 1) * pt_per)
    pt_obs = problem.pt_obs[pb]
    return dataclasses.replace(
        problem,
        pt_pos=problem.pt_pos[pb], pt_valid=problem.pt_valid[pb],
        obs_cam=problem.obs_cam[ob], obs_pt=problem.obs_pt[ob] - rank * pt_per,
        obs_uv=problem.obs_uv[ob], obs_sigma2=problem.obs_sigma2[ob], obs_depth=problem.obs_depth[ob],
        obs_valid=problem.obs_valid[ob],
        pt_obs=torch.where(pt_obs >= 0, pt_obs - rank * o_per, -1),
        cam_obs=problem.cam_obs[rank * K:(rank + 1) * K],
    )


def sharded_ba_solve(problem: BAProblem, cam: CameraParams, mesh, iters: int = 20, stages: int = 2,
                     solver: str = "auto", cg_iters: int = 32) -> BAResult:
    """The staged-LM Schur BA over `mesh`, called by every rank with the same
    `problem` from shard_ba_problem(mesh.size) (on any device: each rank
    moves its block to mesh.device). solver: "dense", "cg", or "auto" (CG
    from 512 vertex slots, as the reference's sharded solver). Returns the
    whole result on every rank; obs_chi2 / obs_bad are in the sharded
    observation order (pair them with the sharded problem, as
    apply_ba_result does)."""
    n = mesh.size
    if problem.obs_cam.shape[0] % n or problem.pt_pos.shape[0] % n or problem.cam_obs.shape[0] != n * \
            problem.cam_pose.shape[0]:
        raise ValueError(f"the problem is not sharded for {n} ranks (shard_ba_problem)")
    V = problem.cam_pose.shape[0] + (0 if problem.mk_pose is None else problem.mk_pose.shape[0])
    if solver == "auto":
        solver = "cg" if V >= 512 else "dense"
    if solver not in ("dense", "cg"):
        raise ValueError(f"unknown solver {solver!r}")
    local = _to(local_shard(problem, n, mesh.rank), mesh.device)
    cam_pose, mk_pose, pt_pos, costs, c2, bad = _staged_lm(local, cam, iters, stages, solver == "cg", cg_iters,
                                                           psum=mesh.psum)
    pt_pos, c2, bad = mesh.gather_rows(pt_pos, c2, bad)
    return BAResult(cam_pose=cam_pose, pt_pos=pt_pos, obs_chi2=c2, obs_bad=bad, cost_history=costs, mk_pose=mk_pose)


def _to(problem, device):
    """problem with its tensors on `device`."""
    return dataclasses.replace(problem, **{f.name: getattr(problem, f.name).to(device)
                                           for f in dataclasses.fields(problem)
                                           if isinstance(getattr(problem, f.name), torch.Tensor)})
