"""Point-major Schur BA sharded over a mesh of ranks: the big-map solver.

Port of `ucoslam_tpu/parallel/sharded_pm.py`, communication-avoiding as the
reference's:

- point rows and every per-point quantity (the (P, MO) observation grid,
  the Hpp marginalization, the back-substitution) shard over the ranks with
  no communication: an observation lives on its point's rank by the
  point-major layout itself;
- the reduced camera system (the packed Hv / Schur diagonal and the
  block-sparse S blocks, NP x 36 floats) is all-reduced once a
  relinearization;
- each LM step all-reduces the packed (V, 12) gradients and the acceptance
  cost: two collectives a step;
- PCG runs on replicated V-sized data: no collective inside it.

The LM / PCG implementation is `optim.schur_pm.pm_staged_lm` itself with
the mesh's `psum`. The reference's own sharded solver does not run (its
shard_map in-spec holds the PMProblem's int field `dropped_obs`, which is no
PartitionSpec): the port's is held to the single-device `pm_staged_lm` of
both packages instead.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.optim.schur_pm import PMProblem, pm_staged_lm


class ShardedPM(NamedTuple):
    """A PMProblem regrouped for `n_shards` ranks: point rows padded so P
    divides evenly; cam_obs and the pair tables rebuilt as per-shard local
    tables stacked on dim 0; the V-indexed arrays replicated."""

    pm: PMProblem
    n_shards: int


def shard_pm_problem(pm: PMProblem, n_shards: int) -> ShardedPM:
    """Regroup a PMProblem for a point-sharded mesh (host numpy, the
    reference's tables)."""
    dev = pm.cam_pose.device
    P_, MO = pm.o_cam.shape
    V = pm.cam_pose.shape[0]
    p_per = -(-P_ // n_shards)
    P_pad = p_per * n_shards

    def pad_rows(x: torch.Tensor, fill=0):
        if P_pad == P_:
            return x
        return torch.cat([x, x.new_full((P_pad - P_,) + x.shape[1:], fill)])

    # per-shard camera -> local flat observation-slot tables
    cam_obs_g = pm.cam_obs.cpu().numpy()
    flat_shard = cam_obs_g // (p_per * MO)
    mine_all = [(cam_obs_g >= 0) & (flat_shard == s) for s in range(n_shards)]
    co_max = max([1] + [int(m.sum(1).max()) for m in mine_all if m.size])
    co_max = 1 << (co_max - 1).bit_length()  # power-of-two bucket
    cam_obs_loc = np.full((n_shards * V, co_max), -1, np.int64)
    for s, mine in enumerate(mine_all):
        for v in range(V):
            ids = cam_obs_g[v][mine[v]] - s * p_per * MO
            cam_obs_loc[s * V + v, :len(ids)] = ids

    # per-shard pair-contribution tables: both slots of a contribution belong
    # to one point, hence one shard; the cross-shard sum is the S all_reduce
    pair_m1, pair_m2 = pm.pair_m1.cpu().numpy(), pm.pair_m2.cpu().numpy()
    NPb, CP = pair_m1.shape
    m_shard = np.where(pair_m1 >= 0, pair_m1 // (p_per * MO), -1)
    pair_m1_loc = np.full((n_shards * NPb, CP), -1, np.int64)
    pair_m2_loc = np.full((n_shards * NPb, CP), -1, np.int64)
    for s in range(n_shards):
        mine = m_shard == s
        off = s * p_per * MO
        pair_m1_loc[s * NPb:(s + 1) * NPb] = np.where(mine, pair_m1 - off, -1)
        pair_m2_loc[s * NPb:(s + 1) * NPb] = np.where(mine, pair_m2 - off, -1)

    def t(a):
        return torch.from_numpy(a).to(dev)

    new_pm = dataclasses.replace(
        pm,
        pt_pos=pad_rows(pm.pt_pos), pt_valid=pad_rows(pm.pt_valid, False),
        o_cam=pad_rows(pm.o_cam, V), o_uv=pad_rows(pm.o_uv), o_sigma2=pad_rows(pm.o_sigma2, 1.0),
        o_depth=pad_rows(pm.o_depth), o_valid=pad_rows(pm.o_valid, False), o_src=pad_rows(pm.o_src, -1),
        cam_obs=t(cam_obs_loc), pair_m1=t(pair_m1_loc), pair_m2=t(pair_m2_loc),
    )
    return ShardedPM(pm=new_pm, n_shards=n_shards)


def local_pm(spm: ShardedPM, rank: int) -> PMProblem:
    """Rank `rank`'s block of a sharded problem."""
    pm, n = spm.pm, spm.n_shards
    p_per = pm.o_cam.shape[0] // n
    V = pm.cam_pose.shape[0]
    NPb = pm.pair_m1.shape[0] // n
    rows = slice(rank * p_per, (rank + 1) * p_per)
    return dataclasses.replace(
        pm,
        pt_pos=pm.pt_pos[rows], pt_valid=pm.pt_valid[rows], o_cam=pm.o_cam[rows], o_uv=pm.o_uv[rows],
        o_sigma2=pm.o_sigma2[rows], o_depth=pm.o_depth[rows], o_valid=pm.o_valid[rows], o_src=pm.o_src[rows],
        cam_obs=pm.cam_obs[rank * V:(rank + 1) * V],
        pair_m1=pm.pair_m1[rank * NPb:(rank + 1) * NPb], pair_m2=pm.pair_m2[rank * NPb:(rank + 1) * NPb],
    )


def sharded_pm_solve(spm: ShardedPM, cam: CameraParams, mesh, iters: int = 20, stages: int = 2,
                     cg_iters: int = 32, relin_every: int = 6):
    """The point-major staged LM over `mesh`, called by every rank with the
    same `spm` (shard_pm_problem(pm, mesh.size)). -> (cam_pose, pt_pos,
    costs, c2, bad) on every rank, pt_pos / c2 / bad in the padded point
    order of spm.pm (rows past the original P are pads)."""
    if spm.n_shards != mesh.size:
        raise ValueError(f"the problem is sharded for {spm.n_shards} ranks, the mesh has {mesh.size}")
    local = local_pm(spm, mesh.rank)
    local = dataclasses.replace(local, **{f.name: getattr(local, f.name).to(mesh.device)
                                          for f in dataclasses.fields(local)
                                          if isinstance(getattr(local, f.name), torch.Tensor)})
    cam_pose, pt_pos, costs, c2, bad = pm_staged_lm(local, cam, iters=iters, stages=stages, cg_iters=cg_iters,
                                                    relin_every=relin_every, psum=mesh.psum)
    pt_pos, c2, bad = mesh.gather_rows(pt_pos, c2, bad)
    return cam_pose, pt_pos, costs, c2, bad
