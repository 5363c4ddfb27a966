"""Sim3 pose-graph relaxation sharded over a mesh of ranks.

Port of `ucoslam_tpu/parallel/sharded_posegraph.py`, the loop-closure
companion of `sharded_ba.py`: the relative-Sim3 edges shard over the ranks,
the keyframe vertices are replicated. Each rank builds its edges' part of
the (7K, 7K) system, all-reduces the system with its cost, solves the same
damped system, and all-reduces the candidate's cost for the LM
accept/reject: two collectives an iteration. The LM loop is
`optim.posegraph.pose_graph_solve` itself with the mesh's `psum`.
"""

from __future__ import annotations

import dataclasses

import torch

from ucoslam_tpu_torch.optim.posegraph import PoseGraphProblem, pose_graph_solve


def shard_pose_graph_problem(problem: PoseGraphProblem, n_shards: int) -> PoseGraphProblem:
    """The edge arrays padded (identity, invalid edges) to split evenly."""
    E = problem.edge_i.shape[0]
    pad = -(-E // n_shards) * n_shards - E

    def pad_e(x, fill=0):
        return torch.cat([x, x.new_full((pad,) + x.shape[1:], fill)])

    eye = torch.eye(4, dtype=problem.edge_meas.dtype, device=problem.edge_meas.device).expand(pad, 4, 4)
    return dataclasses.replace(
        problem, edge_i=pad_e(problem.edge_i), edge_j=pad_e(problem.edge_j),
        edge_meas=torch.cat([problem.edge_meas, eye]), edge_weight=pad_e(problem.edge_weight),
        edge_valid=pad_e(problem.edge_valid, False),
    )


def sharded_pose_graph_solve(problem: PoseGraphProblem, mesh, iters: int = 20, fix_scale: bool = False):
    """LM on the pose graph over `mesh`, called by every rank with the same
    `problem` from shard_pose_graph_problem(mesh.size) -> the optimized
    (K, 4, 4) Sim3 poses, on every rank."""
    E = problem.edge_i.shape[0]
    if E % mesh.size:
        raise ValueError(f"the problem is not sharded for {mesh.size} ranks (shard_pose_graph_problem)")
    per = E // mesh.size
    rows = slice(mesh.rank * per, (mesh.rank + 1) * per)
    local = dataclasses.replace(
        problem, edge_i=problem.edge_i[rows], edge_j=problem.edge_j[rows], edge_meas=problem.edge_meas[rows],
        edge_weight=problem.edge_weight[rows], edge_valid=problem.edge_valid[rows],
    )
    local = dataclasses.replace(local, **{f.name: getattr(local, f.name).to(mesh.device)
                                          for f in dataclasses.fields(local)})
    return pose_graph_solve(local, iters=iters, fix_scale=fix_scale, psum=mesh.psum)
