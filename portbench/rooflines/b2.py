"""The work of one launch of kernel B2 (`motion_only_lm`: robust motion-only
Levenberg-Marquardt of one camera pose, or a batch of them), from its inputs.

Each valid row is evaluated in every iteration of every round (its residual
decides whether it is an inlier): per row and iteration the projection (25
float operations), residual and chi2 (6), the Huber weight (5), the 2x6
Jacobian (18), the 21 + 6 weighted normal-equation sums (135) and the
candidate's capped cost (33): 222; a row with a stereo depth adds a third
residual and its Jacobian row (81). Float operations at the published
float32 peak; bytes: each input read once, the pose and mask written once.
"""

from __future__ import annotations

from portbench.rooflines import peaks

ROW_OPS, ROW_OPS_DEPTH = 222, 303


def capture(pose_init, pts3d, uv, sigma2, valid, fx, fy, cx, cy, depth=None, bf=None, iters=10, rounds=4,
            has_depth=False):
    return {"valid": valid.clone(), "iters": int(iters), "rounds": int(rounds), "depth": bool(has_depth),
            "problems": pose_init.numel() // 16}


def work(rec: dict) -> dict:
    valid = rec["valid"]
    rows = valid.numel()
    n_valid = int(valid.sum())
    per_row_in = 12 + 8 + 4 + 1 + (4 if rec["depth"] else 0)
    nbytes = rec["problems"] * (64 + 64) + rows * (per_row_in + 1)
    flops = n_valid * rec["iters"] * rec["rounds"] * (ROW_OPS_DEPTH if rec["depth"] else ROW_OPS)
    return {"bytes": nbytes, "flops": flops, "rows": n_valid}


def least_seconds(w: dict) -> tuple[float, str]:
    t_b, t_f = w["bytes"] / peaks.HBM_BYTES_PER_S, w["flops"] / peaks.FP32_FLOPS
    return (t_b, "bytes") if t_b >= t_f else (t_f, "float32")
