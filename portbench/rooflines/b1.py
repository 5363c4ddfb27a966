"""The work of one launch of kernel B1 (`project_match`: projection gates,
256-bit Hamming distance, best two per map point), from its inputs.

Work is counted from what the inputs ask for, not from any implementation:
every pair of a live map point and a live keypoint is gated (radius and
octave: 8 integer or float operations), and every pair inside the gate needs
its distance (8 XOR, 8 population counts, 7 adds) and the best-two update
(2 compares). Each input byte is read once and each output written once.
The least time is the largest of bytes over HBM bandwidth, the population
counts over the SMs' popcount rate and the other operations over their
32-bit integer rate (float32 gate arithmetic counted at the integer rate,
which is the lower).
"""

from __future__ import annotations

from portbench.rooflines import peaks

GATE_OPS = 8
PASS_OPS = 17  # 8 XOR + 7 adds + 2 compares
PASS_POPC = 8


def capture(desc_a, uv_a, oct_a, valid_a, desc_b, uv_b, oct_b, valid_b, radius2):
    """What a launch's count needs, kept on the device (copies only)."""
    return tuple(t.clone() for t in (desc_a, uv_a, oct_a, valid_a, desc_b, uv_b, oct_b, valid_b, radius2))


def work(args) -> dict:
    """-> {"bytes", "int_ops", "popc", "live_pairs", "gated_pairs"} of one launch."""
    desc_a, uv_a, oct_a, valid_a, desc_b, uv_b, oct_b, valid_b, radius2 = args
    du = uv_a[:, None, 0] - uv_b[None, :, 0]
    dv = uv_a[:, None, 1] - uv_b[None, :, 1]
    gate = ((du * du + dv * dv < radius2[None, :]) & ((oct_a[:, None] - oct_b[None, :]).abs() <= 1)
            & valid_a[:, None] & valid_b[None, :])
    gated = int(gate.sum())
    live = int(valid_a.sum()) * int(valid_b.sum())
    P = desc_a.shape[0]
    nbytes = sum(t.numel() * t.element_size() for t in args) + 3 * 4 * P  # three int32 outputs a row
    return {"bytes": nbytes, "int_ops": GATE_OPS * live + PASS_OPS * gated, "popc": PASS_POPC * gated,
            "live_pairs": live, "gated_pairs": gated}


def least_seconds(w: dict) -> tuple[float, str]:
    """-> (least time, the bound that sets it)."""
    bounds = {"bytes": w["bytes"] / peaks.HBM_BYTES_PER_S, "popcount": w["popc"] / peaks.POPC_PER_S,
              "int32": w["int_ops"] / peaks.INT32_OPS_PER_S}
    basis = max(bounds, key=bounds.get)
    return bounds[basis], basis
