"""The work of one stereo step (`frame_extractor.stereo_depth`: the row match
of every left keypoint against every right keypoint and the subpixel SAD
refinement), from its inputs.

Work is counted from what the inputs ask for, not from any implementation:
every pair of a valid left and a valid right keypoint needs its 256-bit
Hamming distance (8 XOR, 8 population counts, 7 adds); every valid left
keypoint needs its SAD search: 121 bilinear samples of its left patch and
9 x 121 of the right one (BILINEAR_FLOPS each), and 9 x 121 absolute
differences summed (3 flops each). Each input byte is read once and the
depths written once. The least time is the largest of bytes over HBM
bandwidth, the population counts over the SMs' popcount rate, the other
integer operations over their 32-bit integer rate and the float operations
over the float32 peak; the kernels that carry the step out take at least
that long on the device, so least time over their device time is at most 1.
"""

from __future__ import annotations

from portbench.rooflines import peaks

PAIR_INT_OPS = 15  # 8 XOR + 7 adds
PAIR_POPC = 8
PATCH, OFFSETS = 121, 9
#: one bilinear sample: 2 complements, 4 weight products, 4 multiplies and 3 adds
BILINEAR_FLOPS = 13
#: one SAD term: a subtraction, its absolute value, the add
SAD_FLOPS = 3


def capture(f, gray_l, gray_r, xy_r, desc_r, octave_r, valid_r, *args):
    """What a call's count needs: its inputs' sizes and valid counts, kept
    on the device (no host wait inside the traced window)."""
    nbytes = sum(t.numel() * t.element_size() for t in (f.xy, f.octave, f.desc, f.valid, gray_l, gray_r, xy_r,
                                                         desc_r, octave_r, valid_r))
    return {"valid_l": f.valid.sum(), "valid_r": valid_r.sum(), "n": f.valid.numel(), "bytes": nbytes}


def work(rec: dict) -> dict:
    """-> {"bytes", "int_ops", "popc", "flops", "live_pairs"} of one call."""
    n_l, n_r = int(rec["valid_l"]), int(rec["valid_r"])
    live = n_l * n_r
    per_kp = (PATCH + OFFSETS * PATCH) * BILINEAR_FLOPS + OFFSETS * PATCH * SAD_FLOPS
    return {"bytes": rec["bytes"] + 4 * rec["n"], "int_ops": PAIR_INT_OPS * live, "popc": PAIR_POPC * live,
            "flops": per_kp * n_l, "live_pairs": live}


def least_seconds(w: dict) -> tuple[float, str]:
    """-> (least time, the bound that sets it)."""
    bounds = {"bytes": w["bytes"] / peaks.HBM_BYTES_PER_S, "popcount": w["popc"] / peaks.POPC_PER_S,
              "int32": w["int_ops"] / peaks.INT32_OPS_PER_S, "float32": w["flops"] / peaks.FP32_FLOPS}
    basis = max(bounds, key=bounds.get)
    return bounds[basis], basis
