"""Kernels F1 and F2: the frontend's detect stage over every pyramid level.

F1 (`fast_cells`) takes the FAST-9/16 scores, the 3x3 suppression, the
border margin and each cell's best `k_per_cell` of every level in one
launch; F2 (`select_keypoints`) takes each level's best `budget` of those,
writes the keypoint rows and gathers their support patches, in one launch.
Both read the levels from one packed buffer, laid out by its
`ops.image.Pyramid` (shapes, offsets), which they take beside it. The CUDA
kernels are `csrc/fast_kernel.cu`, whose note says what bounds them on the
card; they replace no Pallas kernel (the JAX package leaves this stage to
XLA's fusion). `fast_cells_plain` and `select_keypoints_plain` are the same
functions in plain PyTorch, the detector's per-level ops composed over the
levels: the CPU path and the kernels' reference.
"""

from __future__ import annotations

import ctypes
import functools
from types import SimpleNamespace

import torch
import torch.nn.functional as F

from ucoslam_tpu_torch.ops import cuda
from ucoslam_tpu_torch.ops.fast import cell_topk, fast_score_map, grid_topk, nms3x3
from ucoslam_tpu_torch.ops.image import extract_patches
from ucoslam_tpu_torch.utils.timers import timers

#: limits of the kernels (csrc/fast_kernel.cu): levels, the cell's side (F1
#: holds a cell and its halo in shared memory) and a level's candidate slots
#: (F2 ranks them in shared memory); F2's candidate slots a block
MAX_LEVELS, MAX_CELL, MAX_SLOTS, SLOTS_PER_BLOCK = 32, 64, 32768, 32


@functools.lru_cache(maxsize=64)
def _layout(shapes: tuple, cell: int, k_per_cell: int, budgets: tuple = ()) -> SimpleNamespace:
    """Where the candidates and keypoints of levels of these shapes lie: the
    one account of it, which the kernels take and check. k; for each level
    its tiles across (gw) and its first cell (cell_off, n + 1 entries, the
    last all cells); with budgets, each level's candidate slots (its cells'
    candidates, or its budget where that is more), its first keypoint row
    (out_off) and its first F2 block (chunk_off, n + 1 entries)."""
    k = min(k_per_cell, cell * cell)
    gw, cell_off, slots, out_off, chunk_off = [], [0], [], [], [0]
    for lv, (h, w) in enumerate(shapes):
        gw.append(-(-w // cell))
        cell_off.append(cell_off[-1] + -(-h // cell) * gw[-1])
        if budgets:
            slots.append(max((cell_off[-1] - cell_off[-2]) * k, budgets[lv]))
            out_off.append(sum(budgets[:lv]))
            chunk_off.append(chunk_off[-1] + -(-slots[-1] // SLOTS_PER_BLOCK))
    return SimpleNamespace(k=k, gw=tuple(gw), cell_off=tuple(cell_off), slots=tuple(slots),
                           out_off=tuple(out_off), chunk_off=tuple(chunk_off))


def fast_cells_plain(levels, pyr, threshold, cell, k_per_cell, margin):
    """-> (cand_val (C,) float32, cand_idx (C,) int32): each cell's best k of
    every level (FAST over the threshold, 3x3 suppression, nothing within
    `margin` of a border), cells row-major, level after level."""
    k = min(k_per_cell, cell * cell)
    vals, idxs = [], []
    for lv, (h, w) in enumerate(pyr.shapes):
        score = nms3x3(fast_score_map(pyr.level(levels, lv), threshold))
        interior = torch.zeros_like(score, dtype=torch.bool)
        interior[margin : h - margin, margin : w - margin] = True
        v, i = cell_topk(torch.where(interior, score, 0.0), cell, k)
        vals.append(v.reshape(-1))
        idxs.append(i.reshape(-1))
    return torch.cat(vals), torch.cat(idxs).to(torch.int32)


def select_keypoints_plain(levels, pyr, cand_val, cand_idx, cell, k_per_cell, budgets, scales, radius):
    """F1's candidates -> (xy (N, 2) float32 at level 0, response (N,),
    octave (N,) int32, valid (N,), patches (N, 2r+1, 2r+1)): each level's
    best budget of its candidates (zero-padded), N = sum(budgets)."""
    lay = _layout(tuple(pyr.shapes), cell, k_per_cell)
    k, P = lay.k, 2 * radius + 1
    xys, resps, octs, valids, patches = [], [], [], [], []
    for lv, (h, w) in enumerate(pyr.shapes):
        a, b = lay.cell_off[lv] * k, lay.cell_off[lv + 1] * k
        xy, resp, valid = grid_topk(cand_val[a:b].view(-1, k), cand_idx[a:b].view(-1, k).long(), lay.gw[lv],
                                    cell, budgets[lv])
        img = pyr.level(levels, lv)
        if h < P or w < P:
            # levels smaller than one patch yield no valid keypoints
            img = F.pad(img, (0, max(0, P - w), 0, max(0, P - h)))
        patches.append(extract_patches(img, xy, radius))
        xys.append(xy * scales[lv])
        resps.append(resp)
        octs.append(torch.full((budgets[lv],), lv, dtype=torch.int32, device=levels.device))
        valids.append(valid)
    return torch.cat(xys), torch.cat(resps), torch.cat(octs), torch.cat(valids), torch.cat(patches)


def _level_args(levels, pyr, cell, lay) -> tuple:
    """Check the packed levels for a launch -> (n, heights, widths, pixel
    offsets, tiles across, first cells) as the C launchers take them."""
    dev = levels.device
    if dev.type != "cuda":
        raise ValueError(f"the detect kernels run on CPU or CUDA tensors, not {dev}")
    if not 1 <= len(pyr.shapes) <= MAX_LEVELS:
        raise ValueError(f"{len(pyr.shapes)} levels: the kernels take 1 to {MAX_LEVELS}")
    if not 1 <= cell <= MAX_CELL:
        raise ValueError(f"cell {cell}: the kernels take 1 to {MAX_CELL}")
    if any(h < 1 or w < 1 for h, w in pyr.shapes):
        raise ValueError(f"a level is empty: {pyr.shapes}")
    cuda.check_cuda_args(dev, levels=(levels, torch.float32, (pyr.offsets[-1],)))
    n = len(pyr.shapes)
    return (n, _ints([h for h, _ in pyr.shapes]), _ints([w for _, w in pyr.shapes]),
            _ints(pyr.offsets[:n], ctypes.c_longlong), _ints(lay.gw), _ints(lay.cell_off))


def _ints(values, ctype=ctypes.c_int):
    return (ctype * len(values))(*values)


def fast_cells(levels, pyr, threshold, cell, k_per_cell, margin):
    """F1 on the levels' device: the CUDA kernel for a CUDA buffer, the plain
    version for a CPU one. levels: `pyr`'s packed (sum h*w,) float32 levels
    (`ops.image.Pyramid`); threshold: the FAST threshold (any float, per
    call)."""
    if levels.device.type == "cpu":
        return fast_cells_plain(levels, pyr, threshold, cell, k_per_cell, margin)
    lay = _layout(tuple(pyr.shapes), cell, k_per_cell)
    args = _level_args(levels, pyr, cell, lay)
    if margin < 0:
        raise ValueError(f"margin {margin} < 0")
    dev, n_cand = levels.device, lay.cell_off[-1] * lay.k
    cand_val = torch.empty(n_cand, dtype=torch.float32, device=dev)
    cand_idx = torch.empty(n_cand, dtype=torch.int32, device=dev)
    err = _library().fast_cells_launch(
        levels.data_ptr(), *args, cell, lay.k, margin, float(threshold),
        cand_val.data_ptr(), cand_idx.data_ptr(), cuda.stream_handle(dev),
    )
    cuda.check_launch(err, "fast_cells")
    timers.count("F1")
    return cand_val, cand_idx


def select_keypoints(levels, pyr, cand_val, cand_idx, cell, k_per_cell, budgets, scales, radius):
    """F2 on the levels' device: the CUDA kernel for CUDA tensors, the plain
    version for CPU ones. Takes `fast_cells`' outputs of the same levels,
    cell and k; a level's budget may pass its candidates (the rest is zero
    padding), up to MAX_SLOTS."""
    if levels.device.type == "cpu":
        return select_keypoints_plain(levels, pyr, cand_val, cand_idx, cell, k_per_cell, budgets, scales, radius)
    if len(budgets) != len(pyr.shapes) or len(scales) != len(pyr.shapes):
        raise ValueError(f"{len(pyr.shapes)} levels, {len(budgets)} budgets and {len(scales)} scales")
    if any(b < 0 for b in budgets):
        raise ValueError(f"a budget is negative: {budgets}")
    lay = _layout(tuple(pyr.shapes), cell, k_per_cell, tuple(budgets))
    args = _level_args(levels, pyr, cell, lay)
    dev, n_cand = levels.device, lay.cell_off[-1] * lay.k
    cuda.check_cuda_args(dev, cand_val=(cand_val, torch.float32, (n_cand,)),
                         cand_idx=(cand_idx, torch.int32, (n_cand,)))
    for lv, b in enumerate(budgets):
        if lay.slots[lv] > MAX_SLOTS:
            raise ValueError(f"level {lv}: budget {b} and {(lay.cell_off[lv + 1] - lay.cell_off[lv]) * lay.k} "
                             f"candidates; F2 ranks at most {MAX_SLOTS} slots a level")
    if radius < 0:
        raise ValueError(f"radius {radius} < 0")
    n, P = sum(budgets), 2 * radius + 1
    xy = torch.empty((n, 2), dtype=torch.float32, device=dev)
    response = torch.empty(n, dtype=torch.float32, device=dev)
    octave = torch.empty(n, dtype=torch.int32, device=dev)
    valid = torch.empty(n, dtype=torch.bool, device=dev)
    patches = torch.empty((n, P, P), dtype=torch.float32, device=dev)
    err = _library().select_keypoints_launch(
        levels.data_ptr(), *args, cell, lay.k, _ints(budgets), _ints(lay.slots), _ints(lay.out_off),
        _ints(lay.chunk_off), _ints(scales, ctypes.c_float), radius,
        cand_val.data_ptr(), cand_idx.data_ptr(), xy.data_ptr(), response.data_ptr(), octave.data_ptr(),
        valid.data_ptr(), patches.data_ptr(), cuda.stream_handle(dev),
    )
    cuda.check_launch(err, "select_keypoints")
    timers.count("F2")
    return xy, response, octave, valid, patches


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda.load_library("fast_kernel")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ip, lp, fp = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_float)
    lib.fast_cells_launch.argtypes = [p, i, ip, ip, lp, ip, ip, i, i, i, f, p, p, p]
    lib.fast_cells_launch.restype = ctypes.c_int
    lib.select_keypoints_launch.argtypes = [p, i, ip, ip, lp, ip, ip, i, i, ip, ip, ip, ip, fp, i,
                                            p, p, p, p, p, p, p, p]
    lib.select_keypoints_launch.restype = ctypes.c_int
    return lib
