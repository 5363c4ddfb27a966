"""ArUco dictionary codewords and marker bitmaps (numpy).

Port of `ucoslam_tpu/markers/dictionary.py`: the codewords are read from
the same headers the native detector compiles (`native/aruco_mip_*.h`), so
rendered markers and detection agree bit for bit. The synthetic renderer
draws real, detectable markers with `marker_texture`.
"""

from __future__ import annotations

import re
from functools import cache
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"

#: dictionary name -> (header file, bits per side)
DICTS = {
    "ARUCO_MIP_36h12": ("aruco_mip_36h12.h", 6),
    "ARUCO_MIP_16h3": ("aruco_mip_16h3.h", 4),
}


@cache
def load_codewords(name: str = "ARUCO_MIP_36h12") -> np.ndarray:
    """(N,) uint64 codewords, row-major bits, MSB = top-left."""
    path = NATIVE_DIR / DICTS[name][0]
    words = re.findall(r"0x([0-9a-fA-F]+)ULL", path.read_text())
    if not words:
        raise ValueError(f"no codewords found in {path}")
    return np.asarray([int(w, 16) for w in words], np.uint64)


def dict_bits(name: str = "ARUCO_MIP_36h12") -> int:
    return DICTS[name][1]


def marker_bitmap(mid: int, name: str = "ARUCO_MIP_36h12") -> np.ndarray:
    """(n+2, n+2) uint8 0/1 grid: black border + n x n code bits; 1 = white
    cell, row 0 the top of the marker."""
    n = dict_bits(name)
    code = int(load_codewords(name)[mid])
    grid = np.zeros((n + 2, n + 2), np.uint8)
    for r in range(n):
        for c in range(n):
            grid[r + 1, c + 1] = (code >> (n * n - 1 - (r * n + c))) & 1
    return grid


def marker_image(mid: int, px_per_cell: int = 8, quiet_cells: int = 1, name: str = "ARUCO_MIP_36h12") -> np.ndarray:
    """uint8 image of marker `mid`: white quiet zone + black border + bits.
    The black border's extent is the physical marker size."""
    cells = np.pad(marker_bitmap(mid, name), quiet_cells, constant_values=1)
    return np.kron(cells, np.ones((px_per_cell, px_per_cell), np.uint8)) * 255


def marker_texture(mid: int, px_per_cell: int = 8, quiet_cells: int = 1,
                   name: str = "ARUCO_MIP_36h12") -> tuple[np.ndarray, float]:
    """(texture float32 0..255, extent_ratio) for plane rasterization: the
    rendered quad is extent_ratio times the marker's physical size, so the
    quiet zone has a physical extent too."""
    n = dict_bits(name) + 2
    tex = marker_image(mid, px_per_cell, quiet_cells, name).astype(np.float32)
    return tex, (n + 2 * quiet_cells) / n
