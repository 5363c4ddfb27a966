"""ArUco dictionary codewords and marker bitmaps (numpy).

Port of `ucoslam_tpu/markers/dictionary.py`, widened to every dictionary the
reference's detector resolves. `ARUCO_MIP_36h12` and `ARUCO_MIP_16h3` read
the headers the native detector compiles (`native/aruco_mip_*.h`), so
rendered markers and detection agree bit for bit; every other name is one
the reference hands to cv2.aruco (its `_DICT_MAP` aliases and every cv2
`DICT_*` name), read from cv2's own tables, committed as
`markers/predefined.py` (`tools/port/make_dictionaries.py`) since the card's
machine has no cv2. The synthetic renderer draws real, detectable markers
with `marker_texture`.
"""

from __future__ import annotations

import math
import re
from functools import cache
from pathlib import Path
from typing import NamedTuple

import numpy as np

from ucoslam_tpu_torch.markers import predefined

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"

#: the reference's names for cv2 dictionaries (ucoslam_tpu/markers/detector.py
#: `_DICT_MAP`); any other name is looked up among cv2's DICT_* names as is
ALIASES = {
    "ARUCO_MIP_36h12": "DICT_ARUCO_MIP_36h12",
    "ARUCO": "DICT_ARUCO_ORIGINAL",
    "ARUCO_ORIGINAL": "DICT_ARUCO_ORIGINAL",
    "TAG36h11": "DICT_APRILTAG_36h11",
    "4X4_250": "DICT_4X4_250",
    "6X6_250": "DICT_6X6_250",
}


class Dictionary(NamedTuple):
    """A resolved dictionary: where its words are, how many, bits a side,
    and the bit errors the detector corrects in a code."""

    source: str  # "native" (a native/ header) or "cv2" (markers/predefined.py)
    table: str  # the header's file name, or the predefined table's key
    size: int
    bits: int
    max_correction: int


#: dictionaries with native codeword tables; the reference's detector takes
#: them to its native backend, which corrects one bit
NATIVE = {
    "ARUCO_MIP_36h12": Dictionary("native", "aruco_mip_36h12.h", 250, 6, 1),
    "ARUCO_MIP_16h3": Dictionary("native", "aruco_mip_16h3.h", 250, 4, 1),
}


def cv2_dictionary(cv2_name: str) -> Dictionary:
    """A cv2 DICT_* table; it corrects floor(errorCorrectionRate x
    maxCorrectionBits) bits, as cv2's ArucoDetector with default parameters."""
    table, size, bits, max_bits = predefined.DICTIONARIES[cv2_name]
    return Dictionary("cv2", table, size, bits, math.floor(predefined.ERROR_CORRECTION_RATE * max_bits))


#: every name ArucoDetector accepts -> its Dictionary
DICTS = {**{name: cv2_dictionary(name) for name in predefined.DICTIONARIES},
         **{alias: cv2_dictionary(cv2_name) for alias, cv2_name in ALIASES.items()}, **NATIVE}


def resolve(name: str) -> Dictionary:
    """The dictionary a name stands for, as the reference resolves it;
    raises ValueError, naming it, for a name the reference cannot resolve."""
    try:
        return DICTS[name]
    except KeyError:
        raise ValueError(f"unknown marker dictionary {name!r}: neither a native table ({', '.join(NATIVE)}) "
                         f"nor an alias or DICT_* name of cv2 {predefined.CV2_VERSION}") from None


@cache
def _table_words(source: str, table: str) -> np.ndarray:
    if source == "native":
        path = NATIVE_DIR / table
        words = re.findall(r"0x([0-9a-fA-F]+)ULL", path.read_text())
        if not words:
            raise ValueError(f"no codewords found in {path}")
    else:
        words = predefined.TABLES[table].split()
    return np.asarray([int(w, 16) for w in words], np.uint64)


def load_codewords(name: str = "ARUCO_MIP_36h12") -> np.ndarray:
    """(N,) uint64 codewords, row-major bits, MSB = top-left."""
    d = resolve(name)
    return _table_words(d.source, d.table)[:d.size]


def dict_bits(name: str = "ARUCO_MIP_36h12") -> int:
    return resolve(name).bits


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
