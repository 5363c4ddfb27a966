"""Write cv2's predefined ArUco and AprilTag dictionaries as port data.

The card's machine has no cv2, so the codeword tables of every predefined
dictionary of cv2.aruco (the installed version; 5.0.0 wrote the committed module) are
generated here once and committed as a Python module of hex words,
`ucoslam_tpu_torch/markers/predefined.py`, which needs no package-data
entry. Each marker's bits come from `Dictionary.getBitsFromByteList` read
row-major, MSB first, 1 = white cell: the packing of `native/*.h`
(`DICT_ARUCO_MIP_36h12` gives `native/aruco_mip_36h12.h`'s 250 words
exactly). A `DICT_<n>X<n>_50/100/250` table is a prefix of the
`_1000` one, so each family's largest table is stored once, beside every
name's size, bits a side and `maxCorrectionBits` (each size keeps its own:
4X4_250 has 1, 4X4_1000 0), and `DetectorParameters().errorCorrectionRate`.

    python -m tools.port.make_dictionaries [--out PATH]

Imports nothing of either package.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import re

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(REPO, "ucoslam_tpu_torch", "markers", "predefined.py")
WORDS_PER_LINE = 6


def table_key(name: str) -> str:
    """The stored table a cv2 DICT_* name reads: the family of a sized
    ArUco table (DICT_4X4_250 -> 4X4), else the name without DICT_ and with
    the AprilTag / MIP suffix in lower case (DICT_APRILTAG_36H11 ->
    APRILTAG_36h11)."""
    body = name[len("DICT_"):]
    m = re.fullmatch(r"(\dX\d)_\d+", body)
    if m:
        return m.group(1)
    m = re.fullmatch(r"(.*_\d+)([hH])(\d+)", body)
    return f"{m.group(1)}h{m.group(3)}" if m else body


def codewords(dictionary) -> list:
    """Each marker's bits as one integer: row-major, MSB = top-left."""
    import cv2.aruco as aruco

    out = []
    for i in range(dictionary.bytesList.shape[0]):
        bits = aruco.Dictionary.getBitsFromByteList(dictionary.bytesList[i:i + 1], dictionary.markerSize)
        w = 0
        for b in bits.ravel():
            w = (w << 1) | int(b)
        out.append(w)
    return out


def digest(words) -> str:
    """sha256 of the words as little-endian uint64 (the tests recompute it)."""
    return hashlib.sha256(b"".join(int(w).to_bytes(8, "little") for w in words)).hexdigest()


def main(argv=None) -> None:
    import cv2
    import cv2.aruco as aruco

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    names = sorted(n for n in dir(aruco) if n.startswith("DICT_"))
    specs, tables = {}, {}
    for name in names:
        d = aruco.getPredefinedDictionary(getattr(aruco, name))
        words = codewords(d)
        key = table_key(name)
        have = tables.get(key)
        if have is None or len(words) > len(have):
            if have is not None and words[:len(have)] != have:
                raise ValueError(f"{name} does not extend the {key} table")
            tables[key] = words
        elif have[:len(words)] != words:
            raise ValueError(f"{name} is not a prefix of the {key} table")
        specs[name] = (key, len(words), int(d.markerSize), int(d.maxCorrectionBits))
    rate = float(aruco.DetectorParameters().errorCorrectionRate)
    lines = [
        f'"""cv2 {cv2.__version__}\'s predefined ArUco and AprilTag dictionaries as codeword tables.',
        "",
        "Generated by `python -m tools.port.make_dictionaries`; do not edit. Each word",
        "holds a marker's bits row-major, MSB = top-left, 1 = white cell (the packing",
        "of native/*.h). DICTIONARIES maps every cv2 DICT_* name to (table, markers,",
        "bits a side, maxCorrectionBits); a name reads the first `markers` words of",
        "its table. DIGESTS: sha256 of each table's words as little-endian uint64.",
        '"""',
        "",
        f"CV2_VERSION = {cv2.__version__!r}",
        "#: cv2.aruco.DetectorParameters().errorCorrectionRate",
        f"ERROR_CORRECTION_RATE = {rate!r}",
        "",
        "DICTIONARIES = {",
        *(f"    {n!r}: {specs[n]!r}," for n in names),
        "}",
        "",
        "DIGESTS = {",
        *(f"    {k!r}: {digest(w)!r}," for k, w in sorted(tables.items())),
        "}",
        "",
        "TABLES = {",
    ]
    for key, words in sorted(tables.items()):
        width = (max(s[2] for s in specs.values() if s[0] == key) ** 2 + 3) // 4
        rows = [" ".join(f"{w:0{width}x}" for w in words[i:i + WORDS_PER_LINE])
                for i in range(0, len(words), WORDS_PER_LINE)]
        lines.append(f'    {key!r}: """')
        lines.extend(rows)
        lines.append('""",')
    lines.append("}")
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {args.out}: {len(tables)} tables, {len(names)} names, "
          f"{sum(len(w) for w in tables.values())} words")


if __name__ == "__main__":
    main()
