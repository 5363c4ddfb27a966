"""Checkpoints: save and load maps and session state.

Port of `ucoslam_tpu/io/serialize.py`. A checkpoint is a zip holding
`meta.json` (magic, format version, params, map signature, session state
under `extra`) and `arrays.npz` (MapState under `state/`, the arena masks
under `arena/`, session arrays under `extra/`), the reference's layout:
descriptors are written as uint32, so each package reads the other's files.
"""

from __future__ import annotations

import io
import json
import zipfile

import numpy as np

from ucoslam_tpu_torch.config import Params
from ucoslam_tpu_torch.mapping.map import Map, map_state_from_numpy, map_state_to_numpy

MAGIC = 225237123  # the reference map files' magic number
FORMAT_VERSION = 1


def save_map(world_map: Map, path: str, extra_meta: dict | None = None, extra_arrays: dict | None = None) -> None:
    """`extra_meta` (JSON) and `extra_arrays` (npz under extra/) carry the
    session state beyond the map itself."""
    meta = {
        "magic": MAGIC,
        "version": FORMAT_VERSION,
        "params": world_map.params.to_dict(),
        "signature": world_map.signature(),
    }
    if extra_meta:
        meta["extra"] = extra_meta
    arrays = {f"state/{k}": v for k, v in map_state_to_numpy(world_map.state).items()}
    arrays["arena/points"] = world_map.points.active
    arrays["arena/keyframes"] = world_map.keyframes.active
    arrays["arena/markers"] = world_map.markers.active
    for k, v in (extra_arrays or {}).items():
        arrays[f"extra/{k}"] = np.asarray(v)
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        z.writestr("meta.json", json.dumps(meta))
        z.writestr("arrays.npz", buf.getvalue())


def load_map(path: str, device) -> Map:
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
        if meta.get("magic") != MAGIC:
            raise ValueError(f"not a map file (bad magic): {path}")
        npz = np.load(io.BytesIO(z.read("arrays.npz")))
        state = map_state_from_numpy(
            {k.split("/", 1)[1]: npz[k] for k in npz.files if k.startswith("state/")},
            device,
        )
        m = Map(Params.from_dict(meta["params"]), state)
        m.points.sync_from_mask(npz["arena/points"])
        m.keyframes.sync_from_mask(npz["arena/keyframes"])
        m.markers.sync_from_mask(npz["arena/markers"])
    if m.signature() != meta["signature"]:
        raise ValueError("map signature mismatch after load")
    return m


def load_map_meta(path: str) -> dict:
    with zipfile.ZipFile(path) as z:
        return json.loads(z.read("meta.json"))


def load_map_extra_arrays(path: str) -> dict:
    """Session-state arrays stored under extra/ (empty for map-only files)."""
    with zipfile.ZipFile(path) as z:
        npz = np.load(io.BytesIO(z.read("arrays.npz")))
        return {k.split("/", 1)[1]: npz[k] for k in npz.files if k.startswith("extra/")}
