"""Load checkpoints written by the reference (`ucoslam_tpu.io.serialize`).

A checkpoint is a zip holding `meta.json` (magic, params, map signature,
session state under `extra`) and `arrays.npz` (MapState under `state/`, the
arena masks under `arena/`, session arrays under `extra/`). numpy reads it
without JAX. Saving is not ported yet.
"""

from __future__ import annotations

import io
import json
import zipfile

import numpy as np

from ucoslam_tpu_torch.config import Params
from ucoslam_tpu_torch.mapping.map import Map, map_state_from_numpy

MAGIC = 225237123  # the reference map files' magic number


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
