"""Where the port's mapped markers lose accuracy: the marker steps of both
packages on one map, on the CPU.

    JAX_PLATFORMS=cpu python -m tools.port.marker_witness [--slam] [--out FILE]

On `data/torch_port/markers_map.slm` (the JAX package's pass 1 over the 60
frames of chip_smoke's phase 8), read by each package:

- `mapped`: the markers' distance from the scene's as the map holds them
  (chip_smoke's `marker_errors`: the map carried into the world by the
  pass's own camera poses);
- `update`: every marker pose cleared, then `update_marker_poses` (one IPPE
  view, chosen by its reprojection over all the marker's views);
- `local_ba`: from there, one local BA with marker vertices around each
  keyframe in turn, as keyframe insertion runs it;

each with the largest difference between the two packages' marker poses.
`--slam` first maps the 60 frames with the port on the CPU (chip_smoke phase
8 (a) from rendered frames through `UcoSlam(device="cpu")`, the card's
counterpart) and puts the port's map through the same three rows.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from chip_smoke import marker_errors, marker_paths, metric_summary
from ucoslam_tpu.geometry.camera import CameraParams as RefCamera
from ucoslam_tpu.io.serialize import load_map as ref_load_map
from ucoslam_tpu.optim.ba import local_bundle_adjustment as ref_local_ba
from ucoslam_tpu.slam.markermap import update_marker_poses as ref_update
from ucoslam_tpu_torch.api import UcoSlam
from ucoslam_tpu_torch.config import Params
from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.io.serialize import load_map, load_map_meta
from ucoslam_tpu_torch.io.synthetic import SyntheticSequence
from ucoslam_tpu_torch.optim.ba import local_bundle_adjustment
from ucoslam_tpu_torch.slam.markermap import update_marker_poses


def _ref_markers(m):
    st = m.state
    return tuple(np.asarray(getattr(st, k)) for k in ("mk_id", "mk_pose", "mk_pose_valid"))


def _row(port, ref, poses, seq):
    """Both packages' marker errors and the largest pose difference."""
    (pid, ppose, pvalid), (rid, rpose, rvalid) = port.h("mk_id", "mk_pose", "mk_pose_valid"), _ref_markers(ref)
    truth = seq.marker_poses
    both = pvalid & rvalid
    return dict(port=marker_errors(pid, ppose, pvalid, poses, seq, truth),
                jax=marker_errors(rid, rpose, rvalid, poses, seq, truth),
                same_valid=bool((pvalid == rvalid).all()),
                pose_max_abs_diff=float(np.abs(ppose[both] - rpose[both]).max()) if both.any() else None)


def witness(map_path: str, poses: dict, seq, cam, ref_cam, params) -> dict:
    """The three rows of the module docstring on one checkpoint."""
    port, ref = load_map(map_path, "cpu"), ref_load_map(map_path)
    out = dict(mapped=_row(port, ref, poses, seq))
    slots = np.nonzero(port.h("mk_active"))[0]
    port.set_markers(slots, mk_pose_valid=np.zeros(len(slots), bool))
    ref.state = ref.state._replace(mk_pose_valid=ref.state.mk_pose_valid.at[slots].set(False))
    n_port, n_ref = update_marker_poses(port, cam, params), ref_update(ref, ref_cam, ref.params)
    out["update"] = dict(n_set=[n_port, n_ref], **_row(port, ref, poses, seq))
    t0 = time.perf_counter()
    for kf in port.keyframes.active_slots():
        local_bundle_adjustment(port, cam, int(kf))
        ref_local_ba(ref, ref_cam, int(kf))
    out["local_ba"] = dict(seconds=time.perf_counter() - t0, **_row(port, ref, poses, seq))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--slam", action="store_true", help="also map the 60 frames with the port on the CPU")
    ap.add_argument("--out", default=None, help="write the summary as JSON here")
    args = ap.parse_args(argv)
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    jax_map, jax_json = marker_paths(60)
    with open(jax_json) as fh:
        ref_run = json.load(fh)
    params = Params.from_dict(load_map_meta(jax_map)["params"])
    c = ref_run["camera"]
    cam = CameraParams.create(c["fx"], c["fy"], c["cx"], c["cy"], width=c["width"], height=c["height"])
    ref_cam = RefCamera.create(c["fx"], c["fy"], c["cx"], c["cy"], width=c["width"], height=c["height"])
    seq = SyntheticSequence(cam=cam, **ref_run["sequence"])
    poses = {int(k): np.asarray(v, np.float64) for k, v in ref_run["pass1"]["poses"].items()}
    out = dict(jax_map=witness(jax_map, poses, seq, cam, ref_cam, params))
    if args.slam:
        t0 = time.perf_counter()
        slam = UcoSlam(device="cpu")
        slam.setParams(None, params, cam)
        fwd = {}
        for i in range(seq.n_frames):
            pose = slam.process(seq.render(i), fseq=i)
            if pose is not None:
                fwd[i] = pose
        out["port_pass1_cpu"] = dict(seconds=time.perf_counter() - t0, tracked=len(fwd), **metric_summary(fwd, seq),
                                     keyframes=slam.map.n_keyframes, signature=slam.getSignatureStr())
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "port_markers.slm")
            slam.saveToFile(path)
            out["port_map"] = witness(path, fwd, seq, cam, ref_cam, params)
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")


if __name__ == "__main__":
    main()
