"""Write the JAX package's run of the `loop_easy` two-pass protocol with a `.fbow` vocabulary.

The protocol and scenario of `tools/port/run_scenario.py --scenario
loop_easy --voc auto`, on the JAX package (any backend; the CPU is enough):
the 240-frame `sweep_back` sequence (2200 points, seed 5) at the harness's
parameters (8192 points, 64 keyframes, 1024 keypoints, maxDescDistance 60,
no markers), the keyframe database loaded with the vocabulary. Pass 1 maps
the rendered frames in SLAM mode, then `globalOptimization`, save; pass 2
reads the checkpoint, `setMode(LOCALIZATION)`, `resetTracker()` and
localizes the frames again. Writes `--out` (default
`data/torch_port/loop_easy_voc_jax.json`): each pass's frames tracked and
ATE (Horn, scale-aligned), pass 1's keyframes and points, and its loop
record (`run_scenario.record_loops`: per keyframe query with candidates,
the candidates, those verified, the loop found and whether its correction
stood; the totals).

    JAX_PLATFORMS=cpu python -m tools.port.loop_reference [--voc PATH]

About 25 minutes on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from tools.port.make_reference_map import ate_of
from tools.port.run_scenario import PARAMS as PORT_PARAMS, SCENARIOS, loop_summary, record_loops
from ucoslam_tpu.api import UcoSlam
from ucoslam_tpu.config import Mode, Params
from ucoslam_tpu.io.fbow import default_vocab_path
from ucoslam_tpu.io.synthetic import SyntheticSequence
from ucoslam_tpu.matching import kfmatch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--voc", default="auto", help="the .fbow vocabulary ('auto': data/vocab.fbow)")
    ap.add_argument("--out", default="data/torch_port/loop_easy_voc_jax.json")
    args = ap.parse_args(argv)
    voc = default_vocab_path() if args.voc == "auto" else args.voc
    seq = SyntheticSequence(**SCENARIOS["loop_easy"])
    params = Params.from_dict(PORT_PARAMS.to_dict())
    images = [seq.render(i) for i in range(seq.n_frames)]

    slam = UcoSlam()
    slam.setParams(None, params, seq.cam, vocabulary=voc)
    loops = record_loops(slam._system.manager.loop_detector, kfmatch)
    t0 = time.perf_counter()
    p1 = {}
    for i, img in enumerate(images):
        pose = slam.process(img, fseq=i)
        if pose is not None:
            p1[i] = np.asarray(pose, np.float32)
    slam.globalOptimization()
    mgr = slam._system.manager
    pass1 = dict(tracked=len(p1), ate=ate_of(p1, seq), loops_closed=mgr.loop_closures,
                 keyframes=slam.map.n_keyframes, points=slam.map.n_points,
                 seconds_cpu=time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "map.slm")
        slam.saveToFile(path)
        loc = UcoSlam()
        loc.readFromFile(path, seq.cam)
    loc.setMode(Mode.LOCALIZATION)
    loc.resetTracker()
    p2 = {}
    for i, img in enumerate(images):
        pose = loc.process(img, fseq=i)
        if pose is not None:
            p2[i] = np.asarray(pose, np.float32)
    out = dict(scenario="loop_easy", sequence=SCENARIOS["loop_easy"], frames=seq.n_frames,
               vocabulary=os.path.basename(voc), loops=loop_summary(loops), pass1=pass1,
               pass2=dict(tracked=len(p2), ate=ate_of(p2, seq)))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "loops"}), json.dumps(
        {k: v for k, v in out["loops"].items() if k != "per_keyframe"}))


if __name__ == "__main__":
    main()
