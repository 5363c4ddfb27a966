"""How often the two-view init succeeds, over RANSAC draws, in both packages.

On the rendered `markers` scene (make_reference_map.MARKER_SEQUENCE, `--frames`
long, MARKER_PARAMS), frame 0 is the reference frame and each frame of
`--targets` the current one; the JAX package's initializer draws with keys
0x1717, 1, 2, ... and the port's with numpy Generators seeded alike. Both
extract their own frames (the port's frontend on the CPU). Prints, per
target frame and pooled, how many of `--draws` draws each package
initialized from, with the two-sided Fisher exact test of the difference.

    JAX_PLATFORMS=cpu python -m tools.port.init_draws --frames 150 --targets 6 7 --draws 24
"""

from __future__ import annotations

import argparse
import json

import jax
import numpy as np
from scipy.stats import fisher_exact

from tools.port.make_reference_map import CAMERA, MARKER_PARAMS, MARKER_SEQUENCE
from ucoslam_tpu.api import build_marker_detector_from_params
from ucoslam_tpu.features.frame_extractor import FrameExtractor as RefExtractor
from ucoslam_tpu.geometry.camera import CameraParams as RefCamera
from ucoslam_tpu.io.synthetic import SyntheticSequence
from ucoslam_tpu.mapping.map import Map as RefMap
from ucoslam_tpu.slam.initializer import MapInitializer as RefInitializer
from ucoslam_tpu_torch.api import build_marker_detector_from_params as port_detector
from ucoslam_tpu_torch.config import Params
from ucoslam_tpu_torch.features.frame_extractor import FrameExtractor
from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.mapping.map import Map
from ucoslam_tpu_torch.slam.initializer import MapInitializer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=150)
    ap.add_argument("--targets", type=int, nargs="+", default=[6, 7])
    ap.add_argument("--draws", type=int, default=24)
    args = ap.parse_args(argv)
    c = CAMERA
    ref_cam = RefCamera.create(c["fx"], c["fy"], c["cx"], c["cy"], width=c["width"], height=c["height"])
    cam = CameraParams.create(c["fx"], c["fy"], c["cx"], c["cy"], width=c["width"], height=c["height"])
    seq = SyntheticSequence(cam=ref_cam, **dict(MARKER_SEQUENCE, n_frames=args.frames))
    params = Params.from_dict(MARKER_PARAMS.to_dict())
    ref_ext = RefExtractor(MARKER_PARAMS, ref_cam, build_marker_detector_from_params(MARKER_PARAMS))
    ext = FrameExtractor(params, cam, "cpu", port_detector(params, "cpu"))
    seeds = [0x1717] + list(range(1, args.draws))
    ref0, port0 = ref_ext.process(seq.render(0), 0), ext.process(seq.render(0), 0)
    pooled = {"jax": 0, "port": 0}
    n = len(seeds)

    def report(**kw):
        p = fisher_exact([[kw["jax"], kw["draws"] - kw["jax"]], [kw["port"], kw["draws"] - kw["port"]]]).pvalue
        print(json.dumps(dict(frames=args.frames, **kw, fisher_p=float(p))), flush=True)

    for t in args.targets:
        ref1, port1 = ref_ext.process(seq.render(t), t), ext.process(seq.render(t), t)
        ok = {"jax": 0, "port": 0}
        for seed in seeds:
            ri = RefInitializer(MARKER_PARAMS, ref_cam)
            ri._key = jax.random.PRNGKey(seed)
            ri.set_reference_frame(ref0)
            ok["jax"] += ri.initialize_two_view(ref1, RefMap(MARKER_PARAMS))[0] == "ok"
            pi = MapInitializer(params, cam)
            pi._rng = np.random.default_rng(seed)
            pi.set_reference_frame(port0)
            ok["port"] += pi.initialize_two_view(port1, Map(params, device="cpu"))[0] == "ok"
        report(target=t, draws=n, **ok)
        pooled = {k: pooled[k] + ok[k] for k in ok}
    report(target="pooled", draws=n * len(args.targets), **pooled)


if __name__ == "__main__":
    main()
