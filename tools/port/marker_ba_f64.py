"""Where the float32 marker-vertex BA of each package lands beside float64.

tests/test_torch_ba.py holds the port's dense `ba_solve` on tests/test_ba.py's
marker maps to the JAX package's: keyframe poses within 1e-4, the cost
history within 1e-4 relative, marker poses within 1e-3. This tool runs both
solvers on those maps (two markers seen by six keyframes, their poses
perturbed; plain, and with `inPlaneMarkers` and a 0.12 rad tilt) four times:

- each package in float32, as the test does;
- each package in float64: the JAX package with `jax_enable_x64` set at
  runtime and the problem's float arrays cast to float64; the port with
  its problem tensors cast to float64 and `torch.float32` read as
  `torch.float64` by `optim/ba.py` and `geometry/se3.py` for the run (their
  explicit float32 constants and casts follow the problem's precision).

The two float64 runs agree to ~1e-8, so they stand for the exact answer of
the same 20 LM steps; the tool prints how far each float32 run lands from
it (marker poses, keyframe poses, max abs), and the final costs, and with
`--out` writes them as JSON.

    JAX_PLATFORMS=cpu python -m tools.port.marker_ba_f64 [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import types

import numpy as np


def solve_all(in_plane: bool, tilt: float) -> dict:
    import jax
    import jax.numpy as jnp
    import torch

    from tests.test_ba import CAM as REF_CAM
    from tests.test_torch_ba import MARKER_CAM, _marker_maps
    from ucoslam_tpu.optim import ba as ref_ba
    from ucoslam_tpu_torch.geometry import se3
    from ucoslam_tpu_torch.optim import ba

    ref_map, port, _, _ = _marker_maps(in_plane, tilt=tilt)
    rp, *_ = ref_ba.build_ba_problem(ref_map, REF_CAM)
    pp, *_ = ba.build_ba_problem(port, MARKER_CAM)
    out = {"jax32": ref_ba.ba_solve(rp, REF_CAM, iters=10, stages=2),
           "port32": ba.ba_solve(pp, MARKER_CAM, iters=10, stages=2)}

    t64 = types.SimpleNamespace(**{k: getattr(torch, k) for k in dir(torch) if not k.startswith("__")})
    t64.float32 = torch.float64
    saved = {m: m.torch for m in (ba, se3)}
    try:
        for m in saved:
            m.torch = t64
        pp64 = type(pp)(**{k: v.to(torch.float64) if isinstance(v, torch.Tensor) and v.is_floating_point() else v
                           for k, v in vars(pp).items()})
        out["port64"] = ba.ba_solve(pp64, MARKER_CAM, iters=10, stages=2)
    finally:
        for m, t in saved.items():
            m.torch = t
    jax.config.update("jax_enable_x64", True)
    try:
        rp64 = rp._replace(**{k: jnp.asarray(np.asarray(v), jnp.float64) for k, v in rp._asdict().items()
                              if v is not None and np.asarray(v).dtype == np.float32})
        out["jax64"] = ref_ba.ba_solve(rp64, REF_CAM, iters=10, stages=2)
    finally:
        jax.config.update("jax_enable_x64", False)
    assert out["port64"].mk_pose.dtype == torch.float64 and out["jax64"].mk_pose.dtype == jnp.float64

    def h(r, name):
        v = getattr(r, name)
        return (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)).astype(np.float64)

    def gap(a, b, name):
        return float(np.abs(h(out[a], name) - h(out[b], name)).max())

    row = {"case": f"in_plane={in_plane} tilt={tilt}"}
    for name in ("mk_pose", "cam_pose"):
        row[name] = {"port32_vs_jax32": gap("port32", "jax32", name), "port64_vs_jax64": gap("port64", "jax64", name),
                     "port32_vs_f64": gap("port32", "jax64", name), "jax32_vs_f64": gap("jax32", "jax64", name)}
    row["final_cost"] = {k: float(h(r, "cost_history")[-1]) for k, r in out.items()}
    return row


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="write the rows as JSON here")
    args = ap.parse_args(argv)
    import torch

    torch.set_num_threads(2)
    rows = [solve_all(False, 0.0), solve_all(True, 0.12)]
    for r in rows:
        print(json.dumps(r), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
