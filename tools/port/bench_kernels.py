"""Time kernels B1 and B2 of one tree of the port on one CUDA device.

    python3 tools/port/bench_kernels.py [--root DIR] [--variants] [--out FILE]

`--root` is the repository root whose `ucoslam_tpu_torch` is timed (default:
this one). Pointing it at an unpacked older commit compares two designs of
the kernels inside one call on one card: run old, new, new, old. The inputs
and the timer are this repository's (`chip_smoke.py`): B1 at P=16384 x
N=2048 with 90% of the rows live and at the slice's live share; B2 at
B=2112, mono and with depth, at (iters, rounds) = (10, 4) and (10, 2).
Each result is the median of CUDA-event timings of single launches.
`--variants` also times the launches that `kernel_builds.py` builds with
-DUCOSLAM_VARIANTS (B1: fixed lanes a point; B2: threads a block x blocks a
cluster), and records ptxas's registers and spills of each; it needs
`--root` to be this repository.

Prints one JSON object, and writes it to `--out` when given.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CAM = (500.0, 500.0, 320.0, 240.0)
B2_ARGS = ("pose_init", "pts3d", "uv", "sigma2", "valid")


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("bench_chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_kernels: no CUDA device")
    root = os.path.abspath(args.root)
    if args.variants and root != REPO:
        raise SystemExit("bench_kernels: --variants times this repository's kernels only")
    sys.path.insert(0, root)
    from ucoslam_tpu_torch.ops.cuda import lm_kernel, match_kernel  # noqa: E402
    from ucoslam_tpu_torch.slam.system import disable_tf32  # noqa: E402

    imported_root = os.path.abspath(lm_kernel.__file__)
    for _ in range(4):  # <root>/ucoslam_tpu_torch/ops/cuda/lm_kernel.py
        imported_root = os.path.dirname(imported_root)
    if imported_root != root:
        raise SystemExit(f"bench_kernels: ucoslam_tpu_torch was not imported from {root}")
    smoke = _load_chip_smoke()
    disable_tf32()
    out = {
        "root": root,
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip(),
        "B1": {}, "B2": {},
    }
    b1_launches = {"default": match_kernel.project_match}
    b2_launches = {"default": lm_kernel.motion_only_lm_fused}
    if args.variants:
        import kernel_builds

        mk, lm = kernel_builds.build("match_kernel", "UCOSLAM_VARIANTS"), kernel_builds.build(
            "lm_kernel", "UCOSLAM_VARIANTS")
        for g in kernel_builds.MATCH_GROUPS:
            b1_launches[str(g)] = lambda *a, g=g: kernel_builds.match_variant(mk, a, g)
        for v in kernel_builds.LM_VARIANTS:
            b2_launches[f"{v[1]}x{v[0]}"] = lambda *a, v=v, **kw: kernel_builds.lm_variant(lm, v, *a, **kw)
        out["ptxas"] = {"match_kernel": mk.ptxas, "lm_kernel": lm.ptxas}

    b1_cases = {"90% live": smoke.b1_inputs("cuda"), "slice share": smoke.b1_slice_inputs("cuda")}
    for case, b1_args in b1_cases.items():
        want = match_kernel.project_match_plain(*b1_args)
        for launch, fn in b1_launches.items():
            exact = all(torch.equal(g, w) for g, w in zip(fn(*b1_args), want))
            ms = smoke.median_ms(lambda: fn(*b1_args), args.reps)
            out["B1"][f"{case} group={launch}"] = {"ms": ms, "exact": exact}

    for with_depth in (False, True):
        kw = smoke.b2_inputs("cuda", with_depth=with_depth)
        extra = dict(bf=50.0, has_depth=True) if with_depth else {}
        call = [kw.pop(k) for k in B2_ARGS]
        for iters, rounds in ((10, 4), (10, 2)):
            run_kw = dict(kw, **extra, iters=iters, rounds=rounds)
            pose_p, mask_p = lm_kernel.motion_only_lm_plain(*call, *CAM, **run_kw)
            for launch, fn in b2_launches.items():
                pose_k, mask_k = fn(*call, *CAM, **run_kw)
                err = float((pose_k - pose_p).abs().max())
                ms = smoke.median_ms(lambda: fn(*call, *CAM, **run_kw), args.reps)
                name = f"{'depth' if with_depth else 'mono'} {iters}x{rounds} config={launch}"
                out["B2"][name] = {"ms": ms, "pose_max_abs_err": err, "same_mask": bool(torch.equal(mask_k, mask_p))}
    text = json.dumps(out, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text)


if __name__ == "__main__":
    main()
