"""Where the time of kernels B1 and B2 goes, phase by phase, on one CUDA device.

    python3 tools/port/probe_kernels.py [--out FILE]

Builds `ucoslam_tpu_torch/csrc/{match,lm}_kernel.cu` with `-DUCOSLAM_PROBES`
(clock64() stamps at the phase boundaries, summed by thread 0 of block 0)
and `-DUCOSLAM_VARIANTS` (`kernel_builds.py`), runs each kernel on
chip_smoke.py's inputs, and prints the cycles of each phase: B2 per LM step
(every launch in `kernel_builds.LM_VARIANTS`, mono, (iters, rounds) =
(10, 4)), B1 per launch (lanes a point chosen per window; 90% live rows and
the slice's share). Cycles are SM cycles; the SM clock is printed beside
them. The probes cost a few instructions each, so the totals run a little
above the unprobed kernels' times.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
import kernel_builds  # noqa: E402
from ucoslam_tpu_torch.ops import cuda  # noqa: E402

B2_PHASES = ("pass", "warp reduction", "barrier A", "block sum + cluster exchange", "CG(8)",
             "exp + candidate", "barrier B", "round start")
B1_PHASES = ("compaction + staging", "sweep + merge", "wait for the block")
CAM = (500.0, 500.0, 320.0, 240.0)


def build(name: str) -> ctypes.CDLL:
    return kernel_builds.build(name, "UCOSLAM_PROBES", "UCOSLAM_VARIANTS")


def read_probes(lib: ctypes.CDLL, n: int) -> list[int]:
    buf = (ctypes.c_longlong * n)()
    if lib.probe_read(buf) != 0:
        raise RuntimeError("probe_read failed")
    return list(buf)


def probe_b2(lib: ctypes.CDLL) -> dict:
    kw = chip_smoke.b2_inputs("cuda")
    call = [kw.pop(k) for k in ("pose_init", "pts3d", "uv", "sigma2", "valid")]
    iters, rounds = 10, 4
    out = {}
    for threads, cluster in kernel_builds.LM_VARIANTS:
        for _ in range(3):
            kernel_builds.lm_variant(lib, (threads, cluster), *call, *CAM, iters=iters, rounds=rounds)
        torch.cuda.synchronize()
        steps = rounds * (iters + 1)
        cycles = read_probes(lib, 8)
        out[f"{threads}x{cluster}"] = {
            "cycles_per_step": {n: round(c / steps, 1) for n, c in zip(B2_PHASES, cycles)},
            "total_cycles_per_step": round(sum(cycles) / steps, 1),
        }
    return out


def probe_b1(lib: ctypes.CDLL) -> dict:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.project_match_launch.argtypes = [p, p, p, p, i, p, p, p, p, p, i, p, p, p, p]
    out = {}
    for case, args in (("90% live", chip_smoke.b1_inputs("cuda")), ("slice share", chip_smoke.b1_slice_inputs("cuda"))):
        P, N = args[0].shape[0], args[4].shape[0]
        res = [torch.empty(P, dtype=torch.int32, device="cuda") for _ in range(3)]
        a = [t.data_ptr() for t in args]
        for _ in range(3):
            err = lib.project_match_launch(a[0], a[1], a[2], a[3], P, a[4], a[5], a[6], a[7], a[8], N,
                                           *(r.data_ptr() for r in res), torch.cuda.current_stream().cuda_stream)
            cuda.check_launch(err, "project_match (probes)")
        torch.cuda.synchronize()
        cycles = read_probes(lib, 4)[:3]
        out[case] = {"cycles": dict(zip(B1_PHASES, cycles)), "total_cycles": sum(cycles)}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_kernels: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60).stdout.strip()
    result = {"nvidia_smi": smi, "B2": probe_b2(build("lm_kernel")), "B1": probe_b1(build("match_kernel"))}
    text = json.dumps(result, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text)


if __name__ == "__main__":
    main()
