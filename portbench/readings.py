"""Read a cell's compared numbers over several seeds in one process, with
the program as it is or with a control or planted fault switched on
(`portbench/core/controls.py`): the readings each limit in
`portbench/limits/<cell>.json` is set from. Not part of a benchmark run.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 --seconds 30 \
        [--control tf32] [--out FILE]

Prints one JSON line a seed: the readings, the end-to-end numbers, the
set-up time, the device and what the run counted.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import run  # noqa: E402
from portbench.core import manifest  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = manifest.cell(manifest.manifest(ROOT), args.workload)
    if not run.cards_for(cell):
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = run.execute(run.context(cell, seed, args.seconds, False, args.control))
        row = dict(workload=cell["name"], seed=seed, control=args.control, correct=out["correct"],
                   readings=out["readings"], end_to_end=out["end_to_end"], setup_s=out["t_open"] - t0,
                   attempted=out["attempted"], failed=out["failed"], info=out.get("info", {}),
                   memory_peak_bytes=out.get("memory_peak_bytes"), card=card, cores=len(os.sched_getaffinity(0)))
        line = json.dumps(row, default=float)
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
