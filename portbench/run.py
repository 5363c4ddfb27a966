"""Run one cell of the benchmark of `ucoslam_tpu_torch` once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell (`BENCHMARK.json`'s `workloads`)
names a configuration and a traffic mix; the mix's `generator`, the module
`portbench/core/<generator>.py`, runs it: set-up (counted in `setup_s`, from
this process's start until the window opens), the measured window of
`--seconds`, then the comparison with the plain references under
`portbench/reference/`, each number beside its limit
(`portbench/limits/<cell>.json`). With `--trace 1` the window runs with
spans and a device trace, and the cell's per-layer metrics
(`portbench/metrics/<name>.py`) are printed instead of the end-to-end ones.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device (and breakdown with --trace 1), then checks: each
compared number with its limit. Without a CUDA card (or fewer than the cell
asks for) the run prints no result and exits with 2; when a process of the
run has loaded JAX or the JAX package, with 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.core import guard, manifest  # noqa: E402


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclass
class Context:
    """What a generator gets: the cell's files, the run's arguments."""

    workload: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    root: str = ROOT
    setup_timeout: float = 600.0
    judge_timeout: float = 240.0
    control: str | None = None  # portbench/core/controls.py; never set by main()
    limits: dict | None = None  # the tests' own, at their size; main() reads the cell's file
    log: object = field(default=log)


def cache_environment(root: str) -> None:
    """Fixed build and kernel-cache directories inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(root, "build", "portbench", sub)
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    os.environ["USE_FLAX"] = "0"


def execute(ctx: Context) -> dict:
    """Run the cell once. -> the generator's readings plus `checks`
    (name -> (value, limit)) and `correct`."""
    out = manifest.generator(ctx.traffic["generator"]).run(ctx)
    limits = ctx.limits if ctx.limits is not None else manifest.limits(ctx.workload)
    checks = {name: (float(out["readings"][name]), float(limit)) for name, limit in limits.items()}
    out["checks"] = checks
    out["correct"] = bool(out["answered"]) and all(math.isfinite(v) and v <= lim for v, lim in checks.values())
    return out


def cards_for(cell: dict) -> bool:
    """Fix the cache directories, and say whether this machine has the CUDA
    cards the cell asks for (on standard error where it has not)."""
    cache_environment(ROOT)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        log(f"no result: the cell needs {cell['chips']} CUDA card(s), this machine has {have}")
    return have >= cell["chips"]


def context(cell: dict, seed: int, seconds: float, trace: bool, control: str | None = None) -> Context:
    """The cell's run, from the files the manifest names."""
    return Context(workload=cell["name"], config=manifest.config(cell["config"]),
                   traffic=manifest.traffic(cell["traffic"]), seed=seed, seconds=seconds, trace=trace,
                   control=control)


def device_info(ctx: Context, out: dict, count: int) -> dict:
    import torch

    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
           "memory_peak_bytes": int(out.get("memory_peak_bytes", 0))}
    if ctx.trace and "trace" in out:
        dev["busy_s"] = out["trace"]["busy_s"]
        dev["window_s"] = out["trace"]["window_s"]
    return dev


def result_line(man: dict, ctx: Context, out: dict, setup_s: float, count: int) -> dict:
    metrics = {}
    if ctx.trace:
        tr = out.get("trace")
        for m in manifest.metrics_of(man, "per_layer", ctx.workload):
            value = manifest.metric_reader(m["name"])(tr) if tr else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in manifest.metrics_of(man, "end_to_end", ctx.workload):
            value = setup_s if m["name"] == "setup_s" else out["end_to_end"].get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
            "device": device_info(ctx, out, count)}
    if ctx.trace and "trace" in out:
        line["breakdown"] = out["trace"]["breakdown"]
    line["info"] = out.get("info", {})
    line["checks"] = {n: {"value": v, "limit": lim} for n, (v, lim) in out["checks"].items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    man = manifest.manifest(ROOT)
    cell = manifest.cell(man, args.workload)
    if not cards_for(cell):
        return 2
    ctx = context(cell, args.seed, args.seconds, bool(args.trace))
    out = execute(ctx)
    setup_s = out["t_open"] - T_START
    found = sorted(set(out.get("forbidden", [])) | set(guard.forbidden_loaded()))
    if found:
        log(f"no result: modules of JAX or the JAX package were loaded: {', '.join(found)}")
        return 3
    line = result_line(man, ctx, out, setup_s, cell["chips"])
    log(f"cell {ctx.workload} seed {ctx.seed}: " + json.dumps(line["info"]))
    for name, (value, limit) in out["checks"].items():
        log(f"check {name} {value!r} limit {limit!r} {'ok' if value <= limit else 'FAILED'}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
