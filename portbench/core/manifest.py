"""The manifest and the files it names, found by name.

`BENCHMARK.json` at the checkout's root lists the cells. A cell names a
configuration (`portbench/configs/<config>.json`) and a traffic mix
(`portbench/traffic/<traffic>.json`); its correctness limits are
`portbench/limits/<cell>.json`; each per-layer metric is read by
`portbench/metrics/<metric>.py`; a scene renderer is
`portbench/scenes/<renderer>.py`; a traffic mix's generator is the module
`portbench/core/<generator>.py`. Nothing here lists those files: a later
change adds a cell, a configuration, a traffic mix or a metric by adding its
files and its manifest entry.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PORTBENCH)

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(man: dict, workload: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(os.path.join(PORTBENCH, "configs", f"{name}.json"))


def traffic(name: str) -> dict:
    return load_json(os.path.join(PORTBENCH, "traffic", f"{name}.json"))


def limits(workload: str) -> dict:
    return load_json(os.path.join(PORTBENCH, "limits", f"{workload}.json"))


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GENERATOR_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")


def generator(name: str):
    """The module `portbench.core.<name>`, whose `run(ctx)` runs a cell of
    a traffic mix that names it."""
    if not GENERATOR_RE.match(name):
        raise ValueError(f"generator {name!r} is not a module name")
    return importlib.import_module(f"portbench.core.{name}")


def scene_module(renderer: str):
    return load_module(os.path.join(PORTBENCH, "scenes", f"{renderer}.py"), f"portbench_scene_{renderer}")


def metric_reader(name: str):
    """The `read(trace) -> float | None` of `portbench/metrics/<name>.py`."""
    mod = load_module(os.path.join(PORTBENCH, "metrics", f"{name}.py"), "portbench_metric_" + name.replace(".", "_"))
    return mod.read


def metrics_of(man: dict, section: str, workload: str) -> list[dict]:
    """The metrics of `section` that the cell reports: those without a
    `workloads` key, and those that list it."""
    return [m for m in man[section] if "workloads" not in m or workload in m["workloads"]]


def check_names(man: dict) -> list[str]:
    """Faults of the manifest's names and units against the manifest format's
    character sets (an empty list when it is sound)."""
    bad = []
    names = [m["name"] for s in ("end_to_end", "per_layer") for m in man[s]]
    names += [c["name"] for c in man["configs"]] + [w["name"] for w in man["workloads"]]
    names += [w["config"] for w in man["workloads"]] + [w["traffic"] for w in man["workloads"]]
    names += [k for c in man["configs"] for k in c["reduced"]]
    bad += [f"name {n!r}" for n in names if not NAME_RE.match(n)]
    bad += [f"unit {m['unit']!r}" for s in ("end_to_end", "per_layer") for m in man[s] if not UNIT_RE.match(m["unit"])]
    for kind in ("end_to_end", "per_layer", "configs", "workloads"):
        seen = [m["name"] for m in man[kind]]
        bad += [f"duplicate {kind} name {n!r}" for n in set(seen) if seen.count(n) > 1]
    return bad
