"""Profile the PyTorch port's localization slice on one CUDA device.

Loads `data/torch_port/mono_map.slm`, localizes the reverse sweep of the
60-frame `mono` sequence as chip_smoke.py does, and traces FRAMES frames
after WARMUP frames with torch.profiler (CPU + CUDA). Prints, per step
(extract, track): host wall ms per frame and device busy ms per frame, the
device's idle share, and the top operators by device time (per frame and
per call, so a kernel's time per launch); writes the
summary JSON and a chrome trace under `--out-dir`.

With `--slam`, traces instead one forward SLAM pass over the same 60 frames
(chip_smoke.py's phase 5, after one untraced warm-up pass) and reports the
same per step for `MapManager.new_keyframe` and the local BA inside it:
calls, host wall ms and device busy ms per call, and the device's idle share.

    python3 tools/port/profile_slice.py [--slam] --out-dir build/profile
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import torch
from torch.profiler import ProfilerActivity, profile, record_function

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from ucoslam_tpu_torch import Mode  # noqa: E402
from ucoslam_tpu_torch.api import UcoSlam  # noqa: E402
from ucoslam_tpu_torch.geometry.camera import CameraParams  # noqa: E402
from ucoslam_tpu_torch.io.synthetic import SyntheticSequence  # noqa: E402


STEPS = ("extract", "track")
WARMUP, FRAMES = 5, 10


def _device_busy_ms(events, t0_us, t1_us, steps=STEPS) -> float:
    """Union length of the device activity (kernels, copies) inside [t0, t1]
    (us -> ms). The steps' own annotation ranges on the device timeline are
    not activity and are left out."""
    spans = sorted(
        (max(e.time_range.start, t0_us), min(e.time_range.end, t1_us))
        for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in steps
        and e.time_range.end > t0_us and e.time_range.start < t1_us
    )
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3


def _nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def profile_slam(out_dir: str) -> dict:
    """Trace one SLAM pass; -> per step of new_keyframe: calls, wall and
    device busy ms per call, device idle share."""
    import chip_smoke
    from ucoslam_tpu_torch.config import Params
    from ucoslam_tpu_torch.io.serialize import load_map_meta
    from ucoslam_tpu_torch.optim import ba

    map_path, ref_path = chip_smoke.reference_paths(60)
    _, cam, _, images = chip_smoke.load_scene(ref_path)
    params = Params.from_dict(load_map_meta(map_path)["params"])

    def slam_pass():
        slam = UcoSlam(device="cuda")
        slam.setParams(None, params, cam)
        for i, img in enumerate(images):
            slam.process(img, fseq=i)
        torch.cuda.synchronize()
        return slam

    slam_pass()  # warm-up: kernel builds, allocator, first calls
    steps = ("new_keyframe", "local_ba")
    inner_ba = ba.local_bundle_adjustment

    def traced(fn, label):
        def wrapper(*args, **kwargs):
            with record_function(label):
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
            return out
        return wrapper

    from ucoslam_tpu_torch.slam.mapmanager import MapManager

    inner_kf = MapManager.new_keyframe
    MapManager.new_keyframe = traced(inner_kf, "new_keyframe")
    ba.local_bundle_adjustment = traced(inner_ba, "local_ba")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        slam_pass()
    MapManager.new_keyframe, ba.local_bundle_adjustment = inner_kf, inner_ba
    events = prof.events()
    summary = {"device": torch.cuda.get_device_name(0), "nvidia_smi": _nvidia_smi(), "frames": len(images)}
    for step in steps:
        spans = [(e.time_range.start, e.time_range.end) for e in events
                 if e.name == step and e.device_type == torch.autograd.DeviceType.CPU]
        wall = sum(b - a for a, b in spans) / 1e3
        busy = sum(_device_busy_ms(events, a, b, steps) for a, b in spans)
        summary[step] = {
            "calls": len(spans),
            "wall_ms_per_call": wall / max(len(spans), 1),
            "device_busy_ms_per_call": busy / max(len(spans), 1),
            "device_idle_share": 1.0 - busy / max(wall, 1e-9),
        }
    table = [k for k in prof.key_averages() if k.key not in steps]
    top_cpu = sorted(table, key=lambda k: k.self_cpu_time_total, reverse=True)[:15]
    summary["top_host_ops"] = [
        {"name": k.key, "calls": k.count, "host_ms_total": k.self_cpu_time_total / 1e3} for k in top_cpu
    ]
    device_ops = [k for k in table if k.device_type == torch.autograd.DeviceType.CUDA]
    summary["top_device_ops"] = [
        {"name": k.key, "calls": k.count, "device_ms_total": k.self_device_time_total / 1e3}
        for k in sorted(device_ops, key=lambda k: k.self_device_time_total, reverse=True)[:10]
    ]
    prof.export_chrome_trace(os.path.join(out_dir, "slam_trace.json"))
    return summary


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out-dir", default="build/profile")
    ap.add_argument("--slam", action="store_true", help="trace keyframe insertion in a SLAM pass")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: no CUDA device")
    os.makedirs(args.out_dir, exist_ok=True)
    if args.slam:
        summary = profile_slam(args.out_dir)
        with open(os.path.join(args.out_dir, "profile_slam.json"), "w") as f:
            json.dump(summary, f, indent=1)
        print(json.dumps(summary, indent=1))
        return
    with open(os.path.join(REPO, "data", "torch_port", "mono_reverse_jax.json")) as f:
        ref = json.load(f)
    c = ref["camera"]
    cam = CameraParams.create(c["fx"], c["fy"], c["cx"], c["cy"], width=c["width"], height=c["height"])
    seq = SyntheticSequence(cam=cam, **ref["sequence"])
    order = list(reversed(range(seq.n_frames)))[: WARMUP + FRAMES]
    images = {i: seq.render(i) for i in order}
    slam = UcoSlam(device="cuda")
    slam.readFromFile(os.path.join(REPO, "data", "torch_port", "mono_map.slm"), cam)
    slam.setMode(Mode.LOCALIZATION)
    for i in order[:WARMUP]:
        slam.process(images[i], fseq=i)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in order[WARMUP:]:
            for step in STEPS:
                with record_function(step):
                    if step == "extract":
                        frame = slam._extractor.process(images[i], fseq=i)
                    else:
                        slam._system.process_frame(frame)
                    torch.cuda.synchronize()
    events = prof.events()
    ranges = {step: [] for step in STEPS}
    for e in events:
        if e.name in ranges and e.device_type == torch.autograd.DeviceType.CPU:
            ranges[e.name].append((e.time_range.start, e.time_range.end))
    summary = {"frames": FRAMES}
    total_wall = total_busy = 0.0
    for step, spans in ranges.items():
        wall = sum(b - a for a, b in spans) / 1e3
        busy = sum(_device_busy_ms(events, a, b) for a, b in spans)
        total_wall += wall
        total_busy += busy
        summary[step] = {
            "wall_ms_per_frame": wall / FRAMES,
            "device_busy_ms_per_frame": busy / FRAMES,
            "device_idle_share": 1.0 - busy / max(wall, 1e-9),
        }
    summary["device_idle_share"] = 1.0 - total_busy / max(total_wall, 1e-9)
    table = [k for k in prof.key_averages() if k.key not in STEPS]
    # device activity only (kernels, copies): an operator's device time is
    # its kernels' again
    device_ops = [k for k in table if k.device_type == torch.autograd.DeviceType.CUDA]
    top = sorted(device_ops, key=lambda k: k.self_device_time_total, reverse=True)[:15]
    summary["device_events_per_frame"] = sum(k.count for k in device_ops) / FRAMES
    summary["port_kernels"] = [  # the port's own CUDA kernels, B1 and B2
        {"name": k.key, "calls": k.count, "device_ms_per_call": k.self_device_time_total / 1e3 / max(k.count, 1)}
        for k in device_ops if "project_match_kernel" in k.key or "motion_only_lm_kernel" in k.key
    ]
    summary["top_device_ops"] = [
        {"name": k.key, "calls": k.count, "device_ms_per_frame": k.self_device_time_total / 1e3 / FRAMES,
         "device_ms_per_call": k.self_device_time_total / 1e3 / max(k.count, 1)}
        for k in top
    ]
    top_cpu = sorted(table, key=lambda k: k.self_cpu_time_total, reverse=True)[:15]
    summary["top_host_ops"] = [
        {"name": k.key, "calls": k.count, "host_ms_per_frame": k.self_cpu_time_total / 1e3 / FRAMES}
        for k in top_cpu
    ]
    summary["device"] = torch.cuda.get_device_name(0)
    summary["nvidia_smi"] = _nvidia_smi()
    prof.export_chrome_trace(os.path.join(args.out_dir, "slice_trace.json"))
    with open(os.path.join(args.out_dir, "profile_slice.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1))


if __name__ == "__main__":
    main()
