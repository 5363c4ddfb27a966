"""The port's command-line apps on the CPU, against the JAX package.

- `apps.test_sequence` in-process with `--device cpu` on a 10-frame TUM
  tree and an 8-frame EuRoC tree, both written by the JAX package's writers,
  with a `--params` file written by the JAX package's `Params.save_yml`:
  the `|@#` lines with the stage timers, a `map.slm` the JAX package
  loads with the port's signature, a `trajectory.txt` the JAX package
  parses, an `ATE=` equal to the JAX package's `compare_logs.evaluate` of
  the port's own files and under 0.2 (tests/test_apps.py's gate); then
  `run_slam --mode localization --in-map` of that map (tracked >= pass 2 -
  2) and `test_reloc` on it (success rate >= the JAX package's
  `test_reloc` on the same map and tree);
- `compare_logs` prints the JAX package's line;
- `map_export` on the JAX package's maps: PLY and PCD text equal to the
  JAX package's, the marker-map YAML read back by cv2.FileStorage equal to
  the JAX package's, the PMVS files equal, the same count of unused
  keypoints removed;
- `MapViewer` draws the JAX viewer's image of the same map, headless;
- `analyze_logs` and `stereo_rectify` print what the JAX package's print.
"""

import contextlib
import io
import json
import os
import re
import threading

import cv2
import numpy as np
import pytest
import torch

from ucoslam_tpu.apps import analyze_logs as ref_analyze
from ucoslam_tpu.apps import compare_logs as ref_compare
from ucoslam_tpu.apps import map_export as ref_map_export
from ucoslam_tpu.apps import stereo_rectify as ref_stereo_rectify
from ucoslam_tpu.apps import test_reloc as ref_test_reloc
from ucoslam_tpu.config import Params as RefParams
from ucoslam_tpu.io.datasets import EurocSequence as RefEuroc
from ucoslam_tpu.io.datasets import load_trajectory_tum as ref_load_trajectory
from ucoslam_tpu.io.datasets import write_synthetic_euroc, write_synthetic_tum
from ucoslam_tpu.io.serialize import load_map as ref_load_map
from ucoslam_tpu.io.synthetic import SyntheticSequence as RefSequence
from ucoslam_tpu_torch.apps import analyze_logs, compare_logs, map_export, run_slam, stereo_rectify, test_reloc
from ucoslam_tpu_torch.apps import test_sequence
from ucoslam_tpu_torch.io.serialize import load_map
from ucoslam_tpu_torch.utils.timers import STAGES, StageTimers

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(os.path.dirname(HERE), "data", "torch_port")
#: tests/test_torch_slam.py's widths
PARAMS = RefParams().replace(
    detectMarkers=False, maxDescDistance=60.0, maxKeyPointsPerFrame=512,
    nOctaveLevels=4, maxMapPoints=4096, maxKeyFrames=32,
)
CAMERA_YML = "fx: 500.0\nfy: 500.0\ncx: 320.0\ncy: 240.0\nwidth: 640\nheight: 480\nbl: 0.0\n"


def _run(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    assert rc in (0, None), buf.getvalue()[-2000:]
    return buf.getvalue()


@pytest.fixture(scope="module")
def tum_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("tum")
    root, out = str(d / "tree"), str(d / "run")
    write_synthetic_tum(RefSequence(n_frames=10, seed=13, n_points=700), root)
    PARAMS.save_yml(str(d / "params.yml"))
    (d / "cam.yml").write_text(CAMERA_YML)
    text = _run(test_sequence.main, ["--dataset", root, "--out-dir", out, "--params", str(d / "params.yml"),
                                     "--device", "cpu"])
    return dict(root=root, out=out, text=text, cam=str(d / "cam.yml"), dir=d)


def test_harness_on_jax_tum_tree(tum_run):
    text, out = tum_run["text"], tum_run["out"]
    frames = re.findall(r"^\|@# Image (\d+)/10 fps=[\d.]+ sig=[0-9a-f]{16} (.*)$", text, re.M)
    assert [int(i) for i, _ in frames] == list(range(1, 11))
    assert "extract=" in frames[-1][1] and "track=" in frames[-1][1] and "mapping=" in frames[-1][1]
    m = re.search(r"tracked=(\d+)/10 pass1_tracked=(\d+)/10 recoveries=0 keyframes=(\d+) points=(\d+)", text)
    assert m is not None, text[-1500:]
    assert re.search(r"steadyFPS=[\d.]+ .* decodeMs=[\d.]+", text)
    # the JAX package reads the port's map, with the port's signature
    ref_map = ref_load_map(os.path.join(out, "map.slm"))
    assert ref_map.signature() == load_map(os.path.join(out, "map.slm"), "cpu").signature()
    assert ref_map.n_keyframes == int(m.group(3)) and ref_map.n_points == int(m.group(4))
    stamps, centers, _ = ref_load_trajectory(os.path.join(out, "trajectory.txt"))
    assert len(stamps) == int(m.group(1)) and np.isfinite(centers).all()
    ate = float(re.search(r"^ATE=([\d.]+) perctFramesTracked=([\d.]+)$", text, re.M).group(1))
    want = ref_compare.evaluate(os.path.join(out, "trajectory.txt"), os.path.join(tum_run["root"], "groundtruth.txt"))
    assert f"{ate:.6f}" == f"{want[0]:.6f}"
    assert ate < 0.2, f"two-pass ATE {ate}"
    with open(os.path.join(out, "summary.json")) as f:
        summary = json.load(f)
    assert summary["pass2_tracked"] == int(m.group(1)) and abs(summary["ate"] - want[0]) < 1e-12
    assert {"extract", "track", "mapping"} <= set(summary["stage_ms"])


def test_compare_logs_prints_reference_line(tum_run):
    args = [os.path.join(tum_run["out"], "trajectory.txt"), os.path.join(tum_run["root"], "groundtruth.txt")]
    for extra in ([], ["--no-scale"]):
        assert _run(compare_logs.main, args + extra) == _run(ref_compare.main, args + extra)


def test_run_slam_localization_and_test_reloc(tum_run):
    map_path = os.path.join(tum_run["out"], "map.slm")
    pass2 = int(re.search(r"tracked=(\d+)/10 pass1", tum_run["text"]).group(1))
    traj = str(tum_run["dir"] / "loc.txt")
    text = _run(run_slam.main, ["--dataset", tum_run["root"], "--camera", tum_run["cam"], "--mode", "localization",
                                "--in-map", map_path, "--out", traj, "--device", "cpu"])
    tracked = int(re.search(r"^tracked (\d+)/10 frames", text, re.M).group(1))
    assert tracked >= pass2 - 2
    assert len(ref_load_trajectory(traj)[0]) == tracked
    args = ["--map", map_path, "--dataset", tum_run["root"], "--camera", tum_run["cam"]]
    got = _run(test_reloc.main, args + ["--device", "cpu"])
    want = _run(ref_test_reloc.main, args)
    rate = float(re.search(r"relocRate=([\d.]+)", got).group(1))
    assert rate >= float(re.search(r"relocRate=([\d.]+)", want).group(1))
    assert len(re.findall(r"^\|@# Reloc \d+/10 ok=", got, re.M)) == 10


def test_harness_on_jax_euroc_tree(tmp_path):
    root, out = str(tmp_path / "euroc"), str(tmp_path / "run")
    write_synthetic_euroc(RefSequence(n_frames=8, n_points=500), root, stereo=False)
    PARAMS.save_yml(str(tmp_path / "params.yml"))
    text = _run(test_sequence.main, ["--dataset", root, "--out-dir", out, "--params", str(tmp_path / "params.yml"),
                                     "--device", "cpu"])
    assert "|@# Image 8/8" in text
    ate = float(re.search(r"^ATE=([\d.]+)", text, re.M).group(1))
    assert ate < 0.2, f"EuRoC two-pass ATE {ate}"
    # the ground truth re-emitted in the TUM format, as the reference harness writes it
    gs, gc, gq = RefEuroc.open(root, stereo=False).gt
    want = "".join(f"{t:.6f} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f} {q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
                   for t, c, q in zip(gs, gc, gq))
    with open(os.path.join(out, "groundtruth.txt")) as f:
        assert f.read() == want
    want = ref_compare.evaluate(os.path.join(out, "trajectory.txt"), os.path.join(out, "groundtruth.txt"))
    assert f"{ate:.6f}" == f"{want[0]:.6f}"


def _marker_map(path: str) -> dict:
    fs = cv2.FileStorage(path, cv2.FILE_STORAGE_READ)
    out = dict(dict=fs.getNode("aruco_bc_dict").string(), n=int(fs.getNode("aruco_bc_nmarkers").real()),
               info=int(fs.getNode("aruco_bc_mInfoType").real()), markers=[])
    seq = fs.getNode("aruco_bc_markers")
    for k in range(seq.size()):
        mk = seq.at(k)
        corners = mk.getNode("corners")
        out["markers"].append((int(mk.getNode("id").real()),
                               np.stack([corners.at(j).mat().ravel() for j in range(corners.size())])))
    fs.release()
    return out


@pytest.mark.parametrize("name", ["markers_map.slm", "mono_map.slm"])
def test_map_export_equals_reference(tmp_path, name):
    src = os.path.join(DATA, name)
    outs = {}
    for tag, main in (("port", map_export.main), ("jax", ref_map_export.main)):
        d = tmp_path / tag
        d.mkdir()
        outs[tag] = (d, _run(main, [src, "--ply", str(d / "m.ply"), "--pcd", str(d / "m.pcd"),
                                    "--markermap", str(d / "mm.yml"), "--pmvs", str(d / "pmvs"),
                                    "--strip-unused", str(d / "s.slm")]))
    (pd, ptext), (jd, jtext) = outs["port"], outs["jax"]
    # the summary, the marker count, the keyframe count, the keypoints stripped
    assert ptext.replace(str(pd), "OUT") == jtext.replace(str(jd), "OUT")
    assert re.search(r"stripped \d+ unused keypoints", ptext)
    for f in ("m.ply", "m.pcd"):
        assert (pd / f).read_text() == (jd / f).read_text(), f
    got, want = _marker_map(str(pd / "mm.yml")), _marker_map(str(jd / "mm.yml"))
    assert (got["dict"], got["n"], got["info"]) == (want["dict"], want["n"], want["info"])
    assert [i for i, _ in got["markers"]] == [i for i, _ in want["markers"]]
    for (_, a), (_, b) in zip(got["markers"], want["markers"]):
        np.testing.assert_array_equal(a, b)
    if name == "markers_map.slm":
        assert got["n"] > 0
    files = sorted(os.path.relpath(os.path.join(r, f), pd / "pmvs") for r, _, fs in os.walk(pd / "pmvs") for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(r, f), jd / "pmvs")
                           for r, _, fs in os.walk(jd / "pmvs") for f in fs)
    assert len(files) == 2 + int(re.search(r"(\d+) keyframes, ", ptext).group(1))
    for f in files:
        assert (pd / "pmvs" / f).read_text() == (jd / "pmvs" / f).read_text(), f
    np.testing.assert_array_equal(np.asarray(ref_load_map(str(pd / "s.slm")).state.kf_kpt_valid),
                                  np.asarray(ref_load_map(str(jd / "s.slm")).state.kf_kpt_valid))


def test_viewer_draws_reference_image_headless(monkeypatch):
    from ucoslam_tpu.viz import MapViewer as RefViewer
    from ucoslam_tpu_torch.viz.viewer import MapViewer

    monkeypatch.delenv("DISPLAY", raising=False)
    path = os.path.join(DATA, "markers_map.slm")
    m, ref_m = load_map(path, "cpu"), ref_load_map(path)
    pose = m.h("kf_pose")[m.keyframes.active_slots()[-1]]
    for opts in ({}, {"drawCovisGraph": "1", "showNumbers": "1"}, {"followCamera": "0", "mode": "1"}):
        v, rv = MapViewer(320, 240), RefViewer(320, 240)
        for k, val in opts.items():
            v.set(k, val)
            rv.set(k, val)
        img = v.snapshot(m, pose)
        assert img.shape == (240, 320, 3) and (img != 24).any()
        np.testing.assert_array_equal(img, rv.snapshot(ref_m, pose))
    assert MapViewer().show(m, None, pose) == 255


def test_analyze_logs_and_stereo_rectify_print_reference_lines(tum_run, tmp_path):
    root = tmp_path / "results"
    for method in ("a", "b"):
        for k in range(3):
            d = root / method / f"seq{k}"
            d.mkdir(parents=True)
            gt = os.path.join(tum_run["root"], "groundtruth.txt")
            (d / "groundtruth.txt").write_text(open(gt).read())
            stamps, centers, quats = ref_load_trajectory(gt)
            rng = np.random.default_rng(k + (method == "b") * 10)
            noisy = centers + rng.normal(0, 0.01 * (1 + k), centers.shape)
            (d / "trajectory.txt").write_text("".join(
                f"{t:.6f} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f} {q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
                for t, c, q in zip(stamps, noisy, quats)))
    for args in ([str(root)], [str(root), "--wilcoxon", "a", "b"]):
        assert _run(analyze_logs.main, args) == _run(ref_analyze.main, args)
    calib = tmp_path / "calib.yml"
    calib.write_text("fx1: 480\nfy1: 482\ncx1: 322\ncy1: 238\nk1_1: -0.1\nfx2: 476\nfy2: 478\ncx2: 318\ncy2: 242\n"
                     "rvec: 0.01 -0.02 0.005\nT: -0.11 0.002 0.001\n")
    got = _run(stereo_rectify.main, [str(calib), "--out", str(tmp_path / "p.yml"), "--device", "cpu"])
    want = _run(ref_stereo_rectify.main, [str(calib), "--out", str(tmp_path / "j.yml")])
    assert got.replace("p.yml", "j.yml") == want
    assert (tmp_path / "p.yml").read_text() == (tmp_path / "j.yml").read_text()


def test_pmvs_images_undistorted_as_cv2(tmp_path):
    """export_pmvs's keyframe images: undistorted by the port's remap
    within 1 grey level of cv2.undistort away from the border (where cv2
    fills 0 and the port clamps), written as PPM that cv2 reads back."""
    from ucoslam_tpu_torch.geometry.camera import CameraParams
    from ucoslam_tpu_torch.io.exporters import export_pmvs, undistort_image

    dist = [-0.2, 0.05, 0.001, -0.001, 0.0]
    cam = CameraParams.create(500.0, 500.0, 320.0, 240.0, dist=dist)
    rng = np.random.default_rng(0)
    img = cv2.GaussianBlur(rng.integers(0, 256, (480, 640), dtype=np.uint8), (0, 0), 3)
    img = np.clip((img.astype(int) - 128) * 4 + 128, 0, 255).astype(np.uint8)
    want = cv2.undistort(img, np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]]), np.array(dist))
    got = undistort_image(img, cam)
    assert got.dtype == np.uint8 and got.shape == img.shape
    assert np.abs(got.astype(int) - want)[20:-20, 20:-20].max() <= 1
    m = load_map(os.path.join(DATA, "mono_map.slm"), "cpu")
    fseqs = m.h("kf_fseq")[m.keyframes.active_slots()]
    n = export_pmvs(m, cam, str(tmp_path / "pmvs"), images={int(f): img for f in fseqs})
    assert n == len(fseqs)
    back = cv2.imread(str(tmp_path / "pmvs" / "visualize" / "00000000.ppm"), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(back, got)


def test_stage_timers_report_while_another_thread_adds_stages():
    """The async mapping worker ends spans (`ba.local_ba`, `mapping.loop`)
    while the tracker's thread prints its `|@#` line: no report reads the
    spans while one is appended, and none is lost."""
    reg = StageTimers()
    reg.start()
    names = list(STAGES.values())

    def worker():
        for i in range(20000):
            with reg.span(names[i % len(names)]):
                pass

    t = threading.Thread(target=worker)
    t.start()
    reports = 0
    try:
        while t.is_alive():
            reg.report()
            reports += 1
    finally:
        t.join()
    assert reports > 0 and set(reg.averages()) == set(STAGES)
    assert len(reg.drain()) == 20000
