"""Dataset readers and writers and trajectory IO (TUM / EuRoC / KITTI).

Port of `ucoslam_tpu/io/datasets.py`, with the same names, layouts and
text. The JAX package decodes and writes images with cv2, which the card's
machine lacks; this port reads them with `io.png` (`imread(path,
gray=True)` is cv2's IMREAD_GRAYSCALE, the raw read its IMREAD_UNCHANGED)
and writes them with `io.png.imwrite`, whose files decode to the same
pixels. The synthetic writers render the port's own
`io.synthetic.SyntheticSequence`, quantised as the reference's writers
quantise (truncation: `np.clip(img, 0, 255).astype(np.uint8)`, depth
`np.clip(z * 5000, 0, 65535).astype(np.uint16)`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ucoslam_tpu_torch.geometry.camera import CameraParams
from ucoslam_tpu_torch.io import png


# ----------------------------------------------------------------------
# Trajectory IO (TUM format: t tx ty tz qx qy qz qw)
# ----------------------------------------------------------------------


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """(3,3) -> (qx, qy, qz, qw)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[3] = (R[k, j] - R[j, k]) / s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        qx, qy, qz, qw = q
    return np.asarray([qx, qy, qz, qw])


def _quat_to_rot(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q
    n = x * x + y * y + z * z + w * w
    s = 2.0 / n if n > 0 else 0.0
    return np.asarray(
        [
            [1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w)],
            [s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w)],
            [s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y)],
        ]
    )


def save_trajectory_tum(path: str, stamps, poses_f2g) -> None:
    """Write camera-to-world poses in TUM format (the evaluation format)."""
    with open(path, "w") as f:
        for t, T in zip(stamps, poses_f2g):
            R = T[:3, :3]
            tr = T[:3, 3]
            c = -R.T @ tr  # camera center
            q = _rot_to_quat(R.T)  # camera-to-world rotation
            f.write(
                f"{t:.6f} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f} "
                f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
            )


def load_trajectory_tum(path: str):
    """-> (stamps (N,), centers (N, 3), quats (N, 4))."""
    stamps, centers, quats = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = line.split()
            if len(v) < 8:
                continue
            stamps.append(float(v[0]))
            centers.append([float(x) for x in v[1:4]])
            quats.append([float(x) for x in v[4:8]])
    return np.asarray(stamps), np.asarray(centers), np.asarray(quats)


def associate_trajectories(stamps_a, stamps_b, max_dt: float = 0.02):
    """Nearest-stamp association (the TUM benchmark associate step)."""
    pairs = []
    j = 0
    for i, ta in enumerate(stamps_a):
        while j + 1 < len(stamps_b) and abs(stamps_b[j + 1] - ta) <= abs(stamps_b[j] - ta):
            j += 1
        if len(stamps_b) and abs(stamps_b[j] - ta) <= max_dt:
            pairs.append((i, j))
    return pairs


# ----------------------------------------------------------------------
# TUM RGB-D directory layout
# ----------------------------------------------------------------------


@dataclass
class TumSequence:
    root: str
    rgb: list  # (stamp, relpath)
    depth: list  # (stamp, relpath)
    gt: tuple | None  # (stamps, centers, quats)

    @classmethod
    def open(cls, root: str) -> "TumSequence":
        def read_list(name):
            out = []
            p = os.path.join(root, name)
            if not os.path.exists(p):
                return out
            with open(p) as f:
                for line in f:
                    line = line.strip()
                    if not line or line.startswith("#"):
                        continue
                    v = line.split()
                    out.append((float(v[0]), v[1]))
            return out

        gt = None
        gtp = os.path.join(root, "groundtruth.txt")
        if os.path.exists(gtp):
            gt = load_trajectory_tum(gtp)
        return cls(root, read_list("rgb.txt"), read_list("depth.txt"), gt)

    def __len__(self):
        return len(self.rgb)

    def read_rgb(self, i: int) -> np.ndarray:
        """Grayscale (H, W) u8 — the pipeline is gray-first (the reference
        converts BGR->gray immediately, frameextractor COLOR_BGR2GRAY);
        decoding to gray here also cuts the host->device image upload 3x."""
        return png.imread(os.path.join(self.root, self.rgb[i][1]), gray=True)

    def read_depth_for(self, i: int) -> np.ndarray | None:
        if not self.depth:
            return None
        stamp = self.rgb[i][0]
        j = int(np.argmin([abs(s - stamp) for s, _ in self.depth]))
        if abs(self.depth[j][0] - stamp) > 0.05:
            return None
        return png.imread(os.path.join(self.root, self.depth[j][1]))


def _renders(seq, how, renders):
    """The frames' renders in order: `renders` when given (what `how`, one
    of seq's render methods, would give for each frame), else `how(i)`."""
    return renders if renders is not None else (how(i) for i in range(seq.n_frames))


def write_synthetic_tum(seq, root: str, depth: bool = False, renders=None) -> None:
    """Render a SyntheticSequence into a TUM-style dataset directory
    (`renders`: the frames' `render_with_depth` / `render` outputs, when
    made elsewhere)."""
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    if depth:
        os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    rgb_lines, depth_lines, gt_lines = [], [], []
    for i, out in enumerate(_renders(seq, seq.render_with_depth if depth else seq.render, renders)):
        stamp = i / 30.0
        if depth:
            img_f, dep = out
            img = np.clip(img_f, 0, 255).astype(np.uint8)
            # TUM RGB-D convention: 16-bit PNG, depth_png / 5000 = meters
            drel = f"depth/{stamp:.6f}.png"
            d16 = np.clip(np.asarray(dep) * 5000.0, 0, 65535).astype(np.uint16)
            png.imwrite(os.path.join(root, drel), d16)
            depth_lines.append(f"{stamp:.6f} {drel}")
        else:
            img = np.clip(out, 0, 255).astype(np.uint8)
        rel = f"rgb/{stamp:.6f}.png"
        png.imwrite(os.path.join(root, rel), img)
        rgb_lines.append(f"{stamp:.6f} {rel}")
        T = seq.gt_pose(i)
        c = -T[:3, :3].T @ T[:3, 3]
        q = _rot_to_quat(T[:3, :3].T)
        gt_lines.append(
            f"{stamp:.6f} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f} "
            f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}"
        )
    with open(os.path.join(root, "rgb.txt"), "w") as f:
        f.write("# synthetic\n" + "\n".join(rgb_lines) + "\n")
    if depth:
        with open(os.path.join(root, "depth.txt"), "w") as f:
            f.write("# synthetic depth\n" + "\n".join(depth_lines) + "\n")
    with open(os.path.join(root, "groundtruth.txt"), "w") as f:
        f.write("# synthetic gt\n" + "\n".join(gt_lines) + "\n")


# ----------------------------------------------------------------------
# KITTI odometry poses (kitti2tum_log.cpp equivalent)
# ----------------------------------------------------------------------


def load_kitti_poses(path: str) -> np.ndarray:
    """KITTI pose file (N lines x 12 floats, row-major 3x4 cam-to-world)."""
    rows = []
    with open(path) as f:
        for line in f:
            v = [float(x) for x in line.split()]
            if len(v) == 12:
                rows.append(np.asarray(v).reshape(3, 4))
    return np.stack(rows)


def kitti_to_tum(poses: np.ndarray, stamps=None):
    """(N, 3, 4) cam-to-world -> TUM tuple (stamps, centers, quats)."""
    n = len(poses)
    stamps = np.arange(n) * 0.1 if stamps is None else stamps
    centers = poses[:, :, 3]
    quats = np.stack([_rot_to_quat(P[:, :3]) for P in poses])
    return np.asarray(stamps), centers, quats


# ----------------------------------------------------------------------
# EuRoC-MAV directory layout (mav0/cam{0,1}/data.csv + sensor.yaml)
# (reference: tests/euroc_stereoRectification.cpp + test_generator_stereo.sh)
# ----------------------------------------------------------------------


def _parse_euroc_sensor_yaml(path: str) -> dict:
    """Minimal reader for EuRoC sensor.yaml: intrinsics, distortion,
    resolution, T_BS. Avoids a yaml dependency (the files are flat)."""
    import re

    out: dict = {}
    txt = open(path).read()

    def grab_list(key):
        m = re.search(rf"{key}:\s*\[([^\]]*)\]", txt)
        if not m:
            return None
        return [float(x) for x in m.group(1).replace("\n", " ").split(",")]

    out["intrinsics"] = grab_list("intrinsics")  # fu fv cu cv
    out["distortion"] = grab_list("distortion_coefficients")
    out["resolution"] = grab_list("resolution")
    m = re.search(r"data:\s*\[([^\]]*)\]", txt)
    if m:
        vals = [float(x) for x in m.group(1).replace("\n", " ").split(",")]
        if len(vals) == 16:
            out["T_BS"] = np.asarray(vals).reshape(4, 4)
    return out


@dataclass
class EurocSequence:
    """EuRoC-MAV sequence: `<root>/mav0/cam0` (+cam1 for stereo).

    cam_info holds the parsed sensor.yaml per camera; `baseline` is the
    cam0->cam1 distance from the T_BS extrinsics (for stereo bf).
    """

    root: str
    stamps: np.ndarray  # (N,) seconds
    files0: list
    files1: list | None
    cam_info: dict
    gt: tuple | None  # (stamps, centers, quats)

    @classmethod
    def open(cls, root: str, stereo: bool = True) -> "EurocSequence":
        def read_cam(cam):
            csv = os.path.join(root, "mav0", cam, "data.csv")
            stamps, files = [], []
            with open(csv) as f:
                for line in f:
                    line = line.strip()
                    if not line or line.startswith("#"):
                        continue
                    ts, fn = line.split(",")[:2]
                    stamps.append(int(ts) * 1e-9)
                    files.append(os.path.join(root, "mav0", cam, "data", fn.strip()))
            return np.asarray(stamps), files

        s0, f0 = read_cam("cam0")
        info = {"cam0": _parse_euroc_sensor_yaml(
            os.path.join(root, "mav0", "cam0", "sensor.yaml"))}
        f1 = None
        if stereo and os.path.exists(os.path.join(root, "mav0", "cam1", "data.csv")):
            s1, f1_all = read_cam("cam1")
            info["cam1"] = _parse_euroc_sensor_yaml(
                os.path.join(root, "mav0", "cam1", "sensor.yaml"))
            # associate cam1 frames to cam0 stamps
            f1 = []
            j = 0
            for t in s0:
                while j + 1 < len(s1) and abs(s1[j + 1] - t) <= abs(s1[j] - t):
                    j += 1
                f1.append(f1_all[j] if abs(s1[j] - t) < 0.005 else None)
        gt = None
        gtp = os.path.join(root, "mav0", "state_groundtruth_estimate0", "data.csv")
        if os.path.exists(gtp):
            gs, gc, gq = [], [], []
            with open(gtp) as f:
                for line in f:
                    line = line.strip()
                    if not line or line.startswith("#"):
                        continue
                    v = line.split(",")
                    gs.append(int(v[0]) * 1e-9)
                    gc.append([float(x) for x in v[1:4]])
                    qw, qx, qy, qz = (float(x) for x in v[4:8])
                    gq.append([qx, qy, qz, qw])
            gt = (np.asarray(gs), np.asarray(gc), np.asarray(gq))
        return cls(root, s0, f0, f1, info, gt)

    @property
    def baseline(self) -> float:
        if "cam1" not in self.cam_info:
            return 0.0
        T0 = self.cam_info["cam0"].get("T_BS")
        T1 = self.cam_info["cam1"].get("T_BS")
        if T0 is None or T1 is None:
            return 0.11  # the EuRoC rig's nominal baseline
        return float(np.linalg.norm(T0[:3, 3] - T1[:3, 3]))

    def camera(self):
        c = self.cam_info["cam0"]
        fu, fv, cu, cv = c["intrinsics"]
        res = c.get("resolution") or [752, 480]
        return CameraParams.create(
            fu, fv, cu, cv, dist=np.asarray(c.get("distortion") or [0] * 4),
            width=int(res[0]), height=int(res[1]), bl=self.baseline,
        )

    def __len__(self):
        return len(self.files0)

    def read(self, i: int, cam: int = 0) -> np.ndarray:
        path = self.files0[i] if cam == 0 else self.files1[i]
        return png.imread(path, gray=True)


# ----------------------------------------------------------------------
# KITTI odometry directory layout (image_0/ + times.txt + calib.txt)
# (reference: test_generator_monocular.sh:70+ runs KITTI 00-09)
# ----------------------------------------------------------------------


@dataclass
class KittiSequence:
    """KITTI odometry sequence dir: image_0/ (+image_1), times.txt,
    calib.txt with P0/P1 3x4 projections (baseline = -P1[0,3]/fx)."""

    root: str
    stamps: np.ndarray
    files0: list
    files1: list | None
    P0: np.ndarray
    P1: np.ndarray | None
    gt: tuple | None

    @classmethod
    def open(cls, root: str, poses_file: str | None = None) -> "KittiSequence":
        import glob as _glob

        def imgs(sub):
            d = os.path.join(root, sub)
            if not os.path.isdir(d):
                return None
            return sorted(_glob.glob(os.path.join(d, "*.png")))

        f0 = imgs("image_0") or imgs("image_2")
        f1 = imgs("image_1") or imgs("image_3")
        stamps = None
        tp = os.path.join(root, "times.txt")
        if os.path.exists(tp):
            stamps = np.asarray([float(x) for x in open(tp).read().split()])
        if stamps is None or (f0 and len(stamps) != len(f0)):
            stamps = np.arange(len(f0)) * 0.1
        P0 = P1 = None
        cp = os.path.join(root, "calib.txt")
        if os.path.exists(cp):
            for line in open(cp):
                k, _, v = line.partition(":")
                vals = [float(x) for x in v.split()] if v.strip() else []
                if len(vals) == 12:
                    if k.strip() in ("P0", "P2"):
                        P0 = np.asarray(vals).reshape(3, 4)
                    elif k.strip() in ("P1", "P3") and P1 is None:
                        P1 = np.asarray(vals).reshape(3, 4)
        if P0 is None:
            P0 = np.asarray([[718.856, 0, 607.1928, 0],
                             [0, 718.856, 185.2157, 0], [0, 0, 1, 0]])
        gt = None
        if poses_file and os.path.exists(poses_file):
            gt = kitti_to_tum(load_kitti_poses(poses_file), stamps)
        return cls(root, stamps, f0, f1, P0, P1, gt)

    def camera(self):
        fx, fy = self.P0[0, 0], self.P0[1, 1]
        cx, cy = self.P0[0, 2], self.P0[1, 2]
        bl = 0.0
        if self.P1 is not None:
            bl = float(-self.P1[0, 3] / fx)
        info = png.read_info(self.files0[0])
        h, w = info.height, info.width
        return CameraParams.create(fx, fy, cx, cy, width=w, height=h, bl=bl)

    def __len__(self):
        return len(self.files0)

    def read(self, i: int, cam: int = 0) -> np.ndarray:
        path = self.files0[i] if cam == 0 else self.files1[i]
        return png.imread(path, gray=True)


# ----------------------------------------------------------------------
# Per-suite parameter presets (test_generator_monocular.sh)
# ----------------------------------------------------------------------


def dataset_preset(kind: str):
    """Per-suite Params overrides from the reference's benchmark runners
    (test_generator_monocular.sh: KITTI `-KFMinConfidence 0.8 -KFCulling
    0.8 -recovery` :71; EuRoC difficult `-KFMinConfidence 0.8 -KFCulling
    0.9` :22-34; TUM runs defaults). Returns (params_overrides, harness)."""
    kind = kind.lower()
    if kind == "kitti":
        return {"KFMinConfidence": 0.8, "KFCulling": 0.8}, {"recovery": True}
    if kind in ("euroc", "euroc_difficult"):
        if kind == "euroc_difficult":
            return {"KFMinConfidence": 0.8, "KFCulling": 0.9}, {}
        return {}, {}
    if kind == "spm":
        return {"aruco_markerSize": 0.165,
                "aruco_CornerRefimentMethod": "CORNER_LINES"}, {}
    return {}, {}


def detect_dataset_format(root: str) -> str:
    """Sniff a dataset directory: 'euroc' | 'kitti' | 'tum'."""
    if os.path.exists(os.path.join(root, "mav0", "cam0", "data.csv")):
        return "euroc"
    if os.path.isdir(os.path.join(root, "image_0")) or os.path.isdir(
        os.path.join(root, "image_2")
    ):
        return "kitti"
    return "tum"


# ----------------------------------------------------------------------
# Synthetic writers (exercise the real loaders without network access)
# ----------------------------------------------------------------------


def write_synthetic_euroc(seq, root: str, stereo: bool = True, renders=None) -> None:
    """Render a SyntheticSequence into EuRoC mav0/ layout (`renders`: the
    frames' `render_stereo` / `render` outputs, when made elsewhere)."""
    for cam in ["cam0"] + (["cam1"] if stereo else []):
        os.makedirs(os.path.join(root, "mav0", cam, "data"), exist_ok=True)
    gt_dir = os.path.join(root, "mav0", "state_groundtruth_estimate0")
    os.makedirs(gt_dir, exist_ok=True)
    rows0, rows1, gt_rows = [], [], []
    for i, out in enumerate(_renders(seq, seq.render_stereo if stereo else seq.render, renders)):
        ns = int(i / 20.0 * 1e9)
        left, right = out if stereo else (out, None)
        fn = f"{ns}.png"
        png.imwrite(
            os.path.join(root, "mav0", "cam0", "data", fn),
            np.clip(left, 0, 255).astype(np.uint8),
        )
        rows0.append(f"{ns},{fn}")
        if right is not None:
            png.imwrite(
                os.path.join(root, "mav0", "cam1", "data", fn),
                np.clip(right, 0, 255).astype(np.uint8),
            )
            rows1.append(f"{ns},{fn}")
        T = seq.gt_pose(i)
        c = -T[:3, :3].T @ T[:3, 3]
        q = _rot_to_quat(T[:3, :3].T)  # (qx qy qz qw)
        gt_rows.append(
            f"{ns},{c[0]},{c[1]},{c[2]},{q[3]},{q[0]},{q[1]},{q[2]}"
            ",0,0,0,0,0,0,0,0,0"
        )
    fx, fy = float(seq.cam.fx), float(seq.cam.fy)
    cx, cy = float(seq.cam.cx), float(seq.cam.cy)
    w, h = seq.cam.width, seq.cam.height
    for cam, rows, xoff in (("cam0", rows0, 0.0), ("cam1", rows1, -seq.cam.bl)):
        if cam == "cam1" and not stereo:
            continue
        with open(os.path.join(root, "mav0", cam, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n" + "\n".join(rows) + "\n")
        with open(os.path.join(root, "mav0", cam, "sensor.yaml"), "w") as f:
            f.write(
                "sensor_type: camera\n"
                "T_BS:\n  cols: 4\n  rows: 4\n"
                f"  data: [1.0, 0.0, 0.0, {xoff}, 0.0, 1.0, 0.0, 0.0, "
                "0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0]\n"
                f"resolution: [{w}, {h}]\n"
                "camera_model: pinhole\n"
                f"intrinsics: [{fx}, {fy}, {cx}, {cy}]\n"
                "distortion_model: radial-tangential\n"
                "distortion_coefficients: [0.0, 0.0, 0.0, 0.0]\n"
            )
    with open(os.path.join(gt_dir, "data.csv"), "w") as f:
        f.write("#timestamp,p,q,...\n" + "\n".join(gt_rows) + "\n")


def write_synthetic_kitti(seq, root: str, stereo: bool = True, renders=None) -> None:
    """Render a SyntheticSequence into KITTI odometry layout (`renders`: the
    frames' `render_stereo` / `render` outputs, when made elsewhere)."""
    os.makedirs(os.path.join(root, "image_0"), exist_ok=True)
    if stereo:
        os.makedirs(os.path.join(root, "image_1"), exist_ok=True)
    times, pose_rows = [], []
    for i, out in enumerate(_renders(seq, seq.render_stereo if stereo else seq.render, renders)):
        left, right = out if stereo else (out, None)
        png.imwrite(
            os.path.join(root, "image_0", f"{i:06d}.png"),
            np.clip(left, 0, 255).astype(np.uint8),
        )
        if right is not None:
            png.imwrite(
                os.path.join(root, "image_1", f"{i:06d}.png"),
                np.clip(right, 0, 255).astype(np.uint8),
            )
        times.append(f"{i * 0.1:.6e}")
        T = seq.gt_pose(i)
        Tc2w = np.linalg.inv(np.vstack([T[:3], [0, 0, 0, 1]]))
        pose_rows.append(" ".join(f"{x:.6e}" for x in Tc2w[:3].reshape(-1)))
    with open(os.path.join(root, "times.txt"), "w") as f:
        f.write("\n".join(times) + "\n")
    fx, fy = float(seq.cam.fx), float(seq.cam.fy)
    cx, cy = float(seq.cam.cx), float(seq.cam.cy)
    with open(os.path.join(root, "calib.txt"), "w") as f:
        f.write(
            f"P0: {fx} 0 {cx} 0 0 {fy} {cy} 0 0 0 1 0\n"
            f"P1: {fx} 0 {cx} {-fx * seq.cam.bl} 0 {fy} {cy} 0 0 0 1 0\n"
        )
    with open(os.path.join(root, "poses.txt"), "w") as f:
        f.write("\n".join(pose_rows) + "\n")
