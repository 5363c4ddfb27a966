"""Map exporters: ArUco marker-map YAML and PMVS2 reconstruction input.

Port of `ucoslam_tpu/io/exporters.py`: counterparts of Map::saveToMarkerMap
(map.cpp:1269-1286, the aruco MarkerMap FileStorage layout,
3rdparty/aruco/aruco/markermap.cpp:66-93) and utils/ucoslam_pmvs2.cpp
(projection-matrix txt files + vis.dat covisibility lists + option.txt for
the CMVS-PMVS pipeline). The card's machine has no cv2: the marker map's
OpenCV FileStorage YAML is written by hand (cv2.FileStorage reads it back
as the reference's file), and the PMVS keyframe images are undistorted by
the port's own bilinear remap and written as binary PPM, which PMVS2 reads
as it reads JPEG.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ucoslam_tpu_torch.ops.image import bilinear_sample


def _yaml_double(x: float) -> str:
    """A double as %.17g, which strtod reads back to the same bits."""
    s = f"{float(x):.17g}"
    return s if any(c in s for c in ".enai") else s + "."


def export_marker_map(world_map, path: str, dictionary: str = "ARUCO_MIP_36h12") -> int:
    """Write valid-pose markers as an aruco MarkerMap YAML (METERS).

    Returns the number of markers exported. Layout matches
    MarkerMap::saveToFile so the file loads in the reference aruco library.
    """
    mk_valid, mk_id, mk_pose, mk_size = world_map.h("mk_pose_valid", "mk_id", "mk_pose", "mk_size")
    slots = np.nonzero(mk_valid & (mk_id >= 0))[0]
    lines = [
        "%YAML:1.0",
        "---",
        f"aruco_bc_dict: {dictionary}",
        f"aruco_bc_nmarkers: {len(slots)}",
        "aruco_bc_mInfoType: 1",  # METERS
        "aruco_bc_markers:" if len(slots) else "aruco_bc_markers: []",
    ]
    for s in slots:
        h = np.float32(mk_size[s]) / np.float32(2.0)
        obj = np.asarray([[-h, h, 0], [h, h, 0], [h, -h, 0], [-h, -h, 0]], np.float32)
        T = mk_pose[s]
        corners = obj @ T[:3, :3].T + T[:3, 3]  # get3DPoints (marker.h:44)
        lines += ["   -", f"      id: {int(mk_id[s])}", "      corners:"]
        for c in corners.astype(np.float64):
            lines += ["         - !!opencv-matrix", "            rows: 1", "            cols: 3", "            dt: d",
                      f"            data: [ {', '.join(_yaml_double(v) for v in c)} ]"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return len(slots)


def undistort_image(img: np.ndarray, cam, device="cpu") -> np.ndarray:
    """cv2.undistort(img, K, dist) with the same camera matrix for the
    output: each pixel's ray distorted into the source and sampled
    bilinearly (borders clamped). (H, W) or (H, W, C) -> same, uint8."""
    h, w = img.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    xn = np.stack([(xs - cam.cx) / cam.fx, (ys - cam.cy) / cam.fy], -1)
    xyd = cam.distort_normalized(torch.from_numpy(xn).to(device))
    grid = torch.stack([xyd[..., 0] * cam.fx + cam.cx, xyd[..., 1] * cam.fy + cam.cy], -1)
    src = torch.from_numpy(np.asarray(img, np.float32)).to(device)
    chans = [src] if src.ndim == 2 else [src[..., c] for c in range(src.shape[2])]
    out = torch.stack([bilinear_sample(c, grid, mode="bilinear") for c in chans], -1).cpu().numpy()
    out = np.clip(np.round(out), 0, 255).astype(np.uint8)
    return out[..., 0] if src.ndim == 2 else out


def write_ppm(path: str, img: np.ndarray) -> None:
    """Binary PGM (grey) or PPM (BGR input, written RGB), 8-bit."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    if img.ndim == 2:
        head, body = f"P5\n{w} {h}\n255\n", img
    else:
        head, body = f"P6\n{w} {h}\n255\n", img[..., 2::-1]
    with open(path, "wb") as f:
        f.write(head.encode() + np.ascontiguousarray(body).tobytes())


def export_pmvs(world_map, cam, out_dir: str, images: dict | None = None) -> int:
    """Write PMVS2 input (txt/ projection matrices, vis.dat, option.txt,
    visualize/ undistorted keyframe images, as PPM, when `images` maps
    fseq->array).

    Counterpart utils/ucoslam_pmvs2.cpp: P = K[3x4] @ pose_f2g per keyframe,
    vis.dat from covisibility neighbours. Returns keyframe count.
    """
    os.makedirs(os.path.join(out_dir, "txt"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "visualize"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "models"), exist_ok=True)

    kf_pose, kf_fseq = world_map.h("kf_pose", "kf_fseq")
    slots = world_map.keyframes.active_slots()
    poses = kf_pose[slots]
    fseqs = kf_fseq[slots]
    K34 = np.zeros((3, 4), np.float32)
    K34[:3, :3] = cam.K().numpy()
    covis = world_map.covis_matrix()
    idx_of = {int(s): i for i, s in enumerate(slots)}

    for i, s in enumerate(slots):
        P = K34 @ poses[i]
        with open(os.path.join(out_dir, "txt", f"{i:08d}.txt"), "w") as f:
            f.write("CONTOUR\n")
            for r in range(3):
                f.write(" ".join(f"{P[r, c]:.9g}" for c in range(4)) + "\n")
        if images is not None and int(fseqs[i]) in images:
            img = images[int(fseqs[i])]
            if cam.has_distortion():
                img = undistort_image(img, cam, device=world_map.device)
            write_ppm(os.path.join(out_dir, "visualize", f"{i:08d}.ppm"), img)

    with open(os.path.join(out_dir, "vis.dat"), "w") as f:
        f.write(f"VISDATA {len(slots)}\n")
        for i, s in enumerate(slots):
            nbrs = [
                idx_of[int(n)]
                for n in np.nonzero(covis[int(s)] > 0)[0]
                if int(n) != int(s) and int(n) in idx_of
            ]
            f.write(f"{i} " + " ".join(str(n) for n in nbrs) + "\n")

    with open(os.path.join(out_dir, "option.txt"), "w") as f:
        f.write(
            "level 2\ncsize 2\nthreshold 0.7\nwsize 7\nminImageNum 3\n"
            "CPU 4\nuseVisData 1\nsequence 1\n"
            f"timages -1 0 {len(slots)}\noimages 0\n"
        )
    return len(slots)
