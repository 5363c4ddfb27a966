"""Map inspection / export tool.

Counterpart of utils/ucoslam_map_export.cpp (+ the
ucoslam_map_removeunusedkeypoint tool): load a .slm map, print a summary,
export the point cloud (ply/pcd), optionally strip unused keypoints and
re-save.

Port of `ucoslam_tpu/apps/map_export.py`; the map is loaded on the CPU.

Usage:
  python -m ucoslam_tpu_torch.apps.map_export map.slm [--ply out.ply] [--pcd out.pcd]
      [--strip-unused resaved.slm] [--markermap out.yml] [--pmvs out_dir]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    from ucoslam_tpu_torch.io.serialize import load_map, save_map

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("map")
    ap.add_argument("--ply")
    ap.add_argument("--pcd")
    ap.add_argument("--strip-unused")
    ap.add_argument("--markermap", help="export valid markers as aruco MarkerMap YAML")
    ap.add_argument("--pmvs", help="export PMVS2 reconstruction input dir")
    ap.add_argument("--fx", type=float, default=500.0, help="fx for --pmvs")
    ap.add_argument("--fy", type=float, default=500.0)
    ap.add_argument("--cx", type=float, default=320.0)
    ap.add_argument("--cy", type=float, default=240.0)
    args = ap.parse_args(argv)

    m = load_map(args.map, "cpu")
    print(
        f"map: {m.n_points} points, {m.n_keyframes} keyframes, "
        f"{m.markers.n_active} markers, signature {m.signature():016x}"
    )
    if args.ply:
        m.export_pointcloud(args.ply)
        print(f"ply -> {args.ply}")
    if args.pcd:
        m.export_pointcloud(args.pcd)
        print(f"pcd -> {args.pcd}")
    if args.markermap:
        from ucoslam_tpu_torch.io.exporters import export_marker_map

        n = export_marker_map(m, args.markermap)
        print(f"markermap ({n} markers) -> {args.markermap}")
    if args.pmvs:
        from ucoslam_tpu_torch.geometry.camera import CameraParams
        from ucoslam_tpu_torch.io.exporters import export_pmvs

        cam = CameraParams.create(args.fx, args.fy, args.cx, args.cy)
        n = export_pmvs(m, cam, args.pmvs)
        print(f"pmvs ({n} keyframes) -> {args.pmvs}")
    if args.strip_unused:
        n = m.remove_unused_keypoints()
        save_map(m, args.strip_unused)
        print(f"stripped {n} unused keypoints -> {args.strip_unused}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
