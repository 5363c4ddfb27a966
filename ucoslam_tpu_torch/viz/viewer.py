"""Headless-capable map viewer.

Counterpart of the reference MapViewer/MapDrawer (src/mapviewer.h:18-765):
the reference renders with its in-repo `sgl` software rasterizer and an
optional cv::imshow window; harnesses drive it through a string `set()`
interface (tests/test_sequence.cpp:141-151). Here: a software renderer
(map points, keyframe frusta, marker quads, covisibility graph, text/HUD)
onto a numpy canvas, the same `set()` string interface — and every option
key actually changes the rendering — plus `snapshot()` for headless use
and an optional cv2 window when a display exists.

Port of `ucoslam_tpu/viz/viewer.py`: the same renderer over the port's
`Map` (its host mirror, `Map.h`). cv2 is imported only inside `show`, and
only when `DISPLAY` is set; headless, `show` renders and returns 255.
"""

from __future__ import annotations

import numpy as np

from ucoslam_tpu_torch.mapping.map import Map

# 3x5 bitmap font for digits + a few glyphs (headless text overlay)
_FONT = {
    "0": "111101101101111", "1": "010110010010111", "2": "111001111100111",
    "3": "111001111001111", "4": "101101111001001", "5": "111100111001111",
    "6": "111100111101111", "7": "111001010010010", "8": "111101111101111",
    "9": "111101111001111", "k": "101110110110101", "f": "111100110100100",
    "p": "111101111100100", "t": "111010010010010", "m": "101111111101101",
    " ": "000000000000000", ":": "000010000010000", "=": "000111000111000",
    ".": "000000000000010", "-": "000000111000000",
}


def _draw_line(canvas: np.ndarray, x0, y0, x1, y1, color) -> None:
    h, w = canvas.shape[:2]
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1))
    xs = np.linspace(x0, x1, n + 1).astype(int)
    ys = np.linspace(y0, y1, n + 1).astype(int)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    canvas[ys[ok], xs[ok]] = color


def _draw_text(canvas: np.ndarray, x: int, y: int, text: str, color) -> None:
    h, w = canvas.shape[:2]
    cx = x
    for ch in str(text).lower():
        bits = _FONT.get(ch)
        if bits is None:
            cx += 4
            continue
        for r in range(5):
            for c in range(3):
                if bits[r * 3 + c] == "1":
                    yy, xx = y + r, cx + c
                    if 0 <= yy < h and 0 <= xx < w:
                        canvas[yy, xx] = color
        cx += 4


class MapViewer:
    def __init__(self, width: int = 960, height: int = 720):
        self.width = width
        self.height = height
        self.options: dict[str, str] = {
            "followCamera": "1",
            "mode": "0",  # 0 = full scene, 1 = points only
            "showNumbers": "0",
            "drawCovisGraph": "0",
            "showKeyFrames": "1",
            "showMarkers": "1",
        }
        self._window = False

    def set(self, key: str, value: str) -> None:
        """String-option interface (mapviewer.h:502 `set`)."""
        self.options[str(key)] = str(value)

    # ------------------------------------------------------------------
    def _view_pose(self, pose_f2g: np.ndarray | None) -> np.ndarray:
        """Virtual viewing camera: slightly behind/above the SLAM camera."""
        if pose_f2g is None or self.options.get("followCamera") != "1":
            T = np.eye(4, dtype=np.float32)
            T[2, 3] = 6.0
            return T
        offset = np.eye(4, dtype=np.float32)
        offset[:3, 3] = [0.0, -0.6, 1.5]
        return offset @ pose_f2g

    def snapshot(
        self,
        world_map: Map,
        pose_f2g: np.ndarray | None = None,
        message: str = "",
    ) -> np.ndarray:
        """Render the map to an (H, W, 3) uint8 image."""
        canvas = np.zeros((self.height, self.width, 3), np.uint8)
        canvas[:] = 24
        T = self._view_pose(pose_f2g)
        f = 0.8 * self.width
        cx, cy = self.width / 2.0, self.height / 2.0
        full_scene = self.options.get("mode", "0") == "0"

        def project(pts, clip=True):
            q = pts @ T[:3, :3].T + T[:3, 3]
            z = q[:, 2]
            ok = z > 0.1
            u = f * q[:, 0] / np.where(ok, z, 1.0) + cx
            v = f * q[:, 1] / np.where(ok, z, 1.0) + cy
            if clip:
                ok &= (u >= 0) & (u < self.width - 1) & (v >= 0) & (v < self.height - 1)
            return u.astype(int), v.astype(int), ok

        pt_pos, pt_active, kf_act, kf_pose, mk_active, mk_pose_valid = world_map.h(
            "pt_pos", "pt_active", "kf_active", "kf_pose", "mk_active", "mk_pose_valid")
        pts = pt_pos[pt_active]
        if len(pts):
            u, v, ok = project(pts)
            canvas[v[ok], u[ok]] = (90, 200, 90)

        kf_slots = np.nonzero(kf_act)[0]
        kf_poses = kf_pose[kf_slots]
        centers = np.stack(
            [-P[:3, :3].T @ P[:3, 3] for P in kf_poses]
        ) if len(kf_poses) else np.zeros((0, 3))

        # covisibility graph (drawCovisGraph option, mapviewer.h drawCovis)
        if (
            full_scene
            and len(centers) >= 2
            and self.options.get("drawCovisGraph") == "1"
        ):
            covis = world_map.covis_matrix()
            cu, cv_, cok = project(centers)
            sub = covis[np.ix_(kf_slots, kf_slots)]
            ia, ib = np.nonzero(np.triu(sub, 1) >= 15)
            for a, b in zip(ia, ib):
                if cok[a] and cok[b]:
                    _draw_line(
                        canvas, cu[a], cv_[a], cu[b], cv_[b], (120, 120, 60)
                    )

        # keyframe frusta (MapDrawer keyframe pyramids)
        if full_scene and len(centers) and self.options.get("showKeyFrames") == "1":
            s = 0.15
            local = np.array(
                [[-s, -s * 0.75, s * 1.6], [s, -s * 0.75, s * 1.6],
                 [s, s * 0.75, s * 1.6], [-s, s * 0.75, s * 1.6]], np.float32
            )
            cu, cv_, cok = project(centers)
            for i, P in enumerate(kf_poses):
                corners_w = (local - P[:3, 3]) @ P[:3, :3]  # R^T (x - t)
                wu, wv, wok = project(corners_w)
                if not cok[i]:
                    continue
                for j in range(4):
                    if wok[j]:
                        _draw_line(canvas, cu[i], cv_[i], wu[j], wv[j], (80, 120, 240))
                    if wok[j] and wok[(j + 1) % 4]:
                        _draw_line(
                            canvas, wu[j], wv[j], wu[(j + 1) % 4],
                            wv[(j + 1) % 4], (80, 120, 240),
                        )
                if self.options.get("showNumbers") == "1":
                    _draw_text(
                        canvas, cu[i] + 4, cv_[i] - 6, str(int(kf_slots[i])),
                        (220, 220, 220),
                    )

        # marker quads (MapDrawer marker rendering; Marker::get3DPoints)
        mk_act = mk_active & mk_pose_valid
        if full_scene and mk_act.any() and self.options.get("showMarkers") == "1":
            mk_slots = np.nonzero(mk_act)[0]
            mk_pose, mk_size, mk_id = world_map.h("mk_pose", "mk_size", "mk_id")
            mk_poses = mk_pose[mk_slots]
            mk_sizes = mk_size[mk_slots]
            mk_ids = mk_id[mk_slots]
            for P, sz, mid in zip(mk_poses, mk_sizes, mk_ids):
                hs = max(float(sz), 1e-3) / 2.0
                local = np.array(
                    [[-hs, hs, 0], [hs, hs, 0], [hs, -hs, 0], [-hs, -hs, 0]],
                    np.float32,
                )
                corners_w = local @ P[:3, :3].T + P[:3, 3]
                wu, wv, wok = project(corners_w)
                for j in range(4):
                    if wok[j] and wok[(j + 1) % 4]:
                        _draw_line(
                            canvas, wu[j], wv[j], wu[(j + 1) % 4],
                            wv[(j + 1) % 4], (60, 60, 230),
                        )
                if self.options.get("showNumbers") == "1" and wok.any():
                    _draw_text(
                        canvas, wu[wok][0] + 3, wv[wok][0] + 3, str(int(mid)),
                        (90, 90, 250),
                    )

        if pose_f2g is not None:
            c = (-pose_f2g[:3, :3].T @ pose_f2g[:3, 3])[None]
            u, v, ok = project(c)
            if ok.any():
                canvas[
                    max(0, v[0] - 3) : v[0] + 4, max(0, u[0] - 3) : u[0] + 4
                ] = (0, 255, 255)

        # HUD: message + map stats (the reference's status text overlay)
        hud = message or (
            f"kf={int(kf_act.sum())} pt={int(pt_active.sum())}"
        )
        _draw_text(canvas, 4, 4, hud, (240, 240, 240))
        return canvas

    def show(
        self,
        world_map: Map,
        image: np.ndarray | None = None,
        pose_f2g: np.ndarray | None = None,
        message: str = "",
        wait_ms: int = 1,
    ) -> int:
        """Render; open a cv2 window when a display exists. Returns keycode
        (the reference returns the pressed key; headless always 255)."""
        canvas = self.snapshot(world_map, pose_f2g, message)
        try:
            import os

            if not os.environ.get("DISPLAY"):
                return 255
            import cv2

            cv2.imshow("ucoslam_tpu map", canvas)
            return cv2.waitKey(wait_ms) & 0xFF
        except Exception:
            return 255
