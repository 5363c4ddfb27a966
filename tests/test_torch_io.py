"""The port's IO layer against cv2 and the JAX package, on the CPU.

- `io.png`: files written by cv2 at every IMWRITE_PNG_FILTER (the five
  filter types one at a time, and libpng's adaptive choice), compression
  level and strategy, grey 8/16-bit, BGR 8/16-bit and BGRA, and by PIL
  (palette at 8 and 4 bits, with and without tRNS; grey-alpha): the port's
  decode equals cv2.imread(IMREAD_UNCHANGED) exactly, and its grey read
  equals IMREAD_GRAYSCALE exactly (tolerance 0 grey levels; the measured
  share of differing pixels is 0); so do Adam7 interlaced files of every
  colour type and bit depth, and grey and RGB files with a tRNS chunk, at
  sizes from 1x1 to 480x640 (written by `write_png` below, since cv2 and
  PIL write neither here); a corrupt file raises; the port's encoder
  writes files cv2 reads back as their source.
- `io.datasets`: the JAX package's writers (cv2) and the port's (io.png),
  from the same SyntheticSequence arguments, write the same text files byte
  for byte and the same pixels and depth; the port's readers give the JAX
  readers' cameras, stamps and ground truth on both trees.
- trajectory IO, quaternions, KITTI poses, presets and format detection
  agree with the JAX package's.
"""

import filecmp
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import ucoslam_tpu.io.datasets as ref
from ucoslam_tpu.io.synthetic import SyntheticSequence as RefSequence
from ucoslam_tpu_torch.io import datasets, png
from ucoslam_tpu_torch.io.synthetic import SyntheticSequence
from ucoslam_tpu_torch.utils import hostbuild

torch.set_num_threads(2)

FILTER_FLAGS = [getattr(cv2, f"IMWRITE_PNG_FILTER_{n}") for n in ("NONE", "SUB", "UP", "AVG", "PAETH")]
FILTER_FLAGS.append(cv2.IMWRITE_PNG_ALL_FILTERS)


def _images():
    """Grey, BGR and BGRA test images: a ramp with noise, so every filter
    type pays off somewhere."""
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:37, 0:53]
    base = ((xx * 3 + yy * 2) % 256).astype(np.int64)
    noisy = lambda shape, amp: np.clip(base.reshape(*base.shape, *([1] * (len(shape) - 2)))  # noqa: E731
                                       + rng.integers(-amp, amp, shape), 0, 255)
    return {
        "gray8": noisy((37, 53), 20).astype(np.uint8),
        "gray16": (base * 257 + rng.integers(0, 200, base.shape)).astype(np.uint16),
        "bgr8": noisy((37, 53, 3), 30).astype(np.uint8),
        "bgra8": noisy((37, 53, 4), 30).astype(np.uint8),
        "bgr16": (base[..., None] * 200 + rng.integers(0, 500, (37, 53, 3))).astype(np.uint16),
    }


def _filter_types(path: str) -> set:
    """The filter byte of every row, after inflating the image data."""
    with open(path, "rb") as f:
        data = f.read()
    pos, idat, info = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        if kind == b"IHDR":
            info = struct.unpack(">IIBBBBB", data[pos + 8 : pos + 21])
        elif kind == b"IDAT":
            idat.append(data[pos + 8 : pos + 8 + n])
        pos += 12 + n
    w, h, depth, ctype = info[:4]
    rowbytes = (w * png.CHANNELS[ctype] * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return set(int(t) for t in raw[:: rowbytes + 1][:h])


def test_png_decode_equals_cv2(tmp_path):
    seen, n_files, n_pixels = set(), 0, 0
    for name, img in _images().items():
        for flt in FILTER_FLAGS:
            for level in range(10):
                for strategy in range(5):
                    path = str(tmp_path / f"{name}.png")
                    cv2.imwrite(path, img, [cv2.IMWRITE_PNG_FILTER, flt, cv2.IMWRITE_PNG_COMPRESSION, level,
                                            cv2.IMWRITE_PNG_STRATEGY, strategy])
                    seen |= _filter_types(path)
                    got, want = png.imread(path), cv2.imread(path, cv2.IMREAD_UNCHANGED)
                    assert got.dtype == want.dtype and got.shape == want.shape, (name, flt, level, strategy)
                    np.testing.assert_array_equal(got, want)
                    gray, want_gray = png.imread(path, gray=True), cv2.imread(path, cv2.IMREAD_GRAYSCALE)
                    assert gray.dtype == np.uint8
                    np.testing.assert_array_equal(gray, want_gray)  # tolerance: 0 grey levels
                    n_files += 1
                    n_pixels += gray.size
    assert seen == {0, 1, 2, 3, 4}, f"filter types in the test files: {sorted(seen)}"
    assert n_files == 5 * 6 * 10 * 5 and n_pixels > 0


@pytest.mark.parametrize("kind", ["palette8", "palette4", "palette_trns", "gray_alpha", "bilevel"])
def test_png_decode_pil_and_bilevel_equal_cv2(tmp_path, kind):
    imgs = _images()
    rgb = np.ascontiguousarray(imgs["bgr8"][..., ::-1])
    path = str(tmp_path / "p.png")
    if kind == "palette8":
        Image.fromarray(rgb).quantize(200).save(path)
    elif kind == "palette4":
        Image.fromarray(rgb).quantize(10).save(path)
        assert png.read_info(path).bit_depth == 4
    elif kind == "palette_trns":
        Image.fromarray(rgb).quantize(200).save(path, transparency=bytes([0, 128] + [255] * 50))
    elif kind == "gray_alpha":
        g = imgs["gray8"]
        Image.fromarray(np.dstack([g, g[::-1]]), "LA").save(path)
    else:
        cv2.imwrite(path, (imgs["gray8"] > 128).astype(np.uint8) * 255, [cv2.IMWRITE_PNG_BILEVEL, 1])
        assert png.read_info(path).bit_depth == 1
    np.testing.assert_array_equal(png.imread(path), cv2.imread(path, cv2.IMREAD_UNCHANGED))
    np.testing.assert_array_equal(png.imread(path, gray=True), cv2.imread(path, cv2.IMREAD_GRAYSCALE))


def test_png_interlaced_and_corrupt_files_raise(tmp_path):
    data = bytearray(png.encode(_images()["gray8"]))
    bad_crc = bytes(data[:20]) + bytes([data[20] ^ 1]) + bytes(data[21:])
    with pytest.raises(ValueError, match="CRC"):
        png.decode(bad_crc)
    # IHDR's interlace byte set to Adam7 on a plain stream, its CRC
    # recomputed: read as seven passes, a pixel byte lands where a row's
    # filter type belongs
    data[28] = 1
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    with pytest.raises(ValueError, match="filter type"):
        png.decode(bytes(data))


def write_png(path: str, px: np.ndarray, ct: int, depth: int, interlace: bool = False, trns: bytes | None = None,
              plte: np.ndarray | None = None) -> None:
    """(H, W, channels) samples in the file's order (RGB) -> a PNG file of
    colour type ct, plain or Adam7 interlaced, with the rows of each pass
    filtered by a type drawn per row (0-4), and an optional tRNS / PLTE."""
    rng = np.random.default_rng(px.size)

    def filtered(rows: np.ndarray, bpp: int) -> bytes:
        out, prev = [], np.zeros(rows.shape[1], np.int64)
        for row in rows.astype(np.int64):
            left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
            upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
            t = int(rng.integers(0, 5))
            pred = [0, left, prev, (left + prev) // 2, paeth][t]
            out.append(bytes([t]) + ((row - pred) % 256).astype(np.uint8).tobytes())
            prev = row
        return b"".join(out)

    h, w, ch = px.shape
    raw = b""
    # Adam7's seven passes: (x0, y0, dx, dy) of the pixels each holds
    adam7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)]
    for x0, y0, dx, dy in adam7 if interlace else [(0, 0, 1, 1)]:
        sub = px[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        if depth >= 8:
            wide = np.ascontiguousarray(sub, ">u2" if depth == 16 else np.uint8)
            rows = wide.view(np.uint8).reshape(sub.shape[0], -1)
        else:
            bits = (sub[..., 0, None] >> np.arange(depth - 1, -1, -1)) & 1
            rows = np.packbits(bits.astype(np.uint8).reshape(sub.shape[0], -1), axis=1)
        raw += filtered(rows, max(1, ch * depth // 8))

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return struct.pack(">I", len(payload)) + kind + payload + struct.pack(">I", zlib.crc32(kind + payload))

    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ct, 0, 0, int(interlace)))
    if plte is not None:
        data += chunk(b"PLTE", plte.astype(np.uint8).tobytes())
    if trns is not None:
        data += chunk(b"tRNS", trns)
    with open(path, "wb") as f:
        f.write(data + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


#: (colour type, bit depth, interlaced, tRNS) of each case below
PNG_CASES = {
    "adam7_gray1": (0, 1, True, False), "adam7_gray4": (0, 4, True, False), "adam7_gray8": (0, 8, True, False),
    "adam7_gray16": (0, 16, True, False), "adam7_rgb8": (2, 8, True, False), "adam7_rgb16": (2, 16, True, False),
    "adam7_palette2": (3, 2, True, False), "adam7_palette8_trns": (3, 8, True, True),
    "adam7_gray_alpha8": (4, 8, True, False), "adam7_rgba16": (6, 16, True, False),
    "trns_gray8": (0, 8, False, True), "trns_gray16": (0, 16, False, True), "trns_gray2": (0, 2, False, True),
    "trns_rgb8": (2, 8, False, True), "trns_rgb16": (2, 16, False, True), "adam7_trns_rgb8": (2, 8, True, True),
}


@pytest.mark.parametrize("case", list(PNG_CASES))
def test_png_adam7_and_trns_equal_cv2(tmp_path, case):
    """Interlaced files and tRNS on grey or RGB files, as cv2 reads them:
    a grey file's tRNS is ignored, an RGB file's makes BGRA with alpha 0
    on the key colour; IMREAD_GRAYSCALE as for any other file."""
    ct, depth, interlace, with_trns = PNG_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ct]
    for h, w in ((1, 1), (3, 5), (8, 8), (13, 11), (33, 17), (480, 640)):
        plte = trns = None
        if ct == 3:
            n = min(1 << depth, 200)
            plte, px = rng.integers(0, 256, (n, 3)), rng.integers(0, n, (h, w, 1))
            trns = bytes(rng.integers(0, 256, min(n, 7)).astype(np.uint8)) if with_trns else None
        else:
            px = rng.integers(0, 1 << depth, (h, w, ch))
            if h > 8:  # a block of one colour, so that the key colour covers many pixels
                px[h // 3 : h // 2, w // 3 : w // 2] = px[h // 3, w // 3]
            if with_trns:
                trns = b"".join(struct.pack(">H", int(v)) for v in px[h // 3, w // 3])
        path = str(tmp_path / f"{case}_{h}x{w}.png")
        write_png(path, px, ct, depth, interlace, trns, plte)
        want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        got = png.imread(path)
        assert got.dtype == want.dtype and got.shape == want.shape, (h, w)
        np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w}")
        np.testing.assert_array_equal(png.imread(path, gray=True), cv2.imread(path, cv2.IMREAD_GRAYSCALE),
                                      err_msg=f"{h}x{w} grey")


def test_png_encode_read_back_by_cv2(tmp_path):
    for name, img in _images().items():
        path = str(tmp_path / f"{name}.png")
        png.imwrite(path, img)
        back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        assert back.dtype == img.dtype, name
        np.testing.assert_array_equal(back, img)
        np.testing.assert_array_equal(png.imread(path), img)


def test_png_helper_builds_into_the_build_dir():
    lib = png.LIBRARY.build()
    assert lib.parent == hostbuild.BUILD_DIR and lib.name.startswith("libpng_unfilter_")


SEQ = dict(n_frames=3, n_points=200, seed=4)


def _text_files(root: str) -> list:
    out = []
    for d, _, files in os.walk(root):
        out += [os.path.relpath(os.path.join(d, f), root) for f in files if not f.endswith(".png")]
    return sorted(out)


def _png_files(root: str) -> list:
    out = []
    for d, _, files in os.walk(root):
        out += [os.path.relpath(os.path.join(d, f), root) for f in files if f.endswith(".png")]
    return sorted(out)


def _same_trees(a: str, b: str) -> None:
    texts = _text_files(a)
    assert texts == _text_files(b) and texts
    for rel in texts:
        assert filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel), shallow=False), rel
    pngs = _png_files(a)
    assert pngs == _png_files(b) and pngs
    for rel in pngs:
        want = cv2.imread(os.path.join(a, rel), cv2.IMREAD_UNCHANGED)
        for path in (os.path.join(b, rel), os.path.join(a, rel)):
            np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), want)
            np.testing.assert_array_equal(png.imread(path), want)


def _same_camera(cam, ref_cam) -> None:
    for k in ("fx", "fy", "cx", "cy"):
        assert float(getattr(cam, k)) == float(getattr(ref_cam, k)), k
    assert (cam.width, cam.height, cam.bl) == (ref_cam.width, ref_cam.height, ref_cam.bl)
    np.testing.assert_array_equal(np.asarray(cam.dist, np.float32), np.asarray(ref_cam.dist))


def _same_gt(gt, ref_gt) -> None:
    assert (gt is None) == (ref_gt is None)
    if gt is not None:
        for a, b in zip(gt, ref_gt):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["tum", "tum_depth", "euroc", "kitti"])
def test_dataset_writers_and_readers_equal_reference(tmp_path, kind):
    depth_mode = "stereo" if kind in ("euroc", "kitti") else "mono"
    ref_seq, seq = RefSequence(**SEQ, depth_mode=depth_mode), SyntheticSequence(**SEQ, depth_mode=depth_mode)
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    if kind.startswith("tum"):
        ref.write_synthetic_tum(ref_seq, a, depth=kind == "tum_depth")
        datasets.write_synthetic_tum(seq, b, depth=kind == "tum_depth")
    elif kind == "euroc":
        ref.write_synthetic_euroc(ref_seq, a, stereo=True)
        datasets.write_synthetic_euroc(seq, b, stereo=True)
    else:
        ref.write_synthetic_kitti(ref_seq, a, stereo=True)
        datasets.write_synthetic_kitti(seq, b, stereo=True)
    _same_trees(a, b)
    assert datasets.detect_dataset_format(b) == ref.detect_dataset_format(a) == kind.split("_")[0]
    for root in (a, b):  # the port's readers on both trees, against the JAX readers on the JAX tree
        if kind.startswith("tum"):
            got, want = datasets.TumSequence.open(root), ref.TumSequence.open(a)
            assert (got.rgb, got.depth) == (want.rgb, want.depth)
            _same_gt(got.gt, want.gt)
            for i in range(len(want)):
                np.testing.assert_array_equal(got.read_rgb(i), want.read_rgb(i))
                if kind == "tum_depth":
                    d = got.read_depth_for(i)
                    assert d.dtype == np.uint16
                    np.testing.assert_array_equal(d, want.read_depth_for(i))
        elif kind == "euroc":
            got, want = datasets.EurocSequence.open(root, stereo=True), ref.EurocSequence.open(a, stereo=True)
            np.testing.assert_array_equal(got.stamps, want.stamps)
            assert [os.path.relpath(p, root) for p in got.files1] == [os.path.relpath(p, a) for p in want.files1]
            assert got.baseline == want.baseline
            _same_camera(got.camera(), want.camera())
            _same_gt(got.gt, want.gt)
            for i in range(len(want)):
                for c in (0, 1):
                    np.testing.assert_array_equal(got.read(i, c), want.read(i, c))
        else:
            got = datasets.KittiSequence.open(root, poses_file=os.path.join(root, "poses.txt"))
            want = ref.KittiSequence.open(a, poses_file=os.path.join(a, "poses.txt"))
            np.testing.assert_array_equal(got.stamps, want.stamps)
            np.testing.assert_array_equal(got.P0, want.P0)
            np.testing.assert_array_equal(got.P1, want.P1)
            _same_camera(got.camera(), want.camera())
            _same_gt(got.gt, want.gt)
            for i in range(len(want)):
                for c in (0, 1):
                    np.testing.assert_array_equal(got.read(i, c), want.read(i, c))


@pytest.mark.parametrize("kind", ["tum", "tum_depth", "euroc", "kitti"])
def test_dataset_writers_take_renders_made_elsewhere(tmp_path, kind):
    """Renders handed to a writer (as chip_smoke.write_tree hands it those of
    its process pool) give the tree the writer renders itself."""
    seq = SyntheticSequence(**SEQ, depth_mode="stereo" if kind in ("euroc", "kitti") else "mono")
    how = {"tum_depth": seq.render_with_depth, "tum": seq.render}.get(kind, seq.render_stereo)
    renders = [how(i) for i in range(seq.n_frames)]
    a, b = str(tmp_path / "own"), str(tmp_path / "given")
    if kind.startswith("tum"):
        datasets.write_synthetic_tum(seq, a, depth=kind == "tum_depth")
        datasets.write_synthetic_tum(seq, b, depth=kind == "tum_depth", renders=renders)
    elif kind == "euroc":
        datasets.write_synthetic_euroc(seq, a, stereo=True)
        datasets.write_synthetic_euroc(seq, b, stereo=True, renders=renders)
    else:
        datasets.write_synthetic_kitti(seq, a, stereo=True)
        datasets.write_synthetic_kitti(seq, b, stereo=True, renders=renders)
    _same_trees(a, b)


def test_trajectory_io_and_quaternions_equal_reference(tmp_path):
    rng = np.random.default_rng(5)
    seq = RefSequence(n_frames=6, n_points=100)
    poses = [seq.gt_pose(i) for i in range(6)]
    stamps = [i / 30.0 for i in range(6)]
    a, b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    ref.save_trajectory_tum(a, stamps, poses)
    datasets.save_trajectory_tum(b, stamps, poses)
    assert filecmp.cmp(a, b, shallow=False)
    for x, y in zip(datasets.load_trajectory_tum(b), ref.load_trajectory_tum(a)):
        np.testing.assert_array_equal(x, y)
    for _ in range(20):
        q = rng.normal(size=4)
        R = ref._quat_to_rot(q)
        np.testing.assert_array_equal(datasets._quat_to_rot(q), R)
        np.testing.assert_array_equal(datasets._rot_to_quat(R), ref._rot_to_quat(R))
    sa, sb = np.sort(rng.uniform(0, 2, 40)), np.sort(rng.uniform(0, 2, 30))
    for dt in (0.005, 0.02, 0.1):
        assert datasets.associate_trajectories(sa, sb, dt) == ref.associate_trajectories(sa, sb, dt)
    kitti = str(tmp_path / "poses.txt")
    with open(kitti, "w") as f:
        for P in poses:
            f.write(" ".join(f"{x:.6e}" for x in np.linalg.inv(P)[:3].reshape(-1)) + "\n")
    np.testing.assert_array_equal(datasets.load_kitti_poses(kitti), ref.load_kitti_poses(kitti))
    for x, y in zip(datasets.kitti_to_tum(ref.load_kitti_poses(kitti)), ref.kitti_to_tum(ref.load_kitti_poses(kitti))):
        np.testing.assert_array_equal(x, y)


def test_presets_and_format_detection_equal_reference(tmp_path):
    for kind in ("kitti", "euroc", "euroc_difficult", "spm", "tum", "KITTI", "other"):
        assert datasets.dataset_preset(kind) == ref.dataset_preset(kind)
    os.makedirs(tmp_path / "e" / "mav0" / "cam0")
    (tmp_path / "e" / "mav0" / "cam0" / "data.csv").write_text("")
    os.makedirs(tmp_path / "k" / "image_2")
    os.makedirs(tmp_path / "t")
    for d in ("e", "k", "t"):
        assert datasets.detect_dataset_format(str(tmp_path / d)) == ref.detect_dataset_format(str(tmp_path / d))
    sensor = tmp_path / "sensor.yaml"
    sensor.write_text("T_BS:\n  cols: 4\n  rows: 4\n  data: [1.0, 0.0, 0.0, 0.05, 0.0, 1.0, 0.0, 0.0,\n"
                      "    0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0]\nresolution: [752, 480]\n"
                      "intrinsics: [458.654, 457.296, 367.215, 248.375]\n"
                      "distortion_coefficients: [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]\n")
    got, want = datasets._parse_euroc_sensor_yaml(str(sensor)), ref._parse_euroc_sensor_yaml(str(sensor))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_pmvs_remap_runs_where_the_map_lives(tmp_path, monkeypatch):
    """export_pmvs undistorts each keyframe image on the map's device (a map
    on the card remaps there, not on the CPU), to cv2.undistort's pixels
    within 1 grey level away from the border, as the reference's cv2 call."""
    from ucoslam_tpu_torch.geometry.camera import CameraParams
    from ucoslam_tpu_torch.io import exporters
    from ucoslam_tpu_torch.io.serialize import load_map

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    m = load_map(os.path.join(repo, "data", "torch_port", "mono_map.slm"), "cpu")
    dist = [-0.2, 0.05, 0.001, -0.001, 0.0]
    cam = CameraParams.create(500.0, 500.0, 320.0, 240.0, dist=dist)
    rng = np.random.default_rng(1)
    img = cv2.GaussianBlur(rng.integers(0, 256, (480, 640), dtype=np.uint8), (0, 0), 3)
    devices = []
    inner = exporters.undistort_image

    def spy(im, c, **kw):  # the device must be passed: the default is the CPU
        devices.append(kw.get("device"))
        return inner(im, c, **kw)

    monkeypatch.setattr(exporters, "undistort_image", spy)
    fseq = int(m.h("kf_fseq")[m.keyframes.active_slots()][0])
    exporters.export_pmvs(m, cam, str(tmp_path / "pmvs"), images={fseq: img})
    assert len(devices) == 1 and devices[0] is not None and torch.device(devices[0]) == torch.device(m.device)
    got = cv2.imread(str(tmp_path / "pmvs" / "visualize" / "00000000.ppm"), cv2.IMREAD_UNCHANGED)
    want = cv2.undistort(img, np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]]), np.array(dist))
    assert np.abs(got.astype(int) - want)[20:-20, 20:-20].max() <= 1
