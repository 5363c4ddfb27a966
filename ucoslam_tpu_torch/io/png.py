"""PNG decode and encode without cv2, for the dataset readers and writers.

The JAX package reads and writes every image with cv2, which the card's
machine lacks. This module decodes what cv2 decodes, in cv2's layout:

- `decode` / `imread(path)` give what `cv2.imread(path, IMREAD_UNCHANGED)`
  gives: (H, W) for grey, (H, W, 3) BGR for RGB and palette files, (H, W, 4)
  BGRA for RGBA, grey-alpha (the grey replicated) and palette files with a
  tRNS chunk; uint8, or uint16 for 16-bit files (big-endian in the file);
  grey files of 1, 2 or 4 bits are scaled to 0-255, palette indices of 1, 2
  or 4 bits expanded. A tRNS chunk makes a palette file BGRA (the chunk's
  alphas) and an RGB file BGRA (alpha 0 where a pixel equals the chunk's
  colour, else the largest sample); on a grey file cv2 ignores it.
- `imread(path, gray=True)` gives what `IMREAD_GRAYSCALE` gives: uint8;
  colour becomes (9797 R + 19234 G + 3737 B) >> 15, libpng's
  `png_set_rgb_to_gray` with OpenCV's weights 0.299 / 0.587 (the rest
  blue) in 1/32768 units, truncated at 8 bits and rounded (+16384) at 16;
  16-bit results keep their high byte. On the files tests/test_torch_io.py
  writes with cv2 this equals cv2 exactly, grey and colour.

Colour types 0, 2, 3, 4 and 6 are read, plain or Adam7 interlaced (each of
the seven passes unfiltered as an image of its own, then scattered into
place). The chunks' CRCs are checked. The stream is inflated with `zlib`;
the rows are unfiltered by `csrc/host/png_unfilter.cpp` (Sub, Average and
Paeth each depend on the byte just reconstructed to their left, which numpy
cannot vectorise along a row), built with g++ at the first decode
(`utils/hostbuild.py`); a failed build raises.

`encode` / `imwrite` write grey (H, W), BGR (H, W, 3) or BGRA (H, W, 4)
arrays of uint8 or uint16 with filter type 0 on every row, compressed by
`zlib`: the writers' needs, and what cv2 reads back as the same array.
"""

from __future__ import annotations

import ctypes
import functools
import struct
import zlib
from dataclasses import dataclass

import numpy as np

from ucoslam_tpu_torch.utils import hostbuild

SIGNATURE = b"\x89PNG\r\n\x1a\n"
LIBRARY = hostbuild.HostLibrary("png_unfilter", hostbuild.HOST_DIR / "png_unfilter.cpp")
#: samples per pixel of each colour type
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
#: libpng's rgb_to_gray weights for OpenCV's 0.299 / 0.587, in 1/32768
GRAY_R, GRAY_G, GRAY_B = 9797, 19234, 3737
#: the encoder's zlib level: on a rendered 640x480 grey frame ~6x faster than
#: level 9 for 12% more bytes
ZLIB_LEVEL = 3


#: Adam7's passes: (x0, y0, dx, dy) of the pixels each pass holds
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


@dataclass(frozen=True)
class PngInfo:
    width: int
    height: int
    bit_depth: int
    color_type: int
    interlace: int


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (if needed) and load the unfilter library; cached per process."""
    lib = ctypes.CDLL(str(LIBRARY.build()))
    lib.png_unfilter.restype = ctypes.c_int
    lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    return lib


def _chunks(data: bytes):
    """Yield (type, payload) of each chunk, its CRC checked."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n : pos + 12 + n])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG stream ends before IEND")


def _ihdr(payload: bytes) -> PngInfo:
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", payload)
    return PngInfo(w, h, depth, ctype, interlace)


def read_info(path: str) -> PngInfo:
    """The header of a PNG file, without decoding it."""
    with open(path, "rb") as f:
        head = f.read(33)
    if head[:8] != SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    return _ihdr(head[16:29])


def _unfilter(raw: bytes, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    if len(raw) < height * (rowbytes + 1):
        raise ValueError(f"PNG image data holds {len(raw)} bytes, {height * (rowbytes + 1)} needed")
    src = np.frombuffer(raw, np.uint8)
    out = np.empty((height, rowbytes), np.uint8)
    rc = _library().png_unfilter(src.ctypes.data, out.ctypes.data, height, rowbytes, bpp)
    if rc != 0:
        raise ValueError(f"PNG row {-rc - 1} has an unknown filter type")
    return out


def _unpack(rows: np.ndarray, width: int, depth: int) -> np.ndarray:
    """(H, rowbytes) packed samples of `depth` < 8 bits -> (H, W) uint8."""
    bits = np.unpackbits(rows, axis=1)[:, : width * depth].reshape(rows.shape[0], width, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1).astype(np.uint8)


def _samples(raw: bytes, w: int, h: int, ch: int, depth: int) -> tuple[np.ndarray, bytes]:
    """Filtered rows of a w x h image at the head of `raw` -> its (h, w, ch)
    samples (uint8, or uint16 at 16 bits; sub-byte samples unpacked, not
    scaled), and the bytes after them."""
    rowbytes = (w * ch * depth + 7) // 8
    rows = _unfilter(raw, h, rowbytes, max(1, ch * depth // 8))
    if depth == 16:
        px = rows.view(">u2").astype(np.uint16).reshape(h, w, ch)
    elif depth == 8:
        px = rows.reshape(h, w, ch)
    else:
        px = _unpack(rows, w, depth)[..., None]
    return px, raw[h * (rowbytes + 1) :]


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> array in cv2.imread(IMREAD_UNCHANGED)'s layout."""
    info, plte, trns, idat = None, None, None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            info = _ihdr(payload)
        elif kind == b"PLTE":
            plte = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = payload
        elif kind == b"IDAT":
            idat.append(payload)
    if info is None:
        raise ValueError("PNG without IHDR")
    ct, depth, w, h = info.color_type, info.bit_depth, info.width, info.height
    if ct not in CHANNELS:
        raise ValueError(f"PNG colour type {ct} does not exist")
    if info.interlace not in (0, 1):
        raise ValueError(f"PNG interlace method {info.interlace} does not exist")
    if depth not in (8, 16) and not (ct in (0, 3) and depth in (1, 2, 4)):
        raise ValueError(f"PNG colour type {ct} at {depth} bits")
    ch = CHANNELS[ct]
    raw = zlib.decompress(b"".join(idat))
    if info.interlace:
        px = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
        for x0, y0, dx, dy in ADAM7:
            pw, ph = max(0, -(-(w - x0) // dx)), max(0, -(-(h - y0) // dy))
            if pw and ph:  # an empty pass has no rows in the stream
                px[y0::dy, x0::dx], raw = _samples(raw, pw, ph, ch, depth)
    else:
        px, _ = _samples(raw, w, h, ch, depth)
    if ct == 0 and depth < 8:
        px = px * np.uint8(255 // ((1 << depth) - 1))
    if ct == 3:
        if plte is None:
            raise ValueError("palette PNG without PLTE")
        rgb = plte[px[..., 0]]
        if trns is not None:
            alpha = np.full(len(plte), 255, np.uint8)
            alpha[: len(trns)] = np.frombuffer(trns, np.uint8)[: len(plte)]
            return np.ascontiguousarray(np.dstack([rgb[..., ::-1], alpha[px[..., 0]]]))
        return np.ascontiguousarray(rgb[..., ::-1])
    if ct == 0:  # cv2 ignores a tRNS chunk on a grey file
        return np.ascontiguousarray(px[..., 0])
    if ct == 4:  # grey-alpha: cv2 gives BGRA with the grey replicated
        g, a = px[..., 0], px[..., 1]
        return np.ascontiguousarray(np.stack([g, g, g, a], -1))
    if ct == 2:
        bgr = px[..., ::-1]
        if trns is None:
            return np.ascontiguousarray(bgr)
        # the chunk's colour (three 16-bit samples, R G B) is transparent
        key = np.array(struct.unpack(">HHH", trns[:6]), np.uint32)
        opaque = np.iinfo(px.dtype).max
        alpha = np.where((px.astype(np.uint32) == key).all(-1), 0, opaque).astype(px.dtype)
        return np.ascontiguousarray(np.dstack([bgr, alpha]))
    return np.ascontiguousarray(px[..., [2, 1, 0, 3]])


def to_gray(img: np.ndarray) -> np.ndarray:
    """A decoded array -> cv2's IMREAD_GRAYSCALE of the same file (uint8)."""
    wide = img.dtype == np.uint16
    if img.ndim == 3:
        b, g, r = (img[..., i].astype(np.int64) for i in range(3))
        # libpng truncates 8-bit sums and rounds 16-bit ones
        img = (GRAY_R * r + GRAY_G * g + GRAY_B * b + (16384 if wide else 0)) >> 15
    return (img >> 8 if wide else img).astype(np.uint8)


def imread(path: str, gray: bool = False) -> np.ndarray:
    """cv2.imread(path, IMREAD_GRAYSCALE if gray else IMREAD_UNCHANGED) for
    a PNG file; raises where cv2 would return None."""
    with open(path, "rb") as f:
        img = decode(f.read())
    return to_gray(img) if gray else img


def encode(img: np.ndarray) -> bytes:
    """Grey (H, W), BGR (H, W, 3) or BGRA (H, W, 4) uint8 / uint16 -> PNG
    bytes (filter type 0, zlib at ZLIB_LEVEL)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG samples must be uint8 or uint16, not {img.dtype}")
    if img.ndim == 2:
        ct, px = 0, img[..., None]
    elif img.ndim == 3 and img.shape[2] == 3:
        ct, px = 2, img[..., ::-1]
    elif img.ndim == 3 and img.shape[2] == 4:
        ct, px = 6, img[..., [2, 1, 0, 3]]
    else:
        raise ValueError(f"cannot write an image of shape {img.shape} as PNG")
    h, w = img.shape[:2]
    depth = 16 if img.dtype == np.uint16 else 8
    body = np.ascontiguousarray(px, ">u2" if depth == 16 else np.uint8).view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), body], axis=1)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return struct.pack(">I", len(payload)) + kind + payload + struct.pack(">I", zlib.crc32(kind + payload))

    return (SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ct, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), ZLIB_LEVEL)) + chunk(b"IEND", b""))


def imwrite(path: str, img: np.ndarray) -> None:
    """Write `img` (see `encode`) to `path`."""
    with open(path, "wb") as f:
        f.write(encode(img))
