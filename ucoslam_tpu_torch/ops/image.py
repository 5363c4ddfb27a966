"""Whole-image ops: gray conversion, Gaussian blur, pyramid, patches, sampling.

Port of `ucoslam_tpu/ops/image.py`. Images are (H, W) float32 tensors. The
pyramid resizes every level directly from level 0 with the same anti-aliased
triangle-filter matrices as the reference, as two float32 matmuls (TF32 must
be off on the card, see `slam/system.py`), into one packed buffer
(`Pyramid`): the detector's kernels read every level from it in one launch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    r = np.arange(ksize) - (ksize - 1) / 2.0
    k = np.exp(-(r * r) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur with reflect-101 borders, as shifted-slice sums."""
    k = gaussian_kernel1d(ksize, sigma)
    pad = ksize // 2
    h, w = img.shape
    p = F.pad(img[None, None], (0, 0, pad, pad), mode="reflect")[0, 0]
    tmp = sum(float(k[i]) * p[i : i + h, :] for i in range(ksize))
    p = F.pad(tmp[None, None], (pad, pad, 0, 0), mode="reflect")[0, 0]
    return sum(float(k[i]) * p[:, i : i + w] for i in range(ksize))


def pyramid_shapes(h: int, w: int, n_levels: int, scale_factor: float):
    """Static per-level (H_l, W_l) sizes, reference-compatible rounding."""
    shapes = []
    for lv in range(n_levels):
        s = 1.0 / (scale_factor**lv)
        shapes.append((int(round(h * s)), int(round(w * s))))
    return shapes


@functools.lru_cache(maxsize=64)
def _resize_weight_mat(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) anti-aliased triangle-kernel interpolation matrix (the same
    matrix as the reference, i.e. jax.image.resize 'linear', antialias).
    Cached per size pair; callers must not modify it."""
    scale = out_size / in_size
    kernel_scale = max(1.0, 1.0 / scale)
    sample_f = (np.arange(out_size) + 0.5) / scale - 0.5
    x = np.abs(sample_f[:, None] - np.arange(in_size)[None, :]) / kernel_scale
    weights = np.maximum(0.0, 1.0 - x)
    total = weights.sum(axis=1, keepdims=True)
    weights = np.where(np.abs(total) > 1e-6, weights / total, 0.0)
    in_span = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(in_span[:, None], weights, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _resize_weight_mat_f32(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) the weight matrix jax.image.resize(..., "linear") builds,
    in its own float32 arithmetic and order (jax's compute_weight_mat): its
    sample positions round in float32, so far from the origin its weights
    part from the float64 matrix of `_resize_weight_mat` by ~3e-5. Cached
    per size pair; callers must not modify it."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.0) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, f32(1.0)), f32(0.0))
    in_span = (sample_f >= f32(-0.5)) & (sample_f <= f32(in_size - 0.5))
    return np.ascontiguousarray(np.where(in_span[None, :], weights, f32(0.0)).T.astype(f32))


@functools.lru_cache(maxsize=64)
def resize_matrices(in_shape: tuple[int, int], out_shape: tuple[int, int], device, jax_f32: bool = False):
    """(rows (oh, h), columns (ow, w)): the anti-aliased resize matrices
    from in_shape to out_shape on `device` (`_resize_weight_mat`, or with
    jax_f32 `_resize_weight_mat_f32`), uploaded once per shapes and device.
    Callers must not modify them."""
    build = _resize_weight_mat_f32 if jax_f32 else _resize_weight_mat
    (h, w), (oh, ow) = in_shape, out_shape
    return tuple(torch.from_numpy(build(i, o)).to(device) for i, o in ((h, oh), (w, ow)))


def resize_linear(img: torch.Tensor, out_shape: tuple[int, int]) -> torch.Tensor:
    """jax.image.resize(img, out_shape, "linear") (antialiased when it
    shrinks), as two float32 matmuls with its own weight matrices: the
    detector-resolution scaling of the reference's frame ingest."""
    ah, aw = resize_matrices(tuple(img.shape), tuple(out_shape), img.device, jax_f32=True)
    return (ah @ img) @ aw.T


class Pyramid:
    """The levels of an (h, w) image on one device: their shapes, where each
    lies in the packed buffer (row-major, level after level), and the
    resize matrices of levels 1 and up (`resize_matrices`)."""

    def __init__(self, h: int, w: int, n_levels: int, scale_factor: float, device):
        self.shapes = pyramid_shapes(h, w, n_levels, scale_factor)
        self.offsets = [0]
        for lh, lw in self.shapes:
            self.offsets.append(self.offsets[-1] + lh * lw)
        self.weights = [None if s == (h, w) else resize_matrices((h, w), s, device) for s in self.shapes]

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        """(h, w) float32 -> the packed levels, (sum of h_l * w_l,) float32;
        level 0 is the image, each other level two matmuls from it."""
        buf = torch.empty(self.offsets[-1], dtype=torch.float32, device=img.device)
        for lv, wts in enumerate(self.weights):
            out = self.level(buf, lv)
            if wts is None:
                out.copy_(img)
            else:
                torch.matmul(wts[0] @ img, wts[1].T, out=out)
        return buf

    def level(self, buf: torch.Tensor, lv: int) -> torch.Tensor:
        """Level lv of a packed buffer, as an (h_l, w_l) view."""
        return buf[self.offsets[lv] : self.offsets[lv + 1]].view(self.shapes[lv])


def extract_patches(img: torch.Tensor, xy: torch.Tensor, radius: int) -> torch.Tensor:
    """(N, 2r+1, 2r+1) square patches centred at rounded xy, clamped so the
    patch stays inside the image (a plain 2-D gather)."""
    P = 2 * radius + 1
    h, w = img.shape
    y0 = (torch.round(xy[:, 1]).long() - radius).clamp(0, h - P)
    x0 = (torch.round(xy[:, 0]).long() - radius).clamp(0, w - P)
    offs = torch.arange(P, device=img.device)
    gy = y0[:, None, None] + offs[None, :, None]
    gx = x0[:, None, None] + offs[None, None, :]
    return img[gy, gx]


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """BGR (H, W, 3) or gray (H, W) -> grayscale float32 (H, W), OpenCV
    BGR2GRAY weights."""
    img = img.to(torch.float32)
    if img.ndim == 2:
        return img
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    return 0.114 * b + 0.587 * g + 0.299 * r


def bilinear_sample(img: torch.Tensor, xy: torch.Tensor, mode: str = "nearest") -> torch.Tensor:
    """Sample an (H, W) image at continuous (..., 2) locations (x = column,
    y = row) -> (...); or a stack of B images (B, H, W) at (B, ..., 2), each
    image at its own locations. `nearest` rounds half to even and clips to
    the image; `bilinear` clips the top-left neighbour to [0, W-2] x
    [0, H-2] and the weights to [0, 1], as the reference does."""
    h, w = img.shape[-2:]
    x, y = xy[..., 0], xy[..., 1]
    if img.ndim == 3:
        b = torch.arange(img.shape[0], device=img.device).reshape((-1,) + (1,) * (x.ndim - 1))

        def at(yy, xx):
            return img[b, yy, xx]
    else:

        def at(yy, xx):
            return img[yy, xx]
    if mode == "nearest":
        return at(torch.round(y).long().clamp(0, h - 1), torch.round(x).long().clamp(0, w - 1))
    x0 = torch.floor(x).long().clamp(0, w - 2)
    y0 = torch.floor(y).long().clamp(0, h - 2)
    fx = (x - x0).clamp(0.0, 1.0)
    fy = (y - y0).clamp(0.0, 1.0)
    v00, v01 = at(y0, x0), at(y0, x0 + 1)
    v10, v11 = at(y0 + 1, x0), at(y0 + 1, x0 + 1)
    return v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy) + v10 * (1 - fx) * fy + v11 * fx * fy
