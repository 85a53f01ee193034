"""Image preprocessing: counterpart of `mllm_tpu/processor/image.py`.

The host steps (decode, resize, normalize, patchify, `smart_resize`, the
CLIP and Qwen2-VL processors, PIL's bicubic coefficients and the I420
encoder) are numpy copies of the JAX package's. The device steps,
`device_resize_bicubic` and `yuv420_to_rgb`, are torch versions that run on
the tensors' device (the card in the fused image prefill).

Two divergences, on purpose:
  - `resize` always takes PIL: the JAX package first tries its native
    OpenMP copy of PIL's resampler (`mllm_tpu/utils/native`), which the port
    does not carry (its results are PIL's bit for bit);
  - PIL is imported where an image is decoded or resized on the host, not
    at import: the H100 machine's Python may have no PIL, and the model
    paths that take uint8 frames (the coefficient resize on the device)
    do not need it.
"""

from __future__ import annotations

import io
import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch


def _pil():
    """PIL.Image, imported on first use (RuntimeError where it is missing)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("PIL is not installed: decode and resize images on the host with it, or "
                           "pass uint8 frames and resize on the device (device_resize_bicubic)") from e
    return Image


# OpenAI CLIP normalization constants (reference ClipPreProcess / HF)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def load_image(src) -> np.ndarray:
    """Path/bytes/PIL/array -> RGB uint8 [H, W, 3]."""
    if isinstance(src, np.ndarray):
        return src
    Image = _pil()  # noqa: N806
    if isinstance(src, (bytes, bytearray)):
        img = Image.open(io.BytesIO(src))
    elif hasattr(src, "convert"):
        img = src
    else:
        img = Image.open(src)
    return np.asarray(img.convert("RGB"))


def resize(img: np.ndarray, height: int, width: int, resample: str = "bicubic") -> np.ndarray:
    """uint8/float [H, W, C] -> resized by PIL (the JAX package's native
    resampler, bit-equal to PIL, is not carried over)."""
    Image = _pil()  # noqa: N806
    rs = {"bicubic": Image.BICUBIC, "bilinear": Image.BILINEAR, "nearest": Image.NEAREST}[resample]
    pil = Image.fromarray(img.astype(np.uint8) if img.dtype != np.uint8 else img)
    return np.asarray(pil.resize((width, height), rs))


def resize_shortest_edge(img: np.ndarray, size: int, resample: str = "bicubic") -> np.ndarray:
    h, w = img.shape[:2]
    if h < w:
        nh, nw = size, max(1, round(w * size / h))
    else:
        nh, nw = max(1, round(h * size / w)), size
    return resize(img, nh, nw, resample)


def center_crop(img: np.ndarray, height: int, width: int) -> np.ndarray:
    h, w = img.shape[:2]
    top = (h - height) // 2
    left = (w - width) // 2
    if top < 0 or left < 0:  # pad then crop (HF semantics)
        out = np.zeros((max(h, height), max(w, width), img.shape[2]), img.dtype)
        t0 = (out.shape[0] - h) // 2
        l0 = (out.shape[1] - w) // 2
        out[t0 : t0 + h, l0 : l0 + w] = img
        img, (h, w) = out, out.shape[:2]
        top = (h - height) // 2
        left = (w - width) // 2
    return img[top : top + height, left : left + width]


def rescale_normalize(img: np.ndarray, mean: Sequence[float], std: Sequence[float],
                      scale: float = 1 / 255.0) -> np.ndarray:
    x = img.astype(np.float32) * scale
    return (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


@dataclass
class ClipImageProcessor:
    """CLIP/ViT pipeline (reference ClipPreProcess.cpp): shortest-edge resize
    -> center crop -> rescale+normalize -> CHW float."""

    size: int = 224
    crop: int = 224
    mean: tuple = CLIP_MEAN
    std: tuple = CLIP_STD
    resample: str = "bicubic"

    def __call__(self, images) -> np.ndarray:
        if not isinstance(images, (list, tuple)):
            images = [images]
        out = []
        for im in images:
            x = load_image(im)
            x = resize_shortest_edge(x, self.size, self.resample)
            x = center_crop(x, self.crop, self.crop)
            x = rescale_normalize(x, self.mean, self.std)
            out.append(x.transpose(2, 0, 1))  # CHW
        return np.stack(out)  # [B, 3, H, W]


# ---------------------------------------------------------------------------
# Qwen2-VL (processing_qwen2_vl.hpp:67-77,84-179)
# ---------------------------------------------------------------------------

IMAGE_FACTOR = 28
MIN_PIXELS = 4 * 28 * 28
MAX_PIXELS = 16384 * 28 * 28
MAX_RATIO = 200


def smart_resize(height: int, width: int, factor: int = IMAGE_FACTOR,
                 min_pixels: int = MIN_PIXELS, max_pixels: int = MAX_PIXELS) -> tuple[int, int]:
    """Qwen2-VL pixel-budgeted resize to multiples of `factor`."""
    if max(height, width) / min(height, width) > MAX_RATIO:
        raise ValueError(f"aspect ratio must be < {MAX_RATIO}")
    round_by = lambda v, f: round(v / f) * f
    floor_by = lambda v, f: math.floor(v / f) * f
    ceil_by = lambda v, f: math.ceil(v / f) * f
    h_bar = max(factor, round_by(height, factor))
    w_bar = max(factor, round_by(width, factor))
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = floor_by(height / beta, factor)
        w_bar = floor_by(width / beta, factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = ceil_by(height * beta, factor)
        w_bar = ceil_by(width * beta, factor)
    return h_bar, w_bar


@dataclass
class Qwen2VLImageProcessor:
    """smart_resize -> normalize -> 3D patchify (temporal=2, patch=14, merge=2).

    Returns (patches [grid_t*grid_h*grid_w, C*tps*ps*ps], grid_thw (t, h, w))
    — exactly the reference's convertPatches layout
    (processing_qwen2_vl.hpp:119-179), which feeds Conv3d as a matmul.
    """

    patch_size: int = 14
    temporal_patch_size: int = 2
    merge_size: int = 2
    mean: tuple = CLIP_MEAN
    std: tuple = CLIP_STD
    min_pixels: int = MIN_PIXELS
    max_pixels: int = MAX_PIXELS
    # (H, W) to resize EVERY image to (aspect ratio not preserved).  Serving
    # mode: one fixed grid, so every request's vision tower and admission
    # run at one shape.
    fixed_resolution: Optional[tuple] = None

    def __call__(self, images) -> tuple[np.ndarray, tuple[int, int, int]]:
        if not isinstance(images, (list, tuple)):
            images = [images]
        frames = []
        for im in images:
            x = load_image(im)
            h, w = x.shape[:2]
            if self.fixed_resolution is not None:
                nh, nw = self.fixed_resolution
                f = self.patch_size * self.merge_size
                if nh % f or nw % f:
                    raise ValueError(f"fixed_resolution must be a multiple of {f}")
            else:
                nh, nw = smart_resize(h, w, IMAGE_FACTOR, self.min_pixels, self.max_pixels)
            x = resize(x, nh, nw, "bicubic")
            x = rescale_normalize(x, self.mean, self.std)
            frames.append(x.transpose(2, 0, 1))  # CHW
        pixel = np.stack(frames)  # [T, C, H, W]
        if pixel.shape[0] % self.temporal_patch_size != 0:
            # repeat last frame (single images: T=1 -> 2)
            reps = self.temporal_patch_size - pixel.shape[0] % self.temporal_patch_size
            pixel = np.concatenate([pixel, np.repeat(pixel[-1:], reps, axis=0)])
        return self.patchify(pixel)

    def patchify(self, pixel: np.ndarray) -> tuple[np.ndarray, tuple[int, int, int]]:
        t, c, h, w = pixel.shape
        ps, tps, ms = self.patch_size, self.temporal_patch_size, self.merge_size
        grid_t, grid_h, grid_w = t // tps, h // ps, w // ps
        x = pixel.reshape(grid_t, tps, c, grid_h // ms, ms, ps, grid_w // ms, ms, ps)
        x = x.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
        patches = x.reshape(grid_t * grid_h * grid_w, c * tps * ps * ps)
        return np.ascontiguousarray(patches, np.float32), (grid_t, grid_h, grid_w)


# ---------------------------------------------------------------------------
# On-device bicubic resize (PIL-weight-exact, two matmuls)
# ---------------------------------------------------------------------------


def bicubic_coeff_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense [out_size, in_size] f32 resampling matrix with PIL's EXACT
    coefficient pipeline (Pillow Resample.c precompute_coeffs +
    normalize_coeffs_8bpc: float bicubic(a=-0.5) -> /sum -> round to
    2^-22 fixed-point).  Row i of the matrix is output pixel i's kernel.

    Used by device_resize_bicubic: resize becomes two small matmuls on the
    card, so the only host work for image prefill is the raw-frame upload."""
    precision = 1 << (32 - 8 - 2)
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale

    def bicubic(x):
        a = -0.5
        x = abs(x)
        if x < 1.0:
            return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
        if x < 2.0:
            return (((x - 5.0) * x + 8.0) * x - 4.0) * a
        return 0.0

    m = np.zeros((out_size, in_size), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        w = np.array([bicubic((x - center + 0.5) / filterscale)
                      for x in range(xmin, xmax)])
        s = w.sum()
        if s != 0.0:
            w = w / s
        # PIL quantizes the normalized weights to int/2^22 (half away from 0)
        wq = np.where(w < 0, np.ceil(w * precision - 0.5), np.floor(w * precision + 0.5))
        m[xx, xmin:xmax] = wq / precision
    return m.astype(np.float32)


def device_resize_bicubic(img: torch.Tensor, v_coeff: torch.Tensor, h_coeff: torch.Tensor) -> torch.Tensor:
    """uint8 [..., H, W, C] -> uint8 [..., oh, ow, C], PIL-bicubic semantics,
    on img's device (JAX `device_resize_bicubic`).

    v_coeff [oh, H], h_coeff [ow, W] from bicubic_coeff_matrix (f32 tensors
    on the same device). PIL's two fixed-point passes (horizontal, then
    vertical, each rounding to uint8 with +0.5 and clipping) in f32: the
    weights are PIL's bit for bit, the f32 sums differ from its int32 ones by
    at most 1 u8 LSB on a few pixels."""
    x = img.float()
    x = torch.einsum("ow,...hwc->...hoc", h_coeff.float(), x)  # horizontal pass
    x = torch.clamp(torch.floor(x + 0.5), 0.0, 255.0)  # PIL clip8 after pass 1
    x = torch.einsum("oh,...hwc->...owc", v_coeff.float(), x)  # vertical pass
    return torch.clamp(torch.floor(x + 0.5), 0.0, 255.0).to(torch.uint8)


# ---------------------------------------------------------------------------
# YUV 4:2:0 camera wire format (halves the host->device frame payload)
# ---------------------------------------------------------------------------


def rgb_to_yuv420(img: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """uint8 RGB [H, W, 3] -> planar I420 (y [H, W], u/v [H/2, W/2]) uint8.

    BT.601 full-range (the JPEG/JFIF convention cameras and decoders emit);
    chroma is the 2x2 box mean.  H and W must be even.  Real camera stacks
    deliver frames in exactly this layout at 1.5 bytes/pixel, so shipping
    I420 over the host->device link is both HALF the RGB payload and the
    more faithful serving wire format; the inverse (`yuv420_to_rgb`) runs
    on device inside the fused image-prefill program.
    """
    h, w, _ = img.shape
    if h % 2 or w % 2:
        raise ValueError(f"I420 needs even dims, got {h}x{w}")
    # one BLAS GEMM for the color rotation (the bench host is 1-core; the
    # elementwise form costs ~15 array passes, this costs one)
    m = np.array([[0.299, -0.168736, 0.5],
                  [0.587, -0.331264, -0.418688],
                  [0.114, 0.5, -0.081312]], np.float32)
    yuv = img.reshape(-1, 3).astype(np.float32) @ m  # [H*W, 3]
    yuv = yuv.reshape(h, w, 3)
    y = yuv[..., 0]
    u = 128.0 + yuv[..., 1].reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
    v = 128.0 + yuv[..., 2].reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
    to8 = lambda a: np.clip(np.floor(a + 0.5), 0, 255).astype(np.uint8)
    return to8(y), to8(u), to8(v)


def yuv420_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Planar I420 -> uint8 RGB [..., H, W, 3] on the planes' device (JAX
    `yuv420_to_rgb`): y [..., H, W], u / v [..., H/2, W/2]; BT.601 full
    range, nearest chroma upsample, the inverse of `rgb_to_yuv420`."""
    yf = y.float()
    uf = u.float().repeat_interleave(2, -2).repeat_interleave(2, -1) - 128.0
    vf = v.float().repeat_interleave(2, -2).repeat_interleave(2, -1) - 128.0
    r = yf + 1.402 * vf
    g = yf - 0.344136 * uf - 0.714136 * vf
    b = yf + 1.772 * uf
    rgb = torch.stack([r, g, b], dim=-1)
    return torch.clamp(torch.floor(rgb + 0.5), 0.0, 255.0).to(torch.uint8)
