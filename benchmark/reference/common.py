"""Pieces both plain references share: host preprocessing, M-RoPE ids,
norms, rotary, dense attention and the fp8 arithmetic of the control.

Everything here is plain PyTorch or NumPy in float32 (TF32 is switched off
by ``fp32_matmul``). It imports nothing of the program under test: the
preprocessing and the position ids are written again from the published
semantics (Qwen2.5-VL's processor and ``get_rope_index``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float64)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float64)
FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def fp32_matmul():
    """Float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# -- host preprocessing (the processor's semantics) ------------------------

def smart_resize(height: int, width: int, factor: int, min_pixels: int,
                 max_pixels: int):
    """Both sides multiples of ``factor``, the area within the bounds, the
    aspect ratio kept (qwen-vl-utils ``smart_resize``)."""
    h_bar = max(factor, round(height / factor) * factor)
    w_bar = max(factor, round(width / factor) * factor)
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt(height * width / max_pixels)
        h_bar = max(factor, math.floor(height / beta / factor) * factor)
        w_bar = max(factor, math.floor(width / beta / factor) * factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def _bilinear(image: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize of an (H, W, C) float64 array, half-pixel centres."""
    in_h, in_w = image.shape[:2]
    ys = (np.arange(out_h) + 0.5) * in_h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * in_w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, in_h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, in_w - 1)
    y1 = np.clip(y0 + 1, 0, in_h - 1)
    x1 = np.clip(x0 + 1, 0, in_w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    top = image[y0][:, x0] * (1 - wx) + image[y0][:, x1] * wx
    bot = image[y1][:, x0] * (1 - wx) + image[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def resize_uint8(image: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """The processor's resize of an RGB uint8 array: PIL bicubic where PIL
    imports (what the HF processor does), else bilinear in float64."""
    if image.shape[:2] == (out_h, out_w):
        return image.astype(np.float64)
    try:
        from PIL import Image
    except ImportError:
        return _bilinear(image.astype(np.float64), out_h, out_w)
    return np.asarray(Image.fromarray(image).resize((out_w, out_h),
                                                    Image.BICUBIC),
                      np.float64)


def patchify(image: np.ndarray, patch: int, temporal: int, merge: int,
             min_pixels: int, max_pixels: int):
    """uint8 (H, W, 3) -> (pixel rows [t * h * w, 3 * temporal * p * p]
    float32 in merge-block order, grid (t, h, w)): resize, rescale to
    [0, 1], normalise by CLIP's mean and std, cut into patches."""
    h0, w0 = image.shape[:2]
    out_h, out_w = smart_resize(h0, w0, patch * merge, min_pixels, max_pixels)
    x = (resize_uint8(image, out_h, out_w) / 255.0 - CLIP_MEAN) / CLIP_STD
    x = x.transpose(2, 0, 1)[None]  # (1, C, H, W)
    x = np.repeat(x, temporal, axis=0)  # one image fills the temporal patch
    gh, gw = out_h // patch, out_w // patch
    x = x.reshape(1, temporal, 3, gh // merge, merge, patch, gw // merge,
                  merge, patch)
    x = x.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    rows = x.reshape(gh * gw, 3 * temporal * patch * patch)
    return rows.astype(np.float32), (1, gh, gw)


def merge_block_ids(gh: int, gw: int, merge: int) -> np.ndarray:
    """(h, w) of every patch of a (gh, gw) grid in merge-block order."""
    hh = np.broadcast_to(np.arange(gh)[:, None], (gh, gw))
    ww = np.broadcast_to(np.arange(gw)[None, :], (gh, gw))

    def blocks(a):
        return a.reshape(gh // merge, merge, gw // merge, merge).transpose(
            0, 2, 1, 3).reshape(-1)

    return np.stack([blocks(hh), blocks(ww)], axis=-1)


def mrope_ids(ids: np.ndarray, grid, merge: int, image_token: int):
    """Qwen2.5-VL's 3-axis position ids of a prompt with one image block:
    text runs count up on all three axes, the image's merged tokens get
    (start, start + row, start + col) with start one past the text before
    it. Returns (ids [3, T] int64, rope delta = max + 1 - T)."""
    ids = np.asarray(ids)
    t_len = len(ids)
    where = np.where(ids == image_token)[0]
    if len(where) == 0:
        pos = np.tile(np.arange(t_len), (3, 1))
        return pos.astype(np.int64), 0
    first, n = int(where[0]), len(where)
    _, gh, gw = grid
    mh, mw = gh // merge, gw // merge
    if mh * mw != n or where[-1] != first + n - 1:
        raise ValueError("one contiguous image block of the grid's size")
    parts = [np.tile(np.arange(first), (3, 1))]
    hh = np.repeat(np.arange(mh), mw)
    ww = np.tile(np.arange(mw), mh)
    parts.append(np.stack([np.zeros(n, np.int64), hh, ww]) + first)
    after = t_len - first - n
    start = first + max(mh, mw)
    parts.append(np.tile(np.arange(after), (3, 1)) + start)
    pos = np.concatenate(parts, axis=1).astype(np.int64)
    return pos, int(pos.max() + 1 - t_len)


# -- layers ----------------------------------------------------------------

class Linear:
    """y = x W^T + b with W in the HF layout [out, in], in float32, or in
    the control's fp8 (weights per output row, inputs per row, both
    scaled to the e4m3 range and rounded, the product taken in float32)."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def __call__(self, x, w, b=None):
        w = w.float()
        if self.fp8:
            w = fp8_round(w, dim=1)
            x = fp8_round(x, dim=-1)
        y = x @ w.t()
        return y if b is None else y + b.float()


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 at a scale per slice along ``dim``
    (the slice's largest |value| maps to 448), returned in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = FP8_MAX / amax
    return (x * scale).to(FP8).float() / scale


def rms_norm(x, w, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def layer_norm(x, w, b, eps: float):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w.float() + b.float()


def rotate_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def rotary(x, cos, sin):
    """x [S, H, D], cos / sin [S, D]."""
    return x * cos[:, None] + rotate_half(x) * sin[:, None]


def attention(q, k, v, allowed):
    """Softmax attention of q [S, Hq, D] over k, v [S', Hkv, D] (grouped
    heads repeat k / v), ``allowed`` [S, S'] bool. Float32, one dense
    score matrix per call."""
    hq, hkv, d = q.shape[1], k.shape[1], q.shape[2]
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) * d ** -0.5
    s = s.masked_fill(~allowed[None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,khd->qhd", p, v)


def block_diagonal(seg: torch.Tensor) -> torch.Tensor:
    """[S, S] bool: rows and columns of the same segment."""
    return seg[:, None] == seg[None, :]


def causal(n: int, device) -> torch.Tensor:
    r = torch.arange(n, device=device)
    return r[:, None] >= r[None, :]
