"""RICE ViT, the LLaVA-OneVision-1.5 vision tower.

Counterpart of ``visionselector_tpu.models.llava_ov15.rice``:

- the conv2d patch embed (temporal patch 1) is one matmul over flattened
  patches,
- a learned CLS row is inserted at the start of every image (or video
  frame) segment and stripped after the blocks; the host builds the two
  gather maps (``build_rice_batch``), the device does two gathers. The CLS
  row carries a learned rotary frequency row (``class_pos_emb``) in place
  of position-derived ones,
- LayerNorm with bias, exact-erf GELU fc1 / fc2 MLP, a pre-LayerNorm before
  the blocks, no windows: every block's attention is the flash kernel
  (non-causal, segment-masked, head dim 64 at full width) with kv-tile
  bounds built at its 64-row tile,
- ``rice_forward_stats`` (the training-free baselines' tower): the last
  block's attention through ``attention_with_received``.

Shapes: S = padded patch count, S' = S + CLS slots (rounded up to the
kernel's tile when ``build_rice_batch(tile=...)`` asks), L = S / 4.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from visionselector_tpu_torch.core.config import RiceVisionConfig
from visionselector_tpu_torch.core.params import add_params, init_random_
from visionselector_tpu_torch.kernels.attention import (
    FLASH_BLOCK,
    attention,
    attention_with_received,
    segment_block_bounds,
)
from visionselector_tpu_torch.kernels.fused_vit_attn import apply_rotary
from visionselector_tpu_torch.preprocess.indices import (
    full_attn_cu_seqlens,
    vision_rot_pos_ids,
)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """fp32 statistics and affine, cast back to x's dtype at the end (as
    the reference does)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


@dataclasses.dataclass
class RiceBatch:
    """Host-built inputs of one RICE forward."""

    pixel_values: np.ndarray  # [S_pad, patch_dim] float32
    rot_pos_ids: np.ndarray  # [S_pad, 2]
    # [S'_pad]: patch index, S_pad (the CLS row) or S_pad + 1 (a zero row)
    insert_map: np.ndarray
    strip_map: np.ndarray  # [S_pad]: row of patch i in the CLS'd sequence
    seg_ids: np.ndarray  # [S'_pad] int32 segments of the CLS'd sequence
    # [S'_pad / 64, 2] kv-tile bounds at the flash kernel's tile, or None
    # when S'_pad is not a multiple of it
    kv_bounds: Optional[np.ndarray]
    grid_thw: np.ndarray
    num_patches: int
    num_merged: int


def build_rice_batch(pixel_values: np.ndarray, grid_thw: np.ndarray,
                     spatial_merge_size: int = 2,
                     pad_to: Optional[int] = None,
                     cls_slots: Optional[int] = None,
                     tile: Optional[int] = None) -> RiceBatch:
    """The CLS insert / strip maps and per-image segments (the reference's
    maps: equal to them when ``tile`` is None).

    ``tile``: round S' = pad_to + cls_slots up to a multiple of it with
    zero rows of segment 0 (the flash kernel's bounds need whole 64-row
    tiles; rows of segment 0 are attended by nothing and come out zero, so
    the merged output does not change)."""
    s_real = int(pixel_values.shape[0])
    g = np.asarray(grid_thw)
    cu = full_attn_cu_seqlens(g)  # per-image (per-frame) patch boundaries
    n_seg = len(cu) - 1
    s_pad = pad_to if pad_to is not None else s_real
    if s_pad < s_real:
        raise ValueError(f"pad_to {s_pad} < {s_real} patches")
    cls_slots = cls_slots if cls_slots is not None else n_seg
    if cls_slots < n_seg:
        raise ValueError(f"{cls_slots} CLS slots for {n_seg} segments")
    sp_pad = s_pad + cls_slots
    cls, pad = s_pad, s_pad + 1  # sentinel rows of the gather buffer
    insert_map = np.full(sp_pad, pad, np.int64)
    strip_map = np.zeros(s_pad, np.int64)
    seg = np.zeros(sp_pad, np.int32)
    w = 0
    for i in range(n_seg):
        a, b = int(cu[i]), int(cu[i + 1])
        insert_map[w] = cls
        seg[w] = i + 1
        strip_map[a:b] = np.arange(w + 1, w + 1 + (b - a))
        insert_map[w + 1:w + 1 + (b - a)] = np.arange(a, b)
        seg[w + 1:w + 1 + (b - a)] = i + 1
        w += 1 + (b - a)
    # padding patches strip from a dead row (the last, segment 0)
    strip_map[s_real:] = sp_pad - 1 if w < sp_pad else w - 1
    if tile:
        extra = -sp_pad % tile
        insert_map = np.concatenate([insert_map, np.full(extra, pad)])
        seg = np.concatenate([seg, np.zeros(extra, np.int32)])
    pad_rows = s_pad - s_real
    return RiceBatch(
        pixel_values=np.pad(pixel_values.astype(np.float32),
                            ((0, pad_rows), (0, 0))),
        rot_pos_ids=np.pad(vision_rot_pos_ids(g, spatial_merge_size),
                           ((0, pad_rows), (0, 0))),
        insert_map=insert_map, strip_map=strip_map, seg_ids=seg,
        kv_bounds=(segment_block_bounds(seg, FLASH_BLOCK, FLASH_BLOCK)
                   if len(seg) % FLASH_BLOCK == 0 else None),
        grid_thw=g, num_patches=s_real,
        num_merged=s_real // (spatial_merge_size**2))


class RiceBlock(nn.Module):
    """One RICE block's weights (kernels ``[in, out]``)."""

    def __init__(self, cfg: RiceVisionConfig, device, dtype):
        super().__init__()
        d, i = cfg.hidden_size, cfg.intermediate_size
        add_params(self, {
            "norm1_scale": (d,), "norm1_bias": (d,),
            "norm2_scale": (d,), "norm2_bias": (d,),
            "qkv_kernel": (d, 3 * d), "qkv_bias": (3 * d,),
            "proj_kernel": (d, d), "proj_bias": (d,),
            "fc1_kernel": (d, i), "fc1_bias": (i,),
            "fc2_kernel": (i, d), "fc2_bias": (d,),
        }, device, dtype)


class RiceTower(nn.Module):
    """Patch embed, CLS row and its rotary row (fp32), pre-LayerNorm,
    ``depth`` blocks, the 2x2 merger."""

    def __init__(self, cfg: RiceVisionConfig, device, dtype):
        super().__init__()
        self.cfg = cfg
        d, m, o = cfg.hidden_size, cfg.spatial_merge_unit, cfg.text_hidden_size
        add_params(self, {"patch_embed_kernel": (cfg.patch_dim, d),
                          "class_embedding": (d,)}, device, dtype)
        add_params(self, {"class_pos_emb": (cfg.head_dim // 2,)}, device,
                   torch.float32)
        add_params(self, {"pre_ln_scale": (d,), "pre_ln_bias": (d,)},
                   device, dtype)
        self.blocks = nn.ModuleList(
            RiceBlock(cfg, device, dtype) for _ in range(cfg.depth))
        add_params(self, {
            "merger_ln_scale": (d,), "merger_ln_bias": (d,),
            "merger_fc1_kernel": (m * d, m * d), "merger_fc1_bias": (m * d,),
            "merger_fc2_kernel": (m * d, o), "merger_fc2_bias": (o,),
        }, device, dtype)


def _embed(tower: RiceTower, pixel_values, rot_pos_ids, insert_map):
    """Patch embed, CLS insertion and the rotary tables, then the
    pre-LayerNorm: (x [S', D], cos, sin [S', head_dim] fp32)."""
    cfg = tower.cfg
    w = tower.patch_embed_kernel
    patches = pixel_values.to(w.dtype) @ w  # [S, D]
    s_pad, d = patches.shape
    dim = cfg.head_dim // 2
    inv_freq = 1.0 / (10000.0 ** (torch.arange(
        0, dim, 2, dtype=torch.float32, device=w.device) / dim))
    freqs = (rot_pos_ids.float()[:, :, None] * inv_freq).reshape(s_pad, -1)
    patch_buf = torch.cat([patches, tower.class_embedding[None],
                           patches.new_zeros(1, d)])  # [S + 2, D]
    freq_buf = torch.cat([freqs, tower.class_pos_emb.float()[None],
                          freqs.new_zeros(1, dim)])
    x = patch_buf[insert_map]
    f = freq_buf[insert_map]
    emb = torch.cat([f, f], dim=-1)
    x = layer_norm(x, tower.pre_ln_scale, tower.pre_ln_bias,
                   cfg.layer_norm_eps)
    return x, torch.cos(emb), torch.sin(emb)


def _block(x, p: RiceBlock, cos, sin, cfg: RiceVisionConfig, attn_fn):
    """Pre-LN attention + pre-LN GELU MLP; ``attn_fn(q, k, v)`` takes the
    rotated [S', H, d] q, k and v."""
    h = layer_norm(x, p.norm1_scale, p.norm1_bias, cfg.layer_norm_eps)
    s = h.shape[0]
    qkv = h @ p.qkv_kernel + p.qkv_bias
    q, k, v = qkv.view(s, 3, cfg.num_heads, cfg.head_dim).unbind(1)
    q, k = apply_rotary(q, k, cos, sin)
    x = x + attn_fn(q, k, v).reshape(s, -1) @ p.proj_kernel + p.proj_bias
    h = layer_norm(x, p.norm2_scale, p.norm2_bias, cfg.layer_norm_eps)
    h = F.gelu(h @ p.fc1_kernel + p.fc1_bias, approximate="none")
    return x + h @ p.fc2_kernel + p.fc2_bias


def _merge(tower: RiceTower, x):
    """LayerNorm -> 4 patches per row -> fc1, exact GELU, fc2."""
    cfg = tower.cfg
    m = cfg.spatial_merge_unit
    h = layer_norm(x, tower.merger_ln_scale, tower.merger_ln_bias,
                   cfg.layer_norm_eps)
    h = h.reshape(x.shape[0] // m, m * cfg.hidden_size)
    h = F.gelu(h @ tower.merger_fc1_kernel + tower.merger_fc1_bias,
               approximate="none")
    return h @ tower.merger_fc2_kernel + tower.merger_fc2_bias


def _flash_attn(seg_ids, kv_bounds, d: int, attn_impl):
    def attn(q, k, v):
        return attention(q[None], k[None], v[None], seg_ids[None],
                         seg_ids[None], scale=d**-0.5, impl=attn_impl,
                         kv_bounds=kv_bounds)[0]
    return attn


def rice_forward(tower: RiceTower, pixel_values: torch.Tensor,
                 rot_pos_ids: torch.Tensor, insert_map: torch.Tensor,
                 strip_map: torch.Tensor, seg_ids: torch.Tensor,
                 kv_bounds: Optional[torch.Tensor] = None,
                 attn_impl: Optional[str] = None) -> torch.Tensor:
    """RICE forward -> merged tokens [L_pad, text_hidden] in patch order.
    The inputs are a ``RiceBatch``'s arrays on the device; every block's
    attention is the flash kernel on CUDA tensors (``attn_impl="plain"``:
    its plain version)."""
    x, cos, sin = _embed(tower, pixel_values, rot_pos_ids, insert_map)
    attn = _flash_attn(seg_ids, kv_bounds, tower.cfg.head_dim, attn_impl)
    for blk in tower.blocks:
        x = _block(x, blk, cos, sin, tower.cfg, attn)
    return _merge(tower, x[strip_map])


def rice_forward_stats(tower: RiceTower, pixel_values: torch.Tensor,
                       rot_pos_ids: torch.Tensor, insert_map: torch.Tensor,
                       strip_map: torch.Tensor, seg_ids: torch.Tensor,
                       kv_bounds: Optional[torch.Tensor] = None,
                       attn_impl: Optional[str] = None):
    """``rice_forward`` that also returns the last block's attention
    statistics (the ViT-side baselines read them): blocks 0 .. depth-2 as
    ``rice_forward``, the last through ``attention_with_received`` (plain
    blocked fp32, as the reference computes it outside any Pallas kernel).

    Returns (merged [L_pad, text_hidden], attn_received [L_pad] fp32 pooled
    4 -> 1 in patch order, pooled keys [L_pad, H * d] fp32)."""
    cfg = tower.cfg
    d = cfg.head_dim
    x, cos, sin = _embed(tower, pixel_values, rot_pos_ids, insert_map)
    attn = _flash_attn(seg_ids, kv_bounds, d, attn_impl)
    for blk in tower.blocks[:-1]:
        x = _block(x, blk, cos, sin, cfg, attn)
    captured = {}

    def stats_attn(q, k, v):
        out, captured["recv"] = attention_with_received(q, k, v, seg_ids,
                                                        scale=d**-0.5)
        captured["k"] = k
        return out

    x = _block(x, tower.blocks[-1], cos, sin, cfg, stats_attn)
    s_pad, m = strip_map.shape[0], cfg.spatial_merge_unit
    recv = captured["recv"][strip_map].reshape(-1, m).mean(dim=1)
    keys = captured["k"].reshape(x.shape[0], -1).float()[strip_map]
    keys = keys.reshape(s_pad // m, m, -1).mean(dim=1)
    return _merge(tower, x[strip_map]), recv, keys


@torch.no_grad()
def init_rice_params(cfg: RiceVisionConfig, generator: torch.Generator,
                     device, dtype) -> RiceTower:
    """Random init with the reference's scales: std 0.02 for kernels, ones
    / zeros for norm scales / biases, the CLS row std d ** -0.5 and its
    rotary row std 1 (fp32)."""
    tower = RiceTower(cfg, device, dtype)
    init_random_(tower, generator, std=0.02)
    tower.class_embedding.normal_(0.0, cfg.hidden_size**-0.5,
                                  generator=generator)
    tower.class_pos_emb.normal_(0.0, 1.0, generator=generator)
    return tower
