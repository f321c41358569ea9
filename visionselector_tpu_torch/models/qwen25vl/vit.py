"""Qwen2.5-VL vision tower.

Counterpart of ``visionselector_tpu.models.qwen25vl.vit``:

- the conv3d patch embed is one matmul over pre-flattened patches,
- the window permutation is applied on the host; each block picks the
  window or the per-image segment ids,
- rotary embeddings are computed from (h, w) position ids in fp32 and
  applied with rotate-half in the activation dtype,
- attention: window layers run the diag kernel on the window-aligned
  layout (the flash kernel with window bounds otherwise), full-attention
  layers the flash kernel with per-image bounds;
- ``attn_variant="fused"``: every layer hands the raw qkv slab to the
  fused rotary + attention kernel (window bounds for window layers, full
  bounds for full layers);
- heads zero-padded in the weights (``weights.pad_vit_head_dim``, d = 80
  padded to dp = 128) select the packed layout by themselves: window
  layers run the diag kernel at head dim dp, full layers the packed flash
  entry point on the slab's column views, all with the real d ** -0.5;
- ``vit_forward_stats`` (the training-free baselines' ViT): the default
  route, the last block through ``attention_with_received``, which also
  returns each key's received attention mass;
- W8A8 (``quantize_vit_params``): every block's five products take int8
  weights with per-channel scales and int8 activations quantized per token
  at run time, an int8 x int8 product accumulated in int32
  (``int8_matmul``: ``torch._int_mm`` on the card) and an fp32 epilogue
  (``_vit_dense``), under every attention route;
- ``vit_forward_sp``: the patch axis of the window-aligned layout split
  over the ranks of a mesh axis (window layers shard-local, full layers on
  all-gathered k / v).

Shapes: S = padded patch count, L = S / merge_unit merged tokens.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from visionselector_tpu_torch.core import collectives
from visionselector_tpu_torch.core.config import VisionConfig
from visionselector_tpu_torch.core.params import add_params, init_random_
from visionselector_tpu_torch.kernels.attention import (
    DIAG_BLOCK,
    attention,
    attention_diag,
    attention_packed,
    attention_with_received,
)
from visionselector_tpu_torch.kernels.fused_vit_attn import (  # noqa: F401
    apply_rotary,
    fused_vit_attention,
    rotate_half,  # also the decoder's (lm.py)
)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """fp32 statistics; the normalised value is cast to x's dtype BEFORE the
    scale multiply, as the reference does."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (scale * (xf * torch.rsqrt(var + eps)).to(x.dtype)).to(x.dtype)


def apply_rotary_padded(q, k, cos, sin, real_d: int):
    """Rotary for heads zero-padded in the weights: q, k [S, H, dp] with
    dp > real_d; cos/sin [S, real_d]. Rotate-half pairs channel i with
    i +- d/2 of the real d channels, written as a fixed channel permutation
    and a signed sin so the padded tail stays zero (cos' = 1, sin' = 0
    there); rounded where ``apply_rotary`` rounds."""
    s, _, dp = q.shape
    d, half = real_d, real_d // 2
    dev = q.device
    perm = torch.cat([torch.arange(half, d, device=dev),
                      torch.arange(half, device=dev),
                      torch.arange(d, dp, device=dev)])
    cos_pad = F.pad(cos[:, :d], (0, dp - d), value=1.0)
    sin_pad = torch.cat([-sin[:, :half], sin[:, half:d],
                         sin.new_zeros(s, dp - d)], dim=-1)
    cos_pad = cos_pad[:, None, :].to(q.dtype)
    sin_pad = sin_pad[:, None, :].to(q.dtype)
    return (q * cos_pad + q[..., perm] * sin_pad,
            k * cos_pad + k[..., perm] * sin_pad)


def vision_rotary_cos_sin(rot_pos_ids: torch.Tensor,
                          head_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h, w) position ids [S, 2] -> cos/sin [S, head_dim] fp32."""
    dim = head_dim // 2  # rotary channels before duplication
    inv_freq = 1.0 / (10000.0 ** (
        torch.arange(0, dim, 2, dtype=torch.float32,
                     device=rot_pos_ids.device) / dim))
    freqs = rot_pos_ids.float()[:, :, None] * inv_freq[None, None, :]
    freqs = freqs.reshape(rot_pos_ids.shape[0], -1)  # [S, dim] (h then w)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


class VisionBlock(nn.Module):
    """One ViT block's weights (kernels ``[in, out]``); ``dp`` is the
    attention head width in the weights (the head dim, or a zero-padded
    width, ``weights.pad_vit_head_dim``)."""

    def __init__(self, cfg: VisionConfig, device, dtype, dp=None):
        super().__init__()
        d, i = cfg.hidden_size, cfg.intermediate_size
        hp = cfg.num_heads * (dp or cfg.head_dim)  # padded q/k/v width
        add_params(self, {
            "norm1_scale": (d,), "norm2_scale": (d,),
            "qkv_kernel": (d, 3 * hp), "qkv_bias": (3 * hp,),
            "proj_kernel": (hp, d), "proj_bias": (d,),
            "gate_kernel": (d, i), "gate_bias": (i,),
            "up_kernel": (d, i), "up_bias": (i,),
            "down_kernel": (i, d), "down_bias": (d,),
        }, device, dtype)


class VisionTower(nn.Module):
    """Patch embed, ``depth`` blocks (heads ``dp`` wide in the weights,
    default the head dim) and the patch merger."""

    def __init__(self, cfg: VisionConfig, device, dtype, dp=None):
        super().__init__()
        self.cfg = cfg
        d, m = cfg.hidden_size, cfg.spatial_merge_unit
        add_params(self, {"patch_embed_kernel": (cfg.patch_dim, d)},
                   device, dtype)
        self.blocks = nn.ModuleList(
            VisionBlock(cfg, device, dtype, dp) for _ in range(cfg.depth))
        add_params(self, {
            "merger_ln_scale": (d,),
            "merger_fc1_kernel": (m * d, m * d),
            "merger_fc1_bias": (m * d,),
            "merger_fc2_kernel": (m * d, cfg.out_hidden_size),
            "merger_fc2_bias": (cfg.out_hidden_size,),
        }, device, dtype)

    def forward(self, *args, **kwargs):
        return vit_forward(self, *args, **kwargs)


def head_width(tower: VisionTower) -> int:
    """The attention head width in the weights: the head dim, or the
    zero-padded dp of ``weights.pad_vit_head_dim``."""
    return _qkv_width(tower.blocks[0]) // (3 * tower.cfg.num_heads)


def _qkv_width(p) -> int:
    """Columns of the qkv product (a quantized kernel's may be padded)."""
    if p.qkv_kernel.dtype == torch.int8:
        return p.qkv_kernel_scale.shape[0]
    return p.qkv_kernel.shape[-1]


def _block(x, p: VisionBlock, cos, sin, cfg: VisionConfig, attn_fn=None,
           fused_fn=None):
    """One ViT block: pre-RMSNorm attention + pre-RMSNorm SwiGLU MLP.

    ``fused_fn(qkv) -> [S, H*d]`` takes the raw qkv slab (rotary inside
    the fused kernel); otherwise the slab is viewed as q, k, v [S, H, dp]
    (dp detected from the qkv kernel: padded heads get the padded rotary)
    and ``attn_fn(q, k, v)`` gets them as [1, S, H, dp]. The five products
    go through ``_vit_dense`` on every route, so a W8A8 tower keeps them
    in int8 under "fused" too (the reference's fused branch multiplies the
    raw int8 proj / MLP kernels with no scale: ROADMAP section 3)."""
    h = rms_norm(x, p.norm1_scale, cfg.rms_norm_eps)
    s = h.shape[0]
    dp = _qkv_width(p) // (3 * cfg.num_heads)
    qkv = _vit_dense(h, p, "qkv_kernel")  # [S, 3*H*dp]
    if fused_fn is not None:
        attn = fused_fn(qkv)
    else:
        q, k, v = qkv.view(s, 3, cfg.num_heads, dp).unbind(1)
        if dp == cfg.head_dim:
            q, k = apply_rotary(q, k, cos, sin)
        else:
            q, k = apply_rotary_padded(q, k, cos, sin, cfg.head_dim)
        attn = attn_fn(q[None], k[None], v[None])[0]  # v read through strides
    x = x + _vit_dense(attn.reshape(s, -1), p, "proj_kernel")
    h = rms_norm(x, p.norm2_scale, cfg.rms_norm_eps)
    gate = _vit_dense(h, p, "gate_kernel")
    up = _vit_dense(h, p, "up_kernel")
    return x + _vit_dense(F.silu(gate) * up, p, "down_kernel")


# W8A8: the five block products that ``quantize_vit_params`` takes (the
# reference's VIT_QUANT_KERNELS); patch embed and merger stay in the model
# dtype.
VIT_QUANT_KERNELS = ("qkv_kernel", "proj_kernel", "gate_kernel",
                     "up_kernel", "down_kernel")
# ``torch._int_mm`` on the card takes widths that are multiples of 8: the
# stored int8 kernels are padded with zero rows / columns up to it.
INT8_ALIGN = 8
# ``torch._int_mm`` calls on CUDA tensors (the W8A8 products: 5 per block,
# 160 per 3B tower); calls on CPU tensors take the plain product and do
# not count.
INT_MM_LAUNCHES = 0


def _align(n: int) -> int:
    return -(-n // INT8_ALIGN) * INT8_ALIGN


def int8_matmul_plain(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain int8 x int8 product: int32 [M, N], exact."""
    return a.to(torch.int32) @ w.to(torch.int32)


def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 [M, K'] x int8 [K, N] -> int32 [M, N] (the reference's
    ``dot_general`` with an int32 accumulator). ``a``'s columns are padded
    with zeros up to K (a padded kernel's zero rows meet zero columns, so
    the product is unchanged bit for bit). On CUDA tensors one
    ``torch._int_mm`` (an int8 tensor-core GEMM; K and N must be multiples
    of 8, and M is padded to 17 rows where it has fewer); on CPU tensors
    ``int8_matmul_plain``."""
    global INT_MM_LAUNCHES
    if a.shape[1] < w.shape[0]:
        a = F.pad(a, (0, w.shape[0] - a.shape[1]))
    if a.device.type == "cpu":
        return int8_matmul_plain(a, w)
    m = a.shape[0]
    if m <= 16:  # _int_mm takes more than 16 rows
        a = F.pad(a, (0, 0, 0, 17 - m))
    INT_MM_LAUNCHES += 1
    return torch._int_mm(a, w)[:m]


def quantize_rows(x: torch.Tensor):
    """Per-token symmetric int8 of activations [M, K] (the reference's
    ``_vit_dense``): fp32 scale ``max(absmax / 127, 1e-12)`` per row,
    values rounded half to even and clipped to +-127. Returns (int8 [M, K],
    fp32 scales [M, 1])."""
    xf = x.float()
    xs = (xf.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-12)
    return torch.round(xf / xs).clamp(-127, 127).to(torch.int8), xs


def w8a8_epilogue(acc, x_scale, w_scale, bias, dtype):
    """``acc * x_scale * w_scale + bias`` in fp32, cast to ``dtype``: the
    reference's epilogue (``acc`` int32 [M, >= N] sliced to the N real
    columns)."""
    n = w_scale.shape[0]
    y = acc[:, :n].float() * x_scale * w_scale
    return (y + bias.float()).to(dtype)


def _vit_dense(x, p, name: str):
    """x [S, in] @ kernel + bias, or the W8A8 product when the kernel is
    int8 (``quantize_vit_params``): x quantized per token
    (``quantize_rows``), the int8 product accumulated in int32
    (``int8_matmul``), then ``w8a8_epilogue``. The quantize and the
    epilogue are plain torch ops."""
    w = getattr(p, name)
    b = getattr(p, name.replace("_kernel", "_bias"))
    if w.dtype != torch.int8:
        return x @ w + b
    xq, xs = quantize_rows(x)
    return w8a8_epilogue(int8_matmul(xq, w), xs,
                         getattr(p, name + "_scale"), b, x.dtype)


def is_vit_quantized(tower: VisionTower) -> bool:
    """Whether the tower's block products are W8A8 (int8 kernels)."""
    return tower.blocks[0].qkv_kernel.dtype == torch.int8


def register_vit_quantized(blk: nn.Module, name: str, q: torch.Tensor,
                           scale: torch.Tensor) -> None:
    """Put an int8 kernel [in, out] and its fp32 per-channel scales [out]
    on ``blk`` as the buffers ``name`` and ``name + "_scale"``, in place of
    the parameter ``name``. The stored kernel is padded with zero rows and
    columns up to multiples of ``INT8_ALIGN`` (``int8_matmul``'s widths;
    the ViT's MLP width, 3,420, is not one); ``q`` itself and the scales
    are stored as given, so ``vit_quantized_kernel`` gives back the
    reference's values. The kernel is kept column-major (an [in, out]
    view of a contiguous [out, in] tensor): ``torch._int_mm`` on the H100
    took 0.49 ms with a row-major [1,280, 3,840] operand at 6,144 rows and
    0.097 ms with a column-major one."""
    din, dout = q.shape
    padded = F.pad(q, (0, _align(dout) - dout, 0, _align(din) - din))
    blk._parameters.pop(name, None)
    blk.register_buffer(name, padded.t().contiguous().t())
    blk.register_buffer(name + "_scale", scale.float())


def vit_quantized_kernel(blk: nn.Module, name: str) -> torch.Tensor:
    """A W8A8 block kernel without its alignment padding: int8 [in, out]
    as ``quantize_vit_params`` computed it."""
    din = {"proj_kernel": _qkv_width(blk) // 3,
           "down_kernel": blk.up_kernel_scale.shape[0]}.get(
        name, blk.norm1_scale.shape[0])
    return getattr(blk, name)[:din, :getattr(blk, name + "_scale").shape[0]]


@torch.no_grad()
def quantize_vit_params(tower: VisionTower) -> VisionTower:
    """W8A8 ViT (the reference's ``quantize_vit_params``), in place: each
    block's ``VIT_QUANT_KERNELS`` become symmetric int8 with one scale per
    output channel, ``s = max(amax / 127, 1e-12)`` by true division and
    values ``clip(round(w / s), -127, 127)`` rounded half to even
    (``register_vit_quantized``). Activations are quantized per token at
    run time (``_vit_dense``). Patch embed and merger stay in the model
    dtype. Raises ValueError on a tower already quantized. Returns
    ``tower``."""
    if is_vit_quantized(tower):
        raise ValueError("quantize_vit_params: the tower is already W8A8")
    for blk in tower.blocks:
        for name in VIT_QUANT_KERNELS:
            wf = getattr(blk, name).float()
            scale = (wf.abs().amax(dim=0) / 127.0).clamp_min(1e-12)
            q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
            del wf
            register_vit_quantized(blk, name, q, scale)
    return tower


def vit_embed(tower: VisionTower, pixel_values: torch.Tensor) -> torch.Tensor:
    """Patch embedding: [S, patch_dim] -> [S, hidden]."""
    w = tower.patch_embed_kernel
    return pixel_values.to(w.dtype) @ w


def vit_merge(tower: VisionTower, x, reverse_index, cfg: VisionConfig):
    """PatchMerger: RMSNorm -> group merge_unit -> 2-layer exact-erf GELU
    MLP, then the permutation restoring the original merged order."""
    m = cfg.spatial_merge_unit
    h = rms_norm(x, tower.merger_ln_scale, cfg.rms_norm_eps)
    h = h.reshape(x.shape[0] // m, m * cfg.hidden_size)
    h = h @ tower.merger_fc1_kernel + tower.merger_fc1_bias
    h = F.gelu(h, approximate="none")
    h = h @ tower.merger_fc2_kernel + tower.merger_fc2_bias
    return h[reverse_index]


def vit_forward(
    tower: VisionTower,
    pixel_values: torch.Tensor,
    rot_pos_ids: torch.Tensor,
    window_seg_ids: torch.Tensor,
    full_seg_ids: torch.Tensor,
    reverse_index: torch.Tensor,
    window_kv_bounds: torch.Tensor | None = None,
    full_kv_bounds: torch.Tensor | None = None,
    window_diag: bool = False,
    window_kv_iters: int = 0,
    full_kv_iters: int = 0,
    attn_impl: str | None = None,
    attn_variant: str | None = None,
) -> torch.Tensor:
    """Vision tower forward.

    Args:
        pixel_values: [S, patch_dim] window-ordered, bucket-padded patches.
        rot_pos_ids: [S, 2] (h, w) ids in window order.
        window_seg_ids / full_seg_ids: [S] int32, 0 = padding.
        reverse_index: [L] permutation restoring original merged order.
        window_kv_bounds / full_kv_bounds: optional [S / 64, 2] kv-tile
            ranges of the flash kernel (``build_vision_batch``).
        window_diag: the batch uses the window-aligned layout; window layers
            then run the block-diagonal kernel.
        attn_impl: None (kernels on CUDA tensors) or "plain" (each kernel's
            plain version).
        attn_variant: None, or "fused": every layer runs the fused rotary +
            attention kernel on the qkv slab (heads padded in the weights
            do not fit it: ValueError). Padded heads select the packed
            layout by themselves.
    Returns:
        merged hidden states [L, out_hidden] in ORIGINAL (unpermuted) order.
    """
    x = vit_embed(tower, pixel_values)
    x = vit_forward_segment(
        tower, x, rot_pos_ids, window_seg_ids, full_seg_ids, 0,
        tower.cfg.depth, window_kv_bounds, full_kv_bounds, window_diag,
        window_kv_iters, full_kv_iters, attn_impl, attn_variant)
    return vit_merge(tower, x, reverse_index, tower.cfg)


def vit_forward_segment(
    tower: VisionTower,
    x: torch.Tensor,
    rot_pos_ids: torch.Tensor,
    window_seg_ids: torch.Tensor,
    full_seg_ids: torch.Tensor,
    lo: int,
    hi: int,
    window_kv_bounds: torch.Tensor | None = None,
    full_kv_bounds: torch.Tensor | None = None,
    window_diag: bool = False,
    window_kv_iters: int = 0,
    full_kv_iters: int = 0,
    attn_impl: str | None = None,
    attn_variant: str | None = None,
) -> torch.Tensor:
    """Tower blocks [lo, hi) on embedded hidden states x [S, hidden]: the
    block loop of ``vit_forward`` (which runs it over [0, depth)), so a
    tower run in consecutive segments makes the same launches per block and
    gives the same result. Chunked admission prefills run the tower in
    segments between serving decode chunks. Other arguments as
    ``vit_forward``'s."""
    if attn_variant not in (None, "fused"):
        raise ValueError(f"vit_forward: attn_variant must be None or "
                         f"'fused', got {attn_variant!r}")
    cfg = tower.cfg
    if not 0 <= lo <= hi <= cfg.depth:
        raise ValueError(f"vit_forward_segment: blocks [{lo}, {hi}) outside "
                         f"the {cfg.depth}-block tower")
    d, dp, heads = cfg.head_dim, head_width(tower), cfg.num_heads
    cos, sin = vision_rotary_cos_sin(rot_pos_ids, d)
    fns = _default_attn(tower, x.shape[0], window_seg_ids,
                        full_seg_ids, window_kv_bounds, full_kv_bounds,
                        window_diag, window_kv_iters, full_kv_iters,
                        attn_impl)
    if attn_variant == "fused":
        if dp != d:
            raise ValueError(
                f"vit_forward: the fused kernel takes unpadded heads, the "
                f"weights hold heads padded to {dp} (head dim {d})")
        cs = cos.to(x.dtype), sin.to(x.dtype)  # cast once for all layers

        def fused(seg, bounds):
            return dict(fused_fn=lambda qkv: fused_vit_attention(
                qkv, seg, *cs, bounds, heads, d, scale=d**-0.5,
                impl=attn_impl))

        fns = {False: fused(window_seg_ids, window_kv_bounds),
               True: fused(full_seg_ids, full_kv_bounds)}
    for i in range(lo, hi):
        x = _block(x, tower.blocks[i], cos, sin, cfg,
                   **fns[i in cfg.fullatt_block_indexes])
    return x


def _default_attn(tower: VisionTower, s_pad: int, window_seg_ids,
                  full_seg_ids, window_kv_bounds, full_kv_bounds,
                  window_diag: bool, window_kv_iters: int,
                  full_kv_iters: int, attn_impl) -> dict:
    """The default route's ``_block`` keywords, keyed by "is a full
    attention layer": window layers run the diag kernel on the
    window-aligned layout (the flash kernel with window bounds otherwise),
    full layers the flash kernel with per-image bounds (the packed entry
    point on padded heads)."""
    cfg = tower.cfg
    d, dp, heads = cfg.head_dim, head_width(tower), cfg.num_heads
    wseg, fseg = window_seg_ids[None], full_seg_ids[None]
    have_bounds = window_kv_bounds is not None and full_kv_bounds is not None
    if have_bounds:
        wblock = s_pad // window_kv_bounds.shape[0]

    def window_attn(q, k, v):
        if have_bounds and window_diag:
            return attention_diag(q, k, v, wseg, scale=d**-0.5,
                                  block_q=wblock, impl=attn_impl)
        return attention(q, k, v, wseg, wseg, scale=d**-0.5, impl=attn_impl,
                         kv_bounds=window_kv_bounds,
                         kv_iters=window_kv_iters or None)

    def full_attn(q, k, v):
        if dp != d:  # padded heads: the packed entry on [1, S, H*dp] views
            return attention_packed(
                q.flatten(2), k.flatten(2), v.flatten(2), fseg, fseg, heads,
                heads, dp, scale=d**-0.5, kv_bounds=full_kv_bounds,
                impl=attn_impl).unflatten(-1, (heads, dp))
        return attention(q, k, v, fseg, fseg, scale=d**-0.5, impl=attn_impl,
                         kv_bounds=full_kv_bounds,
                         kv_iters=full_kv_iters or None)

    return {False: dict(attn_fn=window_attn), True: dict(attn_fn=full_attn)}


def vit_forward_sp(
    tower: VisionTower,
    pixel_values: torch.Tensor,
    rot_pos_ids: torch.Tensor,
    window_seg_ids: torch.Tensor,
    full_seg_ids: torch.Tensor,
    reverse_index: torch.Tensor,
    mesh,
    axis: str = "model",
    attn_impl: str | None = None,
) -> torch.Tensor:
    """Sequence-parallel vision tower (the reference's ``vit_forward_sp``):
    the patch axis split over the ranks of the mesh's ``axis``, weights
    replicated. Every rank gets the whole window-aligned batch
    (``build_vision_batch(align_windows=True)``) and takes its contiguous
    S / n rows: a whole number of window slots, so the window layers (the
    diag kernel) and every norm and MLP are shard-local with no
    communication; the full-attention layers all-gather k, v and the
    full segment ids and run the flash kernel with the local queries
    against the gathered keys; the merger is local and the merged tokens
    are all-gathered before the un-permute. Returns the merged hidden
    states [L, out] in original order on every rank. ValueError unless
    S % (n * slot) == 0 (slot = the patches of one window; the reference
    asserts)."""
    cfg = tower.cfg
    n, i = mesh.size(axis), mesh.index(axis)
    group = mesh.groups[axis]
    s_pad = pixel_values.shape[0]
    win = cfg.window_size // cfg.spatial_merge_size // cfg.patch_size
    slot = win * win * cfg.spatial_merge_unit
    if s_pad % (n * slot):
        raise ValueError(f"vit_forward_sp: {s_pad} patches do not split "
                         f"into {n} shards of whole {slot}-patch window "
                         f"slots")
    local_s = s_pad // n
    rows = slice(i * local_s, (i + 1) * local_s)
    wseg, fseg = window_seg_ids[rows], full_seg_ids[rows]
    d = cfg.head_dim
    block = DIAG_BLOCK if local_s % DIAG_BLOCK == 0 else slot

    def window_attn(q, k, v):
        return attention_diag(q, k, v, wseg[None], scale=d**-0.5,
                              block_q=block, impl=attn_impl)

    def full_attn(q, k, v):
        kg = collectives.all_gather(k, group, dim=1)
        vg = collectives.all_gather(v, group, dim=1)
        sg = collectives.all_gather(fseg, group)
        return attention(q, kg, vg, fseg[None], sg[None], scale=d**-0.5,
                         impl=attn_impl)

    fns = {False: dict(attn_fn=window_attn), True: dict(attn_fn=full_attn)}
    x = vit_embed(tower, pixel_values[rows])
    cos, sin = vision_rotary_cos_sin(rot_pos_ids[rows], d)
    for j, blk in enumerate(tower.blocks):
        x = _block(x, blk, cos, sin, cfg,
                   **fns[j in cfg.fullatt_block_indexes])
    merged = vit_merge(tower, x, slice(None), cfg)
    return collectives.all_gather(merged, group)[reverse_index]


def vit_forward_stats(
    tower: VisionTower,
    pixel_values: torch.Tensor,
    rot_pos_ids: torch.Tensor,
    window_seg_ids: torch.Tensor,
    full_seg_ids: torch.Tensor,
    reverse_index: torch.Tensor,
    window_kv_bounds: torch.Tensor | None = None,
    full_kv_bounds: torch.Tensor | None = None,
    window_diag: bool = False,
    window_kv_iters: int = 0,
    full_kv_iters: int = 0,
    attn_impl: str | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ViT forward that also returns the last block's attention statistics
    (the reference's ``vit_forward_stats``), which the training-free
    baselines read: VisionZip, PruMerge+ and HoloV take the last block's
    attention map and keys.

    Blocks 0 .. depth-2 take ``vit_forward``'s default route; the last
    block's attention is ``attention_with_received`` (plain blocked fp32:
    the reference computes it outside any Pallas kernel). Arguments as
    ``vit_forward``'s.

    Returns:
        (merged hidden [L, out] in original order,
         attn_received [L] fp32: mean attention mass received per merged
             token (mean over heads and valid queries, 4 -> 1 pooled,
             unpermuted),
         pooled_keys [L, H * dp] fp32: the last block's post-rotary keys,
             heads concatenated, 4 -> 1 pooled, unpermuted; zero pad
             channels of padded heads stay zero).
    """
    cfg = tower.cfg
    d = cfg.head_dim
    x = vit_embed(tower, pixel_values)
    cos, sin = vision_rotary_cos_sin(rot_pos_ids, d)
    fns = _default_attn(tower, pixel_values.shape[0], window_seg_ids,
                        full_seg_ids, window_kv_bounds, full_kv_bounds,
                        window_diag, window_kv_iters, full_kv_iters,
                        attn_impl)
    for i, blk in enumerate(tower.blocks[:-1]):
        x = _block(x, blk, cos, sin, cfg,
                   **fns[i in cfg.fullatt_block_indexes])
    last = cfg.depth - 1
    seg = full_seg_ids if last in cfg.fullatt_block_indexes else \
        window_seg_ids
    captured = {}

    def stats_attn(q, k, v):
        out, captured["recv"] = attention_with_received(
            q[0], k[0], v[0], seg, scale=d**-0.5)
        captured["k"] = k[0]
        return out[None]

    x = _block(x, tower.blocks[-1], cos, sin, cfg, attn_fn=stats_attn)
    s, m = x.shape[0], cfg.spatial_merge_unit
    recv = captured["recv"].reshape(-1, m).mean(dim=1)  # [L] window order
    keys = captured["k"].reshape(s // m, m, -1).float().mean(dim=1)
    return (vit_merge(tower, x, reverse_index, cfg), recv[reverse_index],
            keys[reverse_index])


def init_vit_params(cfg: VisionConfig, generator: torch.Generator, device,
                    dtype) -> VisionTower:
    """Random init with the reference's scales (std 0.02, norms ones)."""
    tower = VisionTower(cfg, device, dtype)
    init_random_(tower, generator, std=0.02)
    return tower
