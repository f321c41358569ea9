"""Fused ViT attention: rotary and multi-head flash attention from the slab.

Counterpart of ``visionselector_tpu.kernels.fused_vit_attn``. The kernel
(``csrc/fused_vit_attn_fwd.cu``) takes the qkv projection slab [S, 3*H*d]
as it comes out of the matmul and makes two launches per call: a rotary
prologue writes rotated q, rotated k and transposed v as per-tile images
laid out the way Hopper's ``wgmma`` reads shared memory (3 x H x S x dp
bf16 of scratch, dp = d rounded up to 16) plus ``tile_seg``, a segment id
per 64-row tile (-1 where the tile's rows differ); the main kernel runs each
head's segment-masked online-softmax attention over the kv tiles of the
bounds and writes [S, H*d], ready for the proj matmul.

``fused_plain`` is the plain PyTorch version of the same function
(``apply_rotary``, then ``flash_plain``); CPU tensors take it, CUDA
tensors launch the kernels (or raise). ``FUSED_LAUNCHES`` counts wrapper
calls (two launches each). ``prologue_plain``, ``pack_tiles`` /
``unpack_tiles`` and ``tile_seg_plain`` (from ``tiles.py``, which the
flash route shares) are the plain versions of the prologue's outputs.
Bounds are built at the kernel's 64-row tile (``FLASH_BLOCK``), as for the
flash kernel. The main loop is the flash route's (``csrc/wgmma_attn.cuh``).
``rotate_half`` /
``apply_rotary`` live here because the kernel's rounding is defined by
them; the ViT imports them.
"""

from __future__ import annotations

import torch

from visionselector_tpu_torch.kernels.attention import (
    FLASH_BLOCK,
    KERNEL_HEAD_DIMS,
    _on_cpu,
    _seg_i32,
    flash_plain,
)
from visionselector_tpu_torch.kernels.tiles import (  # noqa: F401
    _from_image,
    _to_image,
    pack_tiles,
    padded_head_dim,
    tile_seg_plain,
    unpack_tiles,
)

FUSED_LAUNCHES = 0


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary(q, k, cos, sin):
    """q, k: [S, H, D]; cos/sin: [S, D] fp32. The rotation runs in the
    activation dtype (cos/sin cast to it first; each product and the sum
    rounded to it), as the fused kernel does (the decoder's M-RoPE runs in
    fp32)."""
    cos = cos[:, None, :].to(q.dtype)
    sin = sin[:, None, :].to(q.dtype)
    return q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin


def fused_plain(qkv, seg, cos, sin, kv_bounds, num_heads, head_dim,
                scale=None):
    """Plain PyTorch version of the fused kernel: split the slab, rotate q
    and k, ``flash_plain`` with the bounds. qkv [S, 3*H*d]; seg [S];
    cos/sin [S, d]; kv_bounds [ceil(S/64), 2] or None. Returns [S, H*d]."""
    s = qkv.shape[0]
    q, k, v = qkv.view(s, 3, num_heads, head_dim).unbind(1)
    q, k = apply_rotary(q, k, cos, sin)
    out = flash_plain(q[None], k[None], v[None], seg[None], seg[None],
                      scale=scale, kv_bounds=kv_bounds)
    return out[0].reshape(s, num_heads * head_dim)


def prologue_plain(qkv, cos, sin, num_heads: int, head_dim: int):
    """Plain version of the rotary prologue: the (q, k, v^T) tile images
    of the slab, q and k rotated by ``apply_rotary``."""
    s = qkv.shape[0]
    q, k, v = qkv.view(s, 3, num_heads, head_dim).unbind(1)
    q, k = apply_rotary(q, k, cos, sin)
    return pack_tiles(q), pack_tiles(k), pack_tiles(v, transpose=True)


def _check_width(qkv, num_heads: int, head_dim: int):
    width = qkv.shape[1]
    if width != 3 * num_heads * head_dim:
        raise ValueError(
            f"fused_vit_attention: qkv width {width} != 3 x {num_heads} "
            f"heads x {head_dim} (heads padded in the weights do not fit "
            f"the fused kernel)")


def _launch(qkv, seg, cos, sin, kv_bounds, num_heads: int, head_dim: int,
            scale: float, phases: int = 3, scratch=None, tile_seg=None):
    """Check the inputs and launch the kernels on CUDA tensors (the caller
    counts the call). ``phases``: 1 the rotary prologue, 2 the attention
    main loop (on ``scratch`` that a prologue filled), 3 both. Returns
    (out [S, H*d], scratch = (q_img, k_img, vt_img, tile_seg)). ``tile_seg``
    replaces the prologue's tile segment ids before the main loop; only
    the card tests pass it, to plant a fault."""
    s = qkv.shape[0]
    _check_width(qkv, num_heads, head_dim)
    dev = qkv.device
    if any(t.device != dev for t in (seg, cos, sin)):
        raise ValueError(f"fused_vit_attention: all tensors must be on {dev}")
    if qkv.dtype != torch.bfloat16:
        raise ValueError(f"fused_vit_attention: the kernel takes bfloat16, "
                         f"got {qkv.dtype}")
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(f"fused_vit_attention: head dim {head_dim} not in "
                         f"{KERNEL_HEAD_DIMS}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("fused_vit_attention: qkv must be a contiguous, "
                         "16-byte aligned [S, 3*H*d] slab")
    if tuple(cos.shape) != (s, head_dim) or tuple(sin.shape) != (s, head_dim):
        raise ValueError(f"fused_vit_attention: cos/sin must be "
                         f"[{s}, {head_dim}]")
    cos = cos.to(qkv.dtype).contiguous()
    sin = sin.to(qkv.dtype).contiguous()
    if cos.data_ptr() % 16 or sin.data_ptr() % 16:  # 16-byte row loads
        raise ValueError("fused_vit_attention: cos/sin must be 16-byte "
                         "aligned")
    nq = -(-s // FLASH_BLOCK)
    bounds_ptr = None
    if kv_bounds is not None:
        kv_bounds = torch.as_tensor(kv_bounds, device=dev)
        if tuple(kv_bounds.shape) != (nq, 2):
            raise ValueError(
                f"fused_vit_attention: kv_bounds shape "
                f"{tuple(kv_bounds.shape)} != ({nq}, 2): bounds must be "
                f"built at the kernel's {FLASH_BLOCK}-row tile")
        kv_bounds = kv_bounds.to(torch.int32).contiguous()
        bounds_ptr = kv_bounds.data_ptr()
    seg = _seg_i32(seg, (s,), "seg")
    if scratch is None:
        images = torch.empty((3, num_heads, nq,
                              FLASH_BLOCK * padded_head_dim(head_dim)),
                             dtype=qkv.dtype, device=dev)
        scratch = (*images.unbind(0),
                   torch.empty(nq, dtype=torch.int32, device=dev))
    out = torch.empty((s, num_heads * head_dim), dtype=qkv.dtype, device=dev)
    from visionselector_tpu_torch.kernels import _build

    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    # With a tile_seg to plant, the prologue and the main loop are two calls
    # and the planted ids go in between.
    steps = [phases] if tile_seg is None else [p for p in (1, 2)
                                               if phases & p]
    for step in steps:
        if step == 2 and tile_seg is not None:
            scratch[3].copy_(tile_seg)
        err = lib.vst_fused_vit_attn_fwd(
            qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(),
            seg.data_ptr(), bounds_ptr, *(t.data_ptr() for t in scratch), s,
            num_heads, head_dim, float(scale), step, stream)
        if err:
            raise RuntimeError(f"fused_vit_attention launch failed: CUDA "
                               f"error {err}")
    return out, scratch


def fused_vit_attention(qkv, seg, cos, sin, kv_bounds, num_heads: int,
                        head_dim: int, scale=None, impl=None):
    """Rotary + segment-masked attention straight from the qkv slab.

    qkv: [S, 3*H*d] (the projection output, pre-rotary; contiguous on
    CUDA); seg: [S] int (0 = padding); cos/sin: [S, d] (fp32 or the slab's
    dtype); kv_bounds: [ceil(S/64), 2] kv-tile ranges, or None for the full
    range. Returns [S, H*d]. The kernels for CUDA tensors (bf16, d in
    KERNEL_HEAD_DIMS), ``fused_plain`` for CPU tensors or ``impl="plain"``.
    Heads zero-padded in the weights do not fit: the slab must be exactly
    3 * num_heads * head_dim wide. The kernel has no backward (nor has the
    reference's, which defines no VJP): with a qkv that requires grad the
    default route raises instead of returning an output cut from the
    graph; ``impl="plain"`` is differentiable by autograd.
    """
    global FUSED_LAUNCHES
    _check_width(qkv, num_heads, head_dim)
    if (impl is None and torch.is_grad_enabled() and qkv.requires_grad):
        raise RuntimeError(
            "fused_vit_attention has no backward: run the default ViT "
            "route (attn_variant=None) to train through the tower")
    if scale is None:
        scale = head_dim**-0.5
    if impl == "plain" or (impl is None and _on_cpu(qkv, seg, cos, sin)):
        return fused_plain(qkv, seg, cos, sin, kv_bounds, num_heads,
                           head_dim, scale)
    if impl is not None:
        raise ValueError(f"unknown attention impl {impl!r}")
    out, _ = _launch(qkv, seg, cos, sin, kv_bounds, num_heads, head_dim,
                     scale)
    FUSED_LAUNCHES += 1
    return out
