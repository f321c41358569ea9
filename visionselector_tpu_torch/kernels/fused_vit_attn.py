"""Fused ViT attention: rotary and multi-head flash attention in one kernel.

Counterpart of ``visionselector_tpu.kernels.fused_vit_attn``. The kernel
(``csrc/fused_vit_attn_fwd.cu``) takes the qkv projection slab [S, 3*H*d]
as it comes out of the matmul, applies rotate-half rotary to q and k inside
the kernel, runs each head's segment-masked online-softmax attention over
the kv tiles of the bounds, and writes [S, H*d], ready for the proj matmul:
no split, rotary pass or layout copy in device memory.

``fused_plain`` is the plain PyTorch version of the same function
(``apply_rotary``, then ``flash_plain``); CPU tensors take it, CUDA
tensors launch the kernel (or raise). ``FUSED_LAUNCHES`` counts launches.
Bounds are built at the kernel's 64-row tile (``FLASH_BLOCK``), as for the
flash kernel. ``rotate_half`` / ``apply_rotary`` live here because the
kernel's rounding is defined by them; the ViT imports them.
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


def fused_vit_attention(qkv, seg, cos, sin, kv_bounds, num_heads: int,
                        head_dim: int, scale=None, impl=None):
    """Rotary + segment-masked attention straight from the qkv slab.

    qkv: [S, 3*H*d] (the projection output, pre-rotary; contiguous on
    CUDA); seg: [S] int (0 = padding); cos/sin: [S, d] (fp32 or the slab's
    dtype); kv_bounds: [ceil(S/64), 2] kv-tile ranges, or None for the full
    range. Returns [S, H*d]. The kernel for CUDA tensors (bf16, d in
    KERNEL_HEAD_DIMS), ``fused_plain`` for CPU tensors or ``impl="plain"``.
    Heads zero-padded in the weights do not fit: the slab must be exactly
    3 * num_heads * head_dim wide.
    """
    global FUSED_LAUNCHES
    s, width = qkv.shape
    if width != 3 * num_heads * head_dim:
        raise ValueError(
            f"fused_vit_attention: qkv width {width} != 3 x {num_heads} "
            f"heads x {head_dim} (heads padded in the weights do not fit "
            f"the fused kernel)")
    if scale is None:
        scale = head_dim**-0.5
    if impl == "plain" or (impl is None and _on_cpu(qkv, seg, cos, sin)):
        return fused_plain(qkv, seg, cos, sin, kv_bounds, num_heads,
                           head_dim, scale)
    if impl is not None:
        raise ValueError(f"unknown attention impl {impl!r}")
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
    bounds_ptr = None
    if kv_bounds is not None:
        kv_bounds = torch.as_tensor(kv_bounds, device=dev)
        nq = -(-s // FLASH_BLOCK)
        if tuple(kv_bounds.shape) != (nq, 2):
            raise ValueError(
                f"fused_vit_attention: kv_bounds shape "
                f"{tuple(kv_bounds.shape)} != ({nq}, 2): bounds must be "
                f"built at the kernel's {FLASH_BLOCK}-row tile")
        kv_bounds = kv_bounds.to(torch.int32).contiguous()
        bounds_ptr = kv_bounds.data_ptr()
    seg = _seg_i32(seg, (s,), "seg")
    out = torch.empty((s, num_heads * head_dim), dtype=qkv.dtype, device=dev)
    from visionselector_tpu_torch.kernels import _build

    err = _build.load().vst_fused_vit_attn_fwd(
        qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(),
        seg.data_ptr(), bounds_ptr, s, num_heads, head_dim, float(scale),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"fused_vit_attention launch failed: CUDA error "
                           f"{err}")
    FUSED_LAUNCHES += 1
    return out
