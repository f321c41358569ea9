"""Segment-id (varlen) attention: CUDA kernels and their plain versions.

Counterpart of ``visionselector_tpu.kernels.attention``. Variable-length
packing is expressed with segment ids (a key is visible iff its segment id
equals the query's and is > 0); padding rows carry id 0 and come out as
exact zeros. The same flash kernel serves ViT full attention (per-image
segments, kv-tile bounds), ViT window attention on the classic layout, and
causal LM prefill (GQA without expanding kv).

Hand-written CUDA kernels (``csrc/``), each with a plain PyTorch version
of the same function beside it:

- ``flash_varlen_fwd`` / ``flash_plain``: flash attention with per-q-tile
  kv-tile bounds, optional causal mask and the ``kv_iters`` truncation
  contract. Replaces the TPU kernels ``_flash_pallas`` and
  ``_flash_pallas_streamed``. ``flash_packed_fwd`` / ``flash_packed_plain``
  run the same kernel on [B, S, H * dp] slabs through strided views
  (replaces ``_flash_pallas_packed``), and ``fullattn_ablate`` /
  ``ablate_plain`` run its compile-time variants without bounds, mask or
  exp (replaces the TPU bench kernel of ``tools/bench_fullattn_ablate.py``).
  Every call (the ViT's full layers, K2, K3, the ablation, the causal LM
  prefill) makes two launches: a prologue that writes q, k and v as wgmma
  tile images (``tiles.py``; its plain version is
  ``tiles.flash_images_plain``) into scratch, then the wgmma main loop it
  shares with the fused ViT kernel (causal or not: its schedule is
  ``tiles.flash_steps_plain``). ``FLASH_ROUTE_LAUNCHES`` counts the calls.
- ``diag_attn_fwd`` / ``diag_plain``: block-diagonal attention for the
  window-aligned ViT layout. Replaces ``attention_diag``'s ``_diag_kernel``.
  One persistent launch: a producer warp copies each (batch, 64-row tile,
  head) item's q, k and v tiles by TMA from the strided views, consumer
  warpgroups run wgmma and store each output tile by TMA; tiles of
  padding only are not read. Its schedule and tile kinds are mirrored by
  ``tiles.diag_items_plain`` / ``tiles.diag_tile_kinds_plain``.
- ``decode_blocked_fwd`` / ``decode_blocked_plain``: GQA decode attention
  over an unexpanded (bf16 or int8) KV cache that reads only each slot's
  live prefix. Replaces ``_decode_blocked_pallas``'s
  ``_decode_blocked_kernel``; every decode step of the port runs it.
  ``decode_split_plain`` / ``decode_split_ranges_plain`` mirror its
  schedule (the live tiles split over a thread-block cluster's ranks,
  then merged). A packed int4 cache (an int4 slot pool) takes the plain
  route ``decode_int4_plain`` instead, as the reference keeps packed S4
  off its Pallas kernel: chosen by the cache's uint8 dtype, counted in
  ``INT4_DECODE_CALLS``; the decode kernel raises on such a cache.

``attention_with_received`` (the training-free baselines' last ViT block:
attention and each key's received mass) is plain blocked PyTorch, as the
reference computes it outside any Pallas kernel.

Training differentiates the flash kernel through ``FlashAttentionFn``:
its forward is the kernel (the plain version on CPU tensors), its backward
``flash_backward_plain``, a blocked PyTorch mirror of the reference's XLA
backward (the reference has no Pallas backward kernel). ``attention`` and
``attention_packed`` take it only when q, k or v requires grad, and so
does ``attention_diag`` (its forward the diag kernel, the same mirror with
the window segments and no causal mask behind it).
``FLASH_GRAD_LAUNCHES`` / ``DIAG_GRAD_LAUNCHES`` count the launches made
under grad.

A wrapper launches its kernel for CUDA tensors (or raises) and takes the
plain version only for CPU tensors. ``FLASH_LAUNCHES`` / ``DIAG_LAUNCHES``
/ ``DECODE_LAUNCHES`` / ``PACKED_LAUNCHES`` / ``ABLATE_LAUNCHES`` count
wrapper calls that launched kernels, each wrapper its own
(``FLASH_CAPPED_LAUNCHES`` the flash calls with a kv_iters cap,
``FLASH_CAUSAL_LAUNCHES`` those with the causal mask), so a run can
show that it went through the kernels. ``impl="plain"`` asks for the plain
path on any device (used to compare the whole model against the kernels on
the card); for decode that is the dense path over the whole cache, the
reference's XLA decode.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30

# The kernels' q/kv tile (kTile in csrc/attn_common.cuh). Bounds must be
# built at this granularity
# (``segment_block_bounds(seg, FLASH_BLOCK, FLASH_BLOCK)``), and the diag
# kernel's block equals the 64-patch window slot of the aligned layout.
FLASH_BLOCK = 64
DIAG_BLOCK = 64
# Head dims the kernels are built for (the switch in csrc/*.cu): the
# Qwen2.5-VL ViT (80) and decoder (128), LLaVA-OV's RICE (64), and
# qwen25vl_tiny's ViT (16) and decoder (24), which ``api.predict`` runs on
# ``--device cuda`` by default.
KERNEL_HEAD_DIMS = (16, 24, 64, 80, 128)
# The flash (causal prefill) and decode kernels also take llava_ov_tiny's
# decoder head dim (32), which ``api.predict --family llava_ov15`` runs on
# ``--device cuda`` by default.
FLASH_HEAD_DIMS = (16, 24, 32, 64, 80, 128)
# Rows of queries per step of the plain versions: bounds their fp32 logits
# to [H, chunk, Sk] at any sequence length.
_PLAIN_Q_CHUNK = 1024

FLASH_LAUNCHES = 0
DIAG_LAUNCHES = 0
DECODE_LAUNCHES = 0
PACKED_LAUNCHES = 0
ABLATE_LAUNCHES = 0
# ``flash_varlen_fwd`` launches with a kv_iters cap (the reference's
# streamed kernel, K2: the ViT's full layers in the 16,384 bucket); each
# also counts in FLASH_LAUNCHES.
FLASH_CAPPED_LAUNCHES = 0
# ``flash_varlen_fwd`` launches with the causal mask (decoder prefills);
# each also counts in FLASH_LAUNCHES, so the rest are the vision towers'.
FLASH_CAUSAL_LAUNCHES = 0
# Launches made under grad, through ``FlashAttentionFn``: the flash and
# packed wrappers' in FLASH_GRAD_LAUNCHES, the diag wrapper's in
# DIAG_GRAD_LAUNCHES; each also counts in its wrapper's count.
FLASH_GRAD_LAUNCHES = 0
DIAG_GRAD_LAUNCHES = 0
# Calls of the flash kernel source (flash, packed and ablation wrappers) by
# route; there is one, "wgmma": the image prologue, then the wgmma main loop.
FLASH_ROUTE_LAUNCHES = {"wgmma": 0}
# Decode kernel launches by query rows per slot (t_c): 1 for a decode step,
# a chunk's rows for scoring, chat appends and admission segments. Every
# launch also counts in DECODE_LAUNCHES.
DECODE_LAUNCHES_BY_ROWS: dict = {}
# Calls of the plain int4 decode route (``decode_int4_plain``: packed int4
# pools, which the decode kernel does not take), on any device.
INT4_DECODE_CALLS = 0


def segment_block_bounds(seg_ids, block_q: int, block_k: int) -> np.ndarray:
    """Per-query-block [lo, hi) kv-block ranges from contiguous segment ids
    (host numpy; same function as the reference's).

    Requires the packed layout: same-segment tokens contiguous, segments
    ascending (padding rows, id 0, may sit between or after them). A query
    block's kv range spans the first to the last token of the segments it
    touches; a block of padding only gets (0, 0).
    """
    seg = np.asarray(seg_ids)
    s = len(seg)
    nq = s // block_q
    vals, first_idx = np.unique(seg, return_index=True)
    vals_r, first_r = np.unique(seg[::-1], return_index=True)
    last_idx = s - 1 - first_r
    max_id = int(vals.max(initial=0))
    first_arr = np.zeros(max_id + 1, np.int64)
    last_arr = np.zeros(max_id + 1, np.int64)
    first_arr[vals] = first_idx
    last_arr[vals_r] = last_idx

    blocks = seg.reshape(nq, block_q)
    has_valid = (blocks > 0).any(axis=1)
    bmin = np.where(blocks == 0, max_id + 1, blocks).min(axis=1)
    bmax = blocks.max(axis=1)
    bmin = np.where(has_valid, bmin, 0)
    lo = first_arr[bmin] // block_k
    hi = last_arr[bmax] // block_k + 1
    return np.stack([
        np.where(has_valid, lo, 0), np.where(has_valid, hi, 0)
    ], axis=1).astype(np.int32)


def _seg_mask(q_seg, kv_seg):
    """[B, Sq, Sk] bool: same nonzero segment."""
    return (q_seg[:, :, None] == kv_seg[:, None, :]) & (kv_seg[:, None, :] > 0)


def mha_reference(q, k, v, q_seg, kv_seg, causal=False, scale=None):
    """Dense masked multi-head attention, fp32 softmax.

    q: [B, Sq, H, D]; k, v: [B, Sk, H, D] (heads already equal);
    q_seg: [B, Sq]; kv_seg: [B, Sk] (0 = padding). Returns q's dtype.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = _seg_mask(q_seg, kv_seg)
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        qi = torch.arange(sq, device=q.device)
        ki = torch.arange(sk, device=q.device)
        mask = mask & (qi[:, None] >= ki[None, :])
    logits = torch.where(mask[:, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(mask.any(-1)[:, None, :, None], probs, 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _masked_softmax_pv(logits, mask, v):
    """logits [B, G, R, Q, K] fp32, mask broadcastable to it, v [B, K, G, D]
    -> [B, Q, G, R, D] fp32: the kernels' arithmetic (fp32 exp and row sum,
    p rounded to v's dtype before P V, fully masked rows exactly 0)."""
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    p = p.to(v.dtype).float() / torch.where(l == 0.0, 1.0, l)
    return torch.einsum("bgrqk,bkgd->bqgrd", p, v.float())


def _block_ranges(nq: int, nk: int, device, causal: bool, kv_bounds,
                  kv_iters):
    """[nq, nk] bool: kv tiles each q tile visits — bounds (or the full
    range), truncated to lo + kv_iters, capped at the diagonal when
    causal. The contract the flash kernel implements."""
    if kv_bounds is None:
        lo = torch.zeros(nq, dtype=torch.int64, device=device)
        hi = torch.full((nq,), nk, dtype=torch.int64, device=device)
    else:
        b = torch.as_tensor(kv_bounds, device=device).long()
        lo, hi = b[:, 0], b[:, 1]
    if kv_iters:
        hi = torch.minimum(hi, lo + max(1, min(int(kv_iters), nk)))
    if causal:
        hi = torch.minimum(hi, torch.arange(1, nq + 1, device=device))
    kb = torch.arange(nk, device=device)
    return (kb[None, :] >= lo[:, None]) & (kb[None, :] < hi[:, None])


def flash_plain(q, k, v, q_seg, kv_seg, causal=False, scale=None,
                kv_bounds=None, kv_iters=None):
    """Plain PyTorch version of the flash kernel (same masks, bounds and
    ``kv_iters`` truncation, dense softmax per query chunk).

    q: [B, Sq, H, D]; k, v: [B, Sk, H_kv, D] with H % H_kv == 0 (query head
    h reads kv head h // (H / H_kv)); q_seg [B, Sq], kv_seg [B, Sk] int;
    kv_bounds: optional [ceil(Sq / 64), 2] kv-tile ranges; kv_iters: 0 /
    None for no cap. Returns [B, Sq, H, D] in q's dtype.
    """
    block = FLASH_BLOCK
    b, sq, h, d = q.shape
    sk, h_kv = k.shape[1], k.shape[2]
    n_rep = h // h_kv
    if scale is None:
        scale = d**-0.5
    nq, nk = -(-sq // block), -(-sk // block)
    if kv_bounds is not None and len(kv_bounds) != nq:
        raise ValueError(
            f"kv_bounds has {len(kv_bounds)} rows, expected {nq} "
            f"(bounds built at another block than {block})")
    tiles = _block_ranges(nq, nk, q.device, causal, kv_bounds, kv_iters)
    qi_tile = torch.arange(sq, device=q.device) // block
    ki_tile = torch.arange(sk, device=q.device) // block
    kf = k.float()
    out = torch.empty(b, sq, h_kv, n_rep, d, dtype=torch.float32,
                      device=q.device)
    chunk = max(block, _PLAIN_Q_CHUNK // block * block)
    for s0 in range(0, sq, chunk):
        s1 = min(sq, s0 + chunk)
        qg = q[:, s0:s1].float().reshape(b, s1 - s0, h_kv, n_rep, d)
        logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, kf) * scale
        mask = _seg_mask(q_seg[:, s0:s1], kv_seg)
        mask = mask & tiles[qi_tile[s0:s1]][:, ki_tile][None]
        if causal:
            qi = torch.arange(s0, s1, device=q.device)
            mask = mask & (qi[:, None] >= torch.arange(sk, device=q.device))
        out[:, s0:s1] = _masked_softmax_pv(logits, mask[:, None, None], v)
    return out.reshape(b, sq, h, d).to(q.dtype)


def diag_plain(q, k, v, seg, scale=None, block_q=DIAG_BLOCK):
    """Plain PyTorch version of the diag kernel: queries of each
    ``block_q``-aligned block attend only to keys of the same block.

    q, k, v: [B, S, H, D]; seg: [B, S] with S % block_q == 0.
    """
    b, s, h, d = q.shape
    if scale is None:
        scale = d**-0.5
    if s % block_q:
        raise ValueError(f"sequence {s} is not a multiple of block {block_q}")
    nb = s // block_q
    qb = q.float().reshape(b * nb, block_q, h, 1, d)
    kb = k.reshape(b * nb, block_q, h, d)
    vb = v.reshape(b * nb, block_q, h, d)
    segb = seg.reshape(b * nb, block_q)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qb, kb.float()) * scale
    mask = _seg_mask(segb, segb)[:, None, None]
    out = _masked_softmax_pv(logits, mask, vb)
    return out.reshape(b, s, h, d).to(q.dtype)


def _strides(x: torch.Tensor, name: str):
    """(batch, seq, head) element strides of a [B, S, H, D] tensor the
    kernels read through strides; rejects layouts they cannot."""
    if x.stride(3) != 1:
        raise ValueError(f"{name}: the head dim must be contiguous")
    if x.data_ptr() % 16 or any(st % 8 for st in x.stride()[:3]):
        raise ValueError(
            f"{name}: rows must be 16-byte aligned (data_ptr and strides "
            f"in multiples of 8 elements), got strides {x.stride()}")
    return x.stride(0), x.stride(1), x.stride(2)


def _check_cuda(name, q, *tensors, dims=KERNEL_HEAD_DIMS):
    dev = q.device
    for t in (q, *tensors):
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the kernel takes bfloat16, got {q.dtype}")
    d = q.shape[-1]
    if d not in dims:
        raise ValueError(f"{name}: head dim {d} not in {dims}")


def _seg_i32(seg: torch.Tensor, shape, name: str) -> torch.Tensor:
    if tuple(seg.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(seg.shape)} != {shape}")
    return seg.to(torch.int32).contiguous()


def _on_cpu(*tensors) -> bool:
    devices = {t.device.type for t in tensors if t is not None}
    if devices == {"cpu"}:
        return True
    if devices == {"cuda"}:
        return False
    raise ValueError(f"attention inputs on unsupported devices {devices}")


def _flash_scratch(b, h, h_kv, sq, sk, d, dev):
    """The wgmma route's scratch: q images [B, H, nq, 64 * dp], k and v^T
    images [B, H_kv, nk, 64 * dp] (bf16), q and kv tile_seg [B, nq] and
    [B, nk] (int32)."""
    from visionselector_tpu_torch.kernels.tiles import padded_head_dim

    img = FLASH_BLOCK * padded_head_dim(d)
    nq, nk = -(-sq // FLASH_BLOCK), -(-sk // FLASH_BLOCK)
    kv = torch.empty((2, b, h_kv, nk, img), dtype=torch.bfloat16, device=dev)
    return (torch.empty((b, h, nq, img), dtype=torch.bfloat16, device=dev),
            *kv.unbind(0), torch.empty((b, nq), dtype=torch.int32, device=dev),
            torch.empty((b, nk), dtype=torch.int32, device=dev))


def _launch_flash(name, q, k, v, q_seg, kv_seg, causal, scale, kv_bounds,
                  kv_iters, ablate=None, phases=3, scratch=None,
                  tile_seg=None):
    """Check the inputs of a flash launch on CUDA tensors and launch the
    kernels (the caller counts the call; the route is counted here).

    ``phases`` 1 the image prologue, 2 the main loop (on ``scratch`` that a
    prologue filled; causal or not), 3 both; ``ablate=(do_mask, do_exp)``
    launches the ablation's variants (non-causal, no bounds, ``q_seg`` for
    queries and keys); ``tile_seg=(q, kv)`` replaces the prologue's tile
    segment ids before the main loop (only the card tests and
    ``chip_smoke.py`` pass it, to plant a fault). Returns (out [B, Sq, H,
    D], scratch: (q_img, k_img, vt_img, q tile_seg, kv tile_seg))."""
    b, sq, h, d = q.shape
    sk, h_kv = k.shape[1], k.shape[2]
    _check_cuda(name, q, k, v, q_seg, kv_seg,
                dims=KERNEL_HEAD_DIMS if ablate else FLASH_HEAD_DIMS)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k, v dtypes differ")
    if (k.shape[0] != b or tuple(v.shape) != tuple(k.shape)
            or k.shape[3] != d or h % h_kv):
        raise ValueError(
            f"{name}: q {tuple(q.shape)} / k {tuple(k.shape)} / "
            f"v {tuple(v.shape)} do not match")
    if scale is None:
        scale = d**-0.5
    nq = -(-sq // FLASH_BLOCK)
    bounds_ptr = None
    if kv_bounds is not None:
        kv_bounds = torch.as_tensor(kv_bounds, device=q.device)
        if tuple(kv_bounds.shape) != (nq, 2):
            raise ValueError(
                f"{name}: kv_bounds shape {tuple(kv_bounds.shape)} != "
                f"({nq}, 2): bounds must be built at the kernel's "
                f"{FLASH_BLOCK}-row tile")
        kv_bounds = kv_bounds.to(torch.int32).contiguous()
        bounds_ptr = kv_bounds.data_ptr()
    q_seg = _seg_i32(q_seg, (b, sq), "q_seg")
    kv_seg = _seg_i32(kv_seg, (b, sk), "kv_seg")
    # the prologue's 16-byte loads: base pointers and strides checked here
    strides = (*_strides(q, "q"), *_strides(k, "k"), *_strides(v, "v"))
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    from visionselector_tpu_torch.kernels import _build

    lib = _build.load()
    if scratch is None:
        scratch = _flash_scratch(b, h, h_kv, sq, sk, d, q.device)
    ptrs = [t.data_ptr() for t in scratch]
    # With a tile_seg to plant, the prologue and the main loop are two
    # calls and the planted ids go in between.
    steps = [phases] if tile_seg is None else [
        st for st in (1, 2) if phases & st]
    for step in steps:
        if step == 2 and tile_seg is not None:
            scratch[3].copy_(tile_seg[0])
            scratch[4].copy_(tile_seg[1])
        if ablate is None:
            err = lib.vst_flash_varlen_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                q_seg.data_ptr(), kv_seg.data_ptr(), bounds_ptr, *strides,
                b, sq, sk, h, h_kv, d, int(bool(causal)),
                int(kv_iters or 0), float(scale), *ptrs, step, stream)
        else:
            err = lib.vst_fullattn_ablate_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                q_seg.data_ptr(), *strides, b, sq, h, d,
                int(bool(ablate[0])), int(bool(ablate[1])), float(scale),
                *ptrs, step, stream)
        if err:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    FLASH_ROUTE_LAUNCHES["wgmma"] += 1
    return out, scratch


def flash_varlen_fwd(q, k, v, q_seg, kv_seg, causal=False, scale=None,
                     kv_bounds=None, kv_iters=None):
    """Flash attention: the CUDA kernel for CUDA tensors, ``flash_plain``
    for CPU tensors. Shapes as ``flash_plain``; on CUDA q/k/v are bf16 with
    D in FLASH_HEAD_DIMS, kv_bounds (if given) has one row per 64-row q
    tile.
    """
    global FLASH_LAUNCHES, FLASH_CAPPED_LAUNCHES, FLASH_CAUSAL_LAUNCHES
    if _on_cpu(q, k, v, q_seg, kv_seg):
        return flash_plain(q, k, v, q_seg, kv_seg, causal, scale, kv_bounds,
                           kv_iters)
    out, _ = _launch_flash("flash_varlen_fwd", q, k, v, q_seg, kv_seg,
                           causal, scale, kv_bounds, kv_iters)
    FLASH_LAUNCHES += 1
    if kv_iters:
        FLASH_CAPPED_LAUNCHES += 1
    if causal:
        FLASH_CAUSAL_LAUNCHES += 1
    return out


def _heads(x: torch.Tensor, heads: int, dp: int, name: str) -> torch.Tensor:
    """[B, S, heads * dp] slab -> its [B, S, heads, dp] view (no copy: the
    slab's last dim must be contiguous, as a projection output or a column
    slice of one is)."""
    if x.shape[-1] != heads * dp:
        raise ValueError(f"{name}: last dim {x.shape[-1]} != {heads} heads "
                         f"x {dp}")
    return x.unflatten(-1, (heads, dp))


def flash_packed_plain(q, k, v, q_seg, kv_seg, num_heads, num_kv_heads, dp,
                       causal=False, scale=None, kv_bounds=None):
    """Plain PyTorch version of the packed entry point: ``flash_plain`` on
    the [B, S, H, dp] views of the [B, S, H * dp] slabs; returns
    [B, Sq, H * dp]."""
    return flash_plain(
        _heads(q, num_heads, dp, "q"), _heads(k, num_kv_heads, dp, "k"),
        _heads(v, num_kv_heads, dp, "v"), q_seg, kv_seg, causal, scale,
        kv_bounds).flatten(2)


def flash_packed_fwd(q, k, v, q_seg, kv_seg, num_heads, num_kv_heads, dp,
                     causal=False, scale=None, kv_bounds=None):
    """Packed-head flash attention (the port of ``_flash_pallas_packed``).

    q: [B, Sq, H * dp]; k, v: [B, Sk, H_kv * dp] (GQA unexpanded), each a
    slab or a column slice of one. The flash kernel reads the [B, S, H, dp]
    views through strides: no transpose and no copy. For zero-padded heads
    (the ViT's 80 padded to dp = 128 in the weights) pass the real
    ``scale`` (80 ** -0.5); pad columns of q, k and v are zero, so they add
    nothing to the logits and the output's pad columns come out exactly 0.
    CPU tensors take ``flash_packed_plain``. Returns [B, Sq, H * dp];
    counted in PACKED_LAUNCHES (not FLASH_LAUNCHES).
    """
    global PACKED_LAUNCHES
    if _on_cpu(q, k, v, q_seg, kv_seg):
        return flash_packed_plain(q, k, v, q_seg, kv_seg, num_heads,
                                  num_kv_heads, dp, causal, scale, kv_bounds)
    out, _ = _launch_flash(
        "flash_packed_fwd", _heads(q, num_heads, dp, "q"),
        _heads(k, num_kv_heads, dp, "k"), _heads(v, num_kv_heads, dp, "v"),
        q_seg, kv_seg, causal, scale, kv_bounds, None)
    PACKED_LAUNCHES += 1
    return out.flatten(2)


def ablate_plain(q, k, v, seg, do_mask=True, do_exp=True, scale=None):
    """Plain PyTorch version of the full-attention ablation kernel.

    q, k, v: [B, S, H, D]; seg: [B, S]. Every key is visited (no bounds).
    ``do_mask=False`` drops the segment mask, padding included;
    ``do_exp=False`` takes p = the (masked) logits * scale in place of the
    softmax and divides by nothing. With both on it is ``flash_plain``
    without bounds. Returns [B, S, H, D] in q's dtype.
    """
    b, s, h, d = q.shape
    if scale is None:
        scale = d**-0.5
    kf = k.float()
    out = torch.empty(b, s, h, 1, d, dtype=torch.float32, device=q.device)
    for s0 in range(0, s, _PLAIN_Q_CHUNK):
        s1 = min(s, s0 + _PLAIN_Q_CHUNK)
        qg = q[:, s0:s1].float().reshape(b, s1 - s0, h, 1, d)
        logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, kf) * scale
        mask = (_seg_mask(seg[:, s0:s1], seg)[:, None, None] if do_mask
                else torch.ones((), dtype=torch.bool, device=q.device))
        if do_exp:
            out[:, s0:s1] = _masked_softmax_pv(logits, mask, v)
        else:
            p = torch.where(mask, logits, 0.0).to(v.dtype).float()
            out[:, s0:s1] = torch.einsum("bgrqk,bkgd->bqgrd", p, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)


def fullattn_ablate(q, k, v, seg, do_mask=True, do_exp=True, scale=None):
    """The full-attention ablation (port of the TPU bench kernel in
    ``tools/bench_fullattn_ablate.py``): the flash kernel's non-causal
    route (image prologue, wgmma main loop) with no bounds and the mask
    and/or the exp compiled out (``ablate_plain`` for the function). CUDA
    tensors launch the kernels (bf16, D in KERNEL_HEAD_DIMS, S a multiple
    of 64 so no key lies past the sequence); CPU tensors take
    ``ablate_plain``."""
    global ABLATE_LAUNCHES
    if _on_cpu(q, k, v, seg):
        return ablate_plain(q, k, v, seg, do_mask, do_exp, scale)
    out, _ = _launch_ablate(q, k, v, seg, do_mask, do_exp, scale)
    ABLATE_LAUNCHES += 1
    return out


def _launch_ablate(q, k, v, seg, do_mask, do_exp, scale, **kw):
    """Check the ablation's inputs and launch it (``_launch_flash``'s
    ``phases`` / ``scratch`` in ``kw``); returns (out, scratch)."""
    s = q.shape[1]
    if (tuple(k.shape) != tuple(q.shape) or tuple(v.shape) != tuple(q.shape)
            or k.dtype != q.dtype or v.dtype != q.dtype):
        raise ValueError("fullattn_ablate: q, k, v shapes or dtypes differ")
    if s % FLASH_BLOCK:
        raise ValueError(f"fullattn_ablate: S={s} not a multiple of "
                         f"{FLASH_BLOCK}")
    return _launch_flash("fullattn_ablate", q, k, v, seg, seg, False, scale,
                         None, None, ablate=(do_mask, do_exp), **kw)


def diag_attn_fwd(q, k, v, seg, scale=None, block_q=DIAG_BLOCK):
    """Block-diagonal attention: the CUDA kernel for CUDA tensors,
    ``diag_plain`` for CPU tensors. The kernel's block is 64 rows."""
    global DIAG_LAUNCHES
    if _on_cpu(q, k, v, seg):
        return diag_plain(q, k, v, seg, scale, block_q)
    out = _launch_diag(q, k, v, seg, scale, block_q)
    DIAG_LAUNCHES += 1
    return out


def _launch_diag(q, k, v, seg, scale=None, block_q=DIAG_BLOCK,
                 tile_kind=None):
    """Check the inputs of a diag launch on CUDA tensors and launch the
    kernel (the caller counts the call). q, k, v: [B, S, H, D] bf16 views
    (the head dim contiguous; base and batch, row and head strides 16-byte
    aligned), S a multiple of 64; seg [B, S]. ``tile_kind`` ([B, S / 64]
    int, ``tiles.DIAG_PAD`` / ``DIAG_UNIFORM`` / ``DIAG_MIXED``) replaces
    the kinds the kernel reads from ``seg`` (only the card tests and
    ``chip_smoke.py`` pass it, to plant a fault). Returns out [B, S, H, D]
    (contiguous)."""
    b, s, h, d = q.shape
    _check_cuda("diag_attn_fwd", q, k, v, seg)
    if block_q != DIAG_BLOCK:
        raise ValueError(
            f"diag_attn_fwd: the kernel's block is {DIAG_BLOCK}, "
            f"got {block_q}")
    if tuple(k.shape) != tuple(q.shape) or tuple(v.shape) != tuple(q.shape):
        raise ValueError("diag_attn_fwd: q, k, v shapes differ")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("diag_attn_fwd: q, k, v dtypes differ")
    if s % DIAG_BLOCK:
        raise ValueError(
            f"diag_attn_fwd: S={s} not a multiple of {DIAG_BLOCK}")
    if scale is None:
        scale = d**-0.5
    seg = _seg_i32(seg, (b, s), "seg")
    kind_ptr = None
    if tile_kind is not None:
        tile_kind = _seg_i32(torch.as_tensor(tile_kind, device=q.device),
                             (b, s // DIAG_BLOCK), "tile_kind")
        kind_ptr = tile_kind.data_ptr()
    strides = (*_strides(q, "q"), *_strides(k, "k"), *_strides(v, "v"))
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    from visionselector_tpu_torch.kernels import _build

    err = _build.load().vst_diag_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        seg.data_ptr(), kind_ptr, *strides, b, s, h, d, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        what = (f"tensor map encoding failed: CUresult {err - 10000}"
                if err >= 10000 else f"CUDA error {err}")
        raise RuntimeError(f"diag_attn_fwd launch failed: {what}")
    return out


# Gradient of the flash kernel. The reference gives its Pallas forwards a
# backward computed in XLA (``_with_reference_vjp``: ``_flash_stats_blocked``
# then ``_mha_backward_blocked``); the port's backward is the same blocked
# computation in PyTorch.
BACKWARD_BLOCK = 512


def _backward_block(sq: int, sk: int) -> int:
    """The kv block of the blocked backward, by the reference's rule:
    ``min(BACKWARD_BLOCK, sk)``, else the largest of 384 / 256 / 128 / 64
    dividing sk; unaligned or unequal lengths take one block over every
    key (the reference differentiates its dense attention there: the same
    gradient, computed densely)."""
    block = min(BACKWARD_BLOCK, sk)
    if sk % block:
        block = next((bb for bb in (384, 256, 128, 64) if sk % bb == 0), 0)
    return block if block and sq == sk else sk


def _block_logits(qf, kf, q_seg, kv_seg, causal, scale, j0, block):
    """Logits of kv block [j0, j0 + block) and their mask (same nonzero
    segment, and causal when asked): qf [B, G, R, Sq, D] (query head g * R
    + r), kf [B, G, Sk, D], fp32. Returns (s [B, G, R, Sq, bk], mask [B, 1,
    1, Sq, bk])."""
    ks = kf[:, :, j0:j0 + block]
    s = torch.einsum("bgrqd,bgkd->bgrqk", qf, ks) * scale
    kseg = kv_seg[:, j0:j0 + block]
    mask = (q_seg[:, :, None] == kseg[:, None, :]) & (kseg[:, None, :] > 0)
    if causal:
        qi = torch.arange(q_seg.shape[1], device=qf.device)
        ki = j0 + torch.arange(kseg.shape[1], device=qf.device)
        mask = mask & (qi[:, None] >= ki[None, :])
    return s, mask[:, None, None]


def _flash_stats_blocked(qf, kf, q_seg, kv_seg, causal, scale, block):
    """Each row's softmax max m and normaliser l [B, G, R, Sq] by a loop
    over kv blocks (the reference's ``_flash_stats_blocked``): O(Sq *
    block) memory, the logits never materialised whole. Layouts as
    ``_block_logits``; a row with no visible key keeps m = NEG_INF, l = 0."""
    b, g, r, sq, _ = qf.shape
    m = torch.full((b, g, r, sq), NEG_INF, device=qf.device)
    l = torch.zeros((b, g, r, sq), device=qf.device)
    for j0 in range(0, kf.shape[2], block):
        s, mask = _block_logits(qf, kf, q_seg, kv_seg, causal, scale, j0,
                                block)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        l = l * torch.exp(m - m_new) + torch.where(
            mask, torch.exp(s - m_new[..., None]), 0.0).sum(-1)
        m = m_new
    return m, l


def flash_backward_plain(q, k, v, q_seg, kv_seg, causal, scale, out, g,
                         fault=None):
    """dq, dk, dv of segment-masked (optionally causal) attention, streamed
    over kv blocks: the reference's ``_flash_stats_blocked`` (each row's
    max m and normaliser l) then ``_mha_backward_blocked`` (with P =
    softmax(S), delta = rowsum(dO * O): dV = P^T dO, dS = P * (dO V^T -
    delta), dQ = dS K * scale, dK = dS^T Q * scale), fp32 throughout.

    q: [B, Sq, H, D]; k, v: [B, Sk, H_kv, D] with query head h reading kv
    head h // (H / H_kv), so dk and dv sum the group's heads (the gradient
    the reference takes through its kv head expansion); out: the forward's
    output; g: its cotangent. Rows and keys of padding (segment 0) get zero
    gradients. Returns (dq, dk, dv) in q's, k's and v's dtypes.

    ``fault`` plants a known error for checks that must catch it:
    "delta_zero" computes delta from zeros, "drop_diag_dk" leaves each kv
    block's own q rows (the diagonal block) out of dk.
    """
    b, sq, h, d = q.shape
    sk, h_kv = k.shape[1], k.shape[2]
    r = h // h_kv
    if scale is None:
        scale = d**-0.5
    block = _backward_block(sq, sk)

    def grouped(x):  # [B, S, H, D] -> [B, H_kv, R, S, D] fp32
        return x.float().reshape(b, sq, h_kv, r, d).permute(0, 2, 3, 1, 4)

    qf, gf, of = grouped(q), grouped(g), grouped(out)
    kf = k.float().permute(0, 2, 1, 3)  # [B, H_kv, Sk, D]
    vf = v.float().permute(0, 2, 1, 3)
    m, l = _flash_stats_blocked(qf, kf, q_seg, kv_seg, causal, scale, block)
    l_safe = torch.where(l == 0.0, 1.0, l)
    delta = (gf * of).sum(-1)  # [B, H_kv, R, Sq]
    if fault == "delta_zero":
        delta = torch.zeros_like(delta)

    dq = torch.zeros_like(qf)
    dk = torch.empty_like(kf)
    dv = torch.empty_like(vf)
    for j0 in range(0, sk, block):
        j1 = min(sk, j0 + block)
        s, mask = _block_logits(qf, kf, q_seg, kv_seg, causal, scale, j0,
                                block)
        p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
        p = p / l_safe[..., None]
        dv[:, :, j0:j1] = torch.einsum("bgrqk,bgrqd->bgkd", p, gf)
        dp = torch.einsum("bgrqd,bgkd->bgrqk", gf, vf[:, :, j0:j1])
        ds = p * (dp - delta[..., None])
        dq += torch.einsum("bgrqk,bgkd->bgrqd", ds, kf[:, :, j0:j1]) * scale
        if fault == "drop_diag_dk":
            ds = ds.clone()
            ds[:, :, :, j0:j1] = 0.0
        dk[:, :, j0:j1] = torch.einsum("bgrqk,bgrqd->bgkd", ds, qf) * scale
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


RECV_BLOCK = 512


def attention_with_received(q, k, v, seg, scale=None, block=RECV_BLOCK,
                            fault=None):
    """Segment-masked attention and each key's received attention mass,
    streamed over kv blocks: the port of the reference's
    ``attention_with_received`` (plain XLA there, no Pallas kernel), the
    statistics the ViT-side training-free baselines read (VisionZip /
    PruMerge+ / HoloV capture semantics) without the [H, S, S] map.

    q, k, v: [S, H, D] (one image); seg: [S] (0 = padding). Two passes over
    kv blocks of ``block`` keys (the last one may be shorter), fp32: each
    query row's max and normaliser, then p = exp(s - m) / l per block,
    accumulated into the output and, as the mean over heads summed over
    queries, into the block's received mass. Padding keys get no mass and
    padding queries give none (exactly as at the reference's mask).
    Returns (out [S, H, D] in q's dtype, recv [S] fp32 normalised by the
    valid query count).

    ``fault="unmask_padding_keys"`` lets every query see the padding keys
    (a planted error for checks that must catch it).
    """
    s_len, h, d = q.shape
    if scale is None:
        scale = d**-0.5
    seg1 = seg.reshape(1, s_len)
    qf = q.float().permute(1, 0, 2)[None, :, None]  # [1, H, 1, S, D]
    kf = k.float().permute(1, 0, 2)[None]  # [1, H, S, D]
    vf = v.float().permute(1, 0, 2)[None]
    if fault == "unmask_padding_keys":
        kv_seg = torch.where(seg1 > 0, seg1, seg1.amax())
    else:
        kv_seg = seg1
    m, l = _flash_stats_blocked(qf, kf, seg1, kv_seg, False, scale, block)
    l_safe = torch.where(l == 0.0, 1.0, l)
    n_valid = (seg > 0).sum().clamp(min=1).float()
    out = torch.zeros_like(qf[:, :, 0])  # [1, H, S, D]
    recv = torch.empty(s_len, dtype=torch.float32, device=q.device)
    for j0 in range(0, s_len, block):
        j1 = min(s_len, j0 + block)
        s, mask = _block_logits(qf, kf, seg1, kv_seg, False, scale, j0,
                                block)
        p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
        p = (p / l_safe[..., None])[:, :, 0]  # [1, H, S, bk]
        out += torch.einsum("bhqk,bhkd->bhqd", p, vf[:, :, j0:j1])
        recv[j0:j1] = p[0].mean(dim=0).sum(dim=0) / n_valid
    return out[0].permute(1, 0, 2).to(q.dtype), recv


class FlashAttentionFn(torch.autograd.Function):
    """The flash or diag forward (``fwd(q, k, v)``: the kernel on CUDA
    tensors, its plain version on CPU tensors) with ``flash_backward_plain``
    as its backward. For the diag kernel that is the reference's
    ``_with_reference_vjp(..., seg, seg, False, scale)``: the mirror streams
    over every key under the segment mask, and on the window-aligned layout
    each segment lies inside one block, so that is the block-diagonal
    attention's gradient. No fallback: a forward that fails raises."""

    @staticmethod
    def forward(ctx, fwd, q, k, v, q_seg, kv_seg, causal, scale):
        global FLASH_GRAD_LAUNCHES, DIAG_GRAD_LAUNCHES
        flash, diag = FLASH_LAUNCHES + PACKED_LAUNCHES, DIAG_LAUNCHES
        out = fwd(q, k, v)
        FLASH_GRAD_LAUNCHES += FLASH_LAUNCHES + PACKED_LAUNCHES - flash
        DIAG_GRAD_LAUNCHES += DIAG_LAUNCHES - diag
        ctx.save_for_backward(q, k, v, q_seg, kv_seg, out)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, q_seg, kv_seg, out = ctx.saved_tensors
        dq, dk, dv = flash_backward_plain(q, k, v, q_seg, kv_seg, ctx.causal,
                                          ctx.scale, out, g)
        return None, dq, dk, dv, None, None, None, None


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def attention(q, k, v, q_seg, kv_seg, causal=False, scale=None, impl=None,
              kv_bounds=None, kv_iters=None):
    """Segment-masked multi-head attention (``flash_varlen_fwd``).

    q: [B, Sq, H, D]; k, v: [B, Sk, H_kv, D]; segs [B, S] (0 = padding).
    ``impl="plain"`` runs the plain version on any device; the default runs
    the kernel on CUDA tensors and the plain version on CPU tensors. When
    q, k or v requires grad (and grad mode is on) the call goes through
    ``FlashAttentionFn``: the same forward, ``flash_backward_plain`` behind
    it; otherwise nothing is saved.
    """
    if impl == "plain":
        fwd = flash_plain
    elif impl is None:
        fwd = flash_varlen_fwd
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    if _needs_grad(q, k, v):
        return FlashAttentionFn.apply(
            lambda q, k, v: fwd(q, k, v, q_seg, kv_seg, causal, scale,
                                kv_bounds, kv_iters),
            q, k, v, q_seg, kv_seg, causal, scale)
    return fwd(q, k, v, q_seg, kv_seg, causal, scale, kv_bounds, kv_iters)


def attention_packed(q, k, v, q_seg, kv_seg, num_heads, num_kv_heads, dp,
                     causal=False, scale=None, kv_bounds=None, impl=None):
    """Segment-masked attention over [B, S, H * dp] slabs
    (``flash_packed_fwd``); ``impl="plain"`` runs ``flash_packed_plain`` on
    any device. Differentiable as ``attention``."""
    if impl == "plain":
        fwd = flash_packed_plain
    elif impl is None:
        fwd = flash_packed_fwd
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    if _needs_grad(q, k, v):
        return FlashAttentionFn.apply(
            lambda q, k, v: fwd(
                q.flatten(2), k.flatten(2), v.flatten(2), q_seg, kv_seg,
                num_heads, num_kv_heads, dp, causal, scale,
                kv_bounds).unflatten(-1, (num_heads, dp)),
            _heads(q, num_heads, dp, "q"), _heads(k, num_kv_heads, dp, "k"),
            _heads(v, num_kv_heads, dp, "v"), q_seg, kv_seg, causal,
            scale).flatten(2)
    return fwd(q, k, v, q_seg, kv_seg, num_heads, num_kv_heads, dp, causal,
               scale, kv_bounds)


def attention_diag(q, k, v, seg, scale=None, block_q=None, impl=None):
    """Block-diagonal segment attention (window-aligned ViT layout); every
    segment lives inside one ``block_q``-aligned block. Equivalent to
    ``attention(..., causal=False)`` on such layouts. ``impl="plain"`` runs
    ``diag_plain`` on any device; the default the kernel on CUDA tensors
    and ``diag_plain`` on CPU tensors. When q, k or v requires grad (and
    grad mode is on) the call goes through ``FlashAttentionFn`` (the same
    forward, ``flash_backward_plain`` with the window segments and no
    causal mask behind it); otherwise nothing is saved."""
    block_q = DIAG_BLOCK if block_q is None else block_q
    if impl == "plain":
        fwd = diag_plain
    elif impl is None:
        fwd = diag_attn_fwd
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    if _needs_grad(q, k, v):
        return FlashAttentionFn.apply(
            lambda q, k, v: fwd(q, k, v, seg, scale, block_q), q, k, v, seg,
            seg, False, scale)
    return fwd(q, k, v, seg, scale, block_q)


def decode_blocked_plain(q, k_cache, v_cache, base_len, scale=None,
                         k_scale=None, v_scale=None):
    """Plain PyTorch version of the decode kernel, with its arithmetic.

    q: [B, t_c, Hq, D]; k_cache/v_cache: [B, T, H_kv, D] (float, or int8
    with ``k_scale``/``v_scale`` [B, T, H_kv] f32 per-row scales);
    base_len: [B] lengths before the chunk: chunk row i attends to cache
    positions < base_len + i + 1. Logits are q.k * scale * k_scale; exp and
    the row sum l are fp32 over the unscaled p; p is multiplied by v_scale
    and rounded to q's dtype before P V; the output is divided by l (1 where
    l == 0, so a row with no valid key is exactly 0). Returns q's dtype.
    """
    b, t_c, hq, d = q.shape
    t, h_kv = k_cache.shape[1], k_cache.shape[2]
    if scale is None:
        scale = d**-0.5
    qg = q.float().reshape(b, t_c, h_kv, hq // h_kv, d)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, k_cache.float()) * scale
    if k_scale is not None:
        logits = logits * k_scale.float().permute(0, 2, 1)[:, :, None, None]
    limit = (base_len.to(q.device)[:, None]
             + torch.arange(t_c, device=q.device) + 1)  # [B, t_c]
    mask = (torch.arange(t, device=q.device) < limit[..., None])[:, None, None]
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale.float().permute(0, 2, 1)[:, :, None, None]
    out = torch.einsum("bgrqk,bkgd->bgrqd", p.to(q.dtype).float(),
                       v_cache.float()) / torch.where(l == 0.0, 1.0, l)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t_c, hq, d).to(q.dtype)


def decode_split_ranges_plain(base_len, t_c: int, t: int, cluster: int):
    """The decode kernel's split of each slot's live 64-row tiles over the
    ``cluster`` ranks of its cluster: [B, cluster, 2] int64 (lo, hi) tile
    ranges. A slot has ceil((base_len + t_c) / 64) live tiles, at most
    ceil(T / 64) (the TPU kernel's clamped kv index); rank r takes
    [r * n // cluster, (r + 1) * n // cluster), which may be empty."""
    base = torch.as_tensor(base_len).to(torch.int64)
    live = (base + t_c).clamp(min=0, max=t)
    n = (live + FLASH_BLOCK - 1) // FLASH_BLOCK
    r = torch.arange(cluster + 1, device=base.device)
    cuts = r[None] * n[:, None] // cluster  # [B, cluster + 1]
    return torch.stack([cuts[:, :-1], cuts[:, 1:]], dim=-1)


def decode_split_plain(q, k_cache, v_cache, base_len, scale=None,
                       k_scale=None, v_scale=None, cluster: int = 8,
                       drop_rank: int = -1):
    """Plain PyTorch mirror of the decode kernel's schedule: each rank's
    live-tile range (``decode_split_ranges_plain``), its (m, l, acc) in the
    kernel's arithmetic (fp32 statistics over the rank's keys, p times the v
    scale rounded to q's dtype before P V), then the ranks' merge: m = max
    m_r, l = sum l_r exp(m_r - m), out = sum acc_r exp(m_r - m) / l (1
    where l == 0, so a row with no valid key is exactly 0; m_r = NEG_INF is
    finite, so an empty rank gives no NaN). ``drop_rank`` leaves one rank
    out of the merge (a planted fault). Shapes as ``decode_blocked_plain``.
    """
    b, t_c, hq, d = q.shape
    t, h_kv = k_cache.shape[1], k_cache.shape[2]
    if scale is None:
        scale = d**-0.5
    dev = q.device
    base = base_len.to(dev)
    qg = q.float().reshape(b, t_c, h_kv, hq // h_kv, d)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, k_cache.float()) * scale
    if k_scale is not None:
        logits = logits * k_scale.float().permute(0, 2, 1)[:, :, None, None]
    limit = base[:, None] + torch.arange(t_c, device=dev) + 1  # [B, t_c]
    keys = torch.arange(t, device=dev)
    valid = keys < limit[..., None]  # [B, t_c, T]
    ranges = decode_split_ranges_plain(base, t_c, t, cluster).to(dev)
    tile = keys // FLASH_BLOCK
    own = ((tile >= ranges[..., :1]) & (tile < ranges[..., 1:]))  # [B, C, T]
    mask = (own[:, :, None] & valid[:, None])[:, :, None, None]
    x = torch.where(mask, logits[:, None], NEG_INF)  # [B, C, g, r, q, T]
    m = x.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(x - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale.float().permute(0, 2, 1)[:, None, :, None, None]
    acc = torch.einsum("bcgrqk,bkgd->bcgrqd", p.to(q.dtype).float(),
                       v_cache.float())
    if drop_rank >= 0:
        m[:, drop_rank] = NEG_INF
        l[:, drop_rank] = 0.0
        acc[:, drop_rank] = 0.0
    mx = m.amax(dim=1, keepdim=True)
    w = torch.exp(m - mx)
    lt = (l * w).sum(dim=1)
    out = (acc * w).sum(dim=1) / torch.where(lt == 0.0, 1.0, lt)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t_c, hq, d).to(q.dtype)


_DECODE_CLUSTER = {}
DECODE_MAX_CLUSTER = 16  # kMaxCluster in decode_blocked_fwd.cu


def decode_rows(t_c: int, n_rep: int):
    """(m16 tiles per block, row groups per kv head) of the decode kernel
    for t_c * n_rep query rows per kv head: a block holds up to 32 rows."""
    r = t_c * n_rep
    mt = min(2, -(-r // 16))
    return mt, -(-r // (16 * mt))


def decode_cluster_size(dev, b, t_c, hq, h_kv, d, quant) -> int:
    """Ranks per (slot, kv head, row group): the largest power of two up to
    16 with which the card holds every cluster of the launch at once (one
    wave; the card's answer for this block size and shared memory). Shapes
    and the card only, never lengths, so a captured launch replays for
    any."""
    key = (torch.device(dev), b, t_c, hq, h_kv, d, bool(quant))
    c = _DECODE_CLUSTER.get(key)
    if c is None:
        from visionselector_tpu_torch.kernels import _build

        pairs = b * h_kv * decode_rows(t_c, hq // h_kv)[1]
        query = _build.load().vst_decode_blocked_query
        c = DECODE_MAX_CLUSTER
        while c > 1 and query(t_c, hq, h_kv, d, int(quant), c, 0) < pairs:
            c //= 2
        _DECODE_CLUSTER[key] = c
    return c


def decode_blocked_fwd(q, k_cache, v_cache, base_len, scale=None,
                       k_scale=None, v_scale=None):
    """Length-aware decode attention: the CUDA kernel for CUDA tensors,
    ``decode_blocked_plain`` for CPU tensors (shapes as there).

    On CUDA: q bf16 with D in FLASH_HEAD_DIMS; caches bf16, or int8 with
    both f32 scales; any T (the kernel masks the ragged last tile). The
    caches are read through strides, so a layer view of a slot pool needs
    no copy, and only each slot's live tiles are read. The launch reads
    ``base_len`` on the device only and allocates only the output.
    """
    if k_cache.dtype == torch.uint8 or v_cache.dtype == torch.uint8:
        raise ValueError(
            "decode_blocked_fwd: a packed int4 (uint8) cache is not a "
            "bf16 or int8 one; int4 pools take decode_int4_plain")
    if _on_cpu(q, k_cache, v_cache, base_len, k_scale, v_scale):
        return decode_blocked_plain(q, k_cache, v_cache, base_len, scale,
                                    k_scale, v_scale)
    return _decode_launch(q, k_cache, v_cache, base_len, scale, k_scale,
                          v_scale)


def _decode_launch(q, k_cache, v_cache, base_len, scale=None, k_scale=None,
                   v_scale=None, drop_rank: int = -1):
    """One launch of the decode kernel (CUDA tensors). ``drop_rank`` >= 0
    leaves that rank out of the cluster merge: a planted fault for the
    checks, never used by the model."""
    global DECODE_LAUNCHES
    b, t_c, hq, d = q.shape
    t, h_kv = k_cache.shape[1], k_cache.shape[2]
    _check_cuda("decode_blocked_fwd", q, k_cache, v_cache, base_len,
                dims=FLASH_HEAD_DIMS)
    if (tuple(k_cache.shape) != (b, t, h_kv, d)
            or tuple(v_cache.shape) != tuple(k_cache.shape) or hq % h_kv):
        raise ValueError(
            f"decode_blocked_fwd: q {tuple(q.shape)} / k "
            f"{tuple(k_cache.shape)} / v {tuple(v_cache.shape)} do not match")
    if k_cache.dtype != v_cache.dtype:
        raise ValueError("decode_blocked_fwd: k and v caches differ in dtype")
    quant = k_cache.dtype == torch.int8
    if not quant and k_cache.dtype != torch.bfloat16:
        raise ValueError(f"decode_blocked_fwd: caches must be bfloat16 or "
                         f"int8, got {k_cache.dtype}")
    if quant != (k_scale is not None) or quant != (v_scale is not None):
        raise ValueError("decode_blocked_fwd: int8 caches need both scales "
                         "and bfloat16 caches take none")
    if tuple(base_len.shape) != (b,):
        raise ValueError(f"decode_blocked_fwd: base_len shape "
                         f"{tuple(base_len.shape)} != ({b},)")
    if scale is None:
        scale = d**-0.5
    if quant:
        # int8 rows go by 16-byte bulk copies, except 24-byte rows (D = 24),
        # which go by 8-byte copies
        align = 8 if d % 16 else 16
        for x, name in ((k_cache, "k_cache"), (v_cache, "v_cache")):
            if (x.stride(3) != 1 or x.data_ptr() % align
                    or any(st % align for st in x.stride()[:3])):
                raise ValueError(f"decode_blocked_fwd: {name} rows must be "
                                 f"contiguous and {align}-byte aligned")
        for x in (k_scale, v_scale):
            if (tuple(x.shape) != (b, t, h_kv) or x.dtype != torch.float32
                    or x.device != q.device):
                raise ValueError(f"decode_blocked_fwd: scales must be f32 "
                                 f"[{b}, {t}, {h_kv}] on {q.device}")
        if k_scale.stride() != v_scale.stride():
            raise ValueError("decode_blocked_fwd: k/v scales differ in "
                             "strides")
        k_st, v_st = k_cache.stride()[:3], v_cache.stride()[:3]
        s_st = k_scale.stride()
        ks_ptr, vs_ptr = k_scale.data_ptr(), v_scale.data_ptr()
    else:
        k_st, v_st = _strides(k_cache, "k_cache"), _strides(v_cache,
                                                             "v_cache")
        s_st, ks_ptr, vs_ptr = (0, 0, 0), None, None
    lens = base_len.to(torch.int64).contiguous()
    cluster = decode_cluster_size(q.device, b, t_c, hq, h_kv, d, quant)
    out = torch.empty((b, t_c, hq, d), dtype=q.dtype, device=q.device)
    from visionselector_tpu_torch.kernels import _build

    err = _build.load().vst_decode_blocked_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), ks_ptr, vs_ptr,
        out.data_ptr(), lens.data_ptr(),
        *_strides(q, "q"), *k_st, *v_st, *s_st,
        b, t_c, hq, h_kv, t, d, int(quant), cluster, int(drop_rank),
        float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"decode_blocked_fwd launch failed: CUDA error "
                           f"{err}")
    DECODE_LAUNCHES += 1
    DECODE_LAUNCHES_BY_ROWS[t_c] = DECODE_LAUNCHES_BY_ROWS.get(t_c, 0) + 1
    return out


def _decode_dense(q, k_cache, v_cache, limit, scale, k_scale, v_scale):
    """The dense plain path over the whole cache (the reference's XLA
    decode): limit [B, t_c] = the key count each chunk row sees."""
    b, t_c, hq, d = q.shape
    h_kv = k_cache.shape[2]
    qg = q.reshape(b, t_c, h_kv, hq // h_kv, d)
    logits = torch.einsum(
        "bqgrd,bkgd->bgrqk", qg.float(), k_cache.float()) * scale
    if k_scale is not None:
        logits = logits * k_scale.float().permute(0, 2, 1)[:, :, None, None]
    t = torch.arange(k_cache.shape[1], device=q.device)
    valid = t < limit.to(q.device)[..., None]  # [B, t_c, T]
    logits = torch.where(valid[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale.float().permute(0, 2, 1)[:, :, None, None]
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs.to(q.dtype),
                       v_cache.to(q.dtype))
    return out.reshape(b, t_c, hq, d).to(q.dtype)


def decode_int4_plain(q, k_cache, v_cache, base_len, scale=None,
                      k_scale=None, v_scale=None):
    """The int4 decode route: unpack the packed caches (uint8 [B, T, H_kv,
    D / 2], ``lm.QuantKVCache``'s layout) to int8, then the dense chunk
    attention over the whole cache with the scales folded into the logits
    and p, as the reference's XLA path reads its S4 pools. A plain PyTorch
    route on every device, by the reference's design (no kernel of the
    reference reads int4); ``INT4_DECODE_CALLS`` counts its calls."""
    global INT4_DECODE_CALLS
    from visionselector_tpu_torch.models.qwen25vl.lm import unpack_int4

    if k_scale is None or v_scale is None:
        raise ValueError("decode_int4_plain: an int4 cache needs both scales")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    limit = (base_len[:, None] + 1
             + torch.arange(q.shape[1], device=base_len.device))
    INT4_DECODE_CALLS += 1
    return _decode_dense(q, unpack_int4(k_cache), unpack_int4(v_cache),
                         limit, scale, k_scale, v_scale)


def chunk_decode_attention(q, k_cache, v_cache, base_len, scale=None,
                           k_scale=None, v_scale=None, impl=None):
    """Multi-token decode attention: chunk row i (its kv just written at
    cache position base_len + i) attends to positions < base_len + i + 1.

    q: [B, t_c, Hq, D]; caches [B, T, H_kv, D], unexpanded (GQA groups the
    queries); int8 caches with ``k_scale``/``v_scale`` [B, T, H_kv] f32.
    The default is ``decode_blocked_fwd`` (the kernel on CUDA tensors);
    ``impl="plain"`` runs the dense plain path on any device. Packed int4
    caches (uint8 [B, T, H_kv, D / 2]) take ``decode_int4_plain`` under
    either impl.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if impl not in (None, "plain"):
        raise ValueError(f"unknown decode attention impl {impl!r}")
    if k_cache.dtype == torch.uint8:
        return decode_int4_plain(q, k_cache, v_cache, base_len, scale,
                                 k_scale, v_scale)
    if impl == "plain":
        limit = (base_len[:, None] + 1
                 + torch.arange(q.shape[1], device=base_len.device))
        return _decode_dense(q, k_cache, v_cache, limit, scale, k_scale,
                             v_scale)
    return decode_blocked_fwd(q, k_cache, v_cache, base_len, scale, k_scale,
                              v_scale)


def decode_attention(q, k_cache, v_cache, cache_len, scale=None,
                     k_scale=None, v_scale=None, impl=None):
    """Single-step decode attention: q [B, 1, Hq, D] attends to cache
    positions < cache_len [B] (see ``chunk_decode_attention``)."""
    return chunk_decode_attention(q, k_cache, v_cache, cache_len - 1, scale,
                                  k_scale, v_scale, impl)
