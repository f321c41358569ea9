"""Tile images: the layout in which the wgmma attention main loop
(``csrc/wgmma_attn.cuh``) reads q, k and v, and their plain versions.

A 64-row tile of one head is stored as one contiguous image laid out the
way Hopper's ``wgmma`` reads shared memory without swizzle (no-swizzle
K-major core matrices, ``csrc/hopper_common.cuh``), so the main loop moves
each tile with one bulk copy. q and k tiles are 64 token rows x dp (the
head dim rounded up to 16, zero-padded); v tiles are transposed, dp rows x
64 keys. Rows past the sequence are zero. ``tile_seg`` gives each tile the
segment id its 64 rows share (rows past the sequence count as segment 0),
or -1 where they differ: a kv tile whose id equals the q tile's (and is
not -1) is interior, so the main loop's step for it needs no mask.

Two prologues write these images on the card: the rotary prologue of the
fused ViT kernel (``fused_vit_attn.py``, whose plain version is
``prologue_plain`` there) and the flash route's prologue without rotation
(``attention.py``), whose plain version is ``flash_images_plain`` here.
``images_attention_plain`` is the plain version of the main loop: unpack,
then the plain attention; ``flash_steps_plain`` is its schedule, the kv
tiles each q tile visits and which of them take the mask-free step.

The window kernel (``diag_attn_fwd``) writes no images: its producer warp
copies q, k and v tiles straight from the strided views. Its persistent
schedule is mirrored by ``diag_items_plain`` (which block takes which
(batch, tile, head) item), its tile kinds (mask-free, masked, or padding
only: not loaded, zeros stored) by ``diag_tile_kinds_plain``.
"""

from __future__ import annotations

import torch

from visionselector_tpu_torch.kernels.attention import (
    FLASH_BLOCK,
    _block_ranges,
    ablate_plain,
    flash_plain,
)


def padded_head_dim(d: int) -> int:
    """dp: the head dim rounded up to one 16-element wgmma k step."""
    return -(-d // 16) * 16


def _to_image(x: torch.Tensor) -> torch.Tensor:
    """[..., R, C] -> [..., R * C] in the no-swizzle K-major core-matrix
    layout (hopper_common.cuh): 8 x 8 core matrices of 128 contiguous
    bytes, rows 16 bytes apart, core matrix (r // 8, c // 8) at index
    (r // 8) * (C // 8) + c // 8."""
    *lead, r, c = x.shape
    x = x.reshape(*lead, r // 8, 8, c // 8, 8).transpose(-3, -2)
    return x.reshape(*lead, r * c)


def _from_image(img: torch.Tensor, r: int, c: int) -> torch.Tensor:
    """Inverse of ``_to_image``: [..., R * C] -> [..., R, C]."""
    *lead, _ = img.shape
    x = img.reshape(*lead, r // 8, c // 8, 8, 8).transpose(-3, -2)
    return x.reshape(*lead, r, c)


def pack_tiles(x: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """[S, H, d] -> tile images [H, ceil(S/64), 64 * dp]: 64 token rows x
    dp (K-major), or with ``transpose`` dp rows x 64 keys (the v^T image).
    Rows past S and columns past d are zero."""
    s, h, d = x.shape
    nt, dp = -(-s // FLASH_BLOCK), padded_head_dim(d)
    t = x.new_zeros(h, nt * FLASH_BLOCK, dp)
    t[:, :s, :d] = x.transpose(0, 1)
    t = t.view(h, nt, FLASH_BLOCK, dp)
    return _to_image(t.transpose(-1, -2) if transpose else t)


def unpack_tiles(img: torch.Tensor, s: int, d: int,
                 transpose: bool = False) -> torch.Tensor:
    """Inverse of ``pack_tiles``: tile images -> [S, H, d]."""
    h, nt, _ = img.shape
    dp = padded_head_dim(d)
    if transpose:
        t = _from_image(img, dp, FLASH_BLOCK).transpose(-1, -2)
    else:
        t = _from_image(img, FLASH_BLOCK, dp)
    return t.reshape(h, nt * FLASH_BLOCK, dp)[:, :s, :d].transpose(0, 1)


def tile_seg_plain(seg: torch.Tensor) -> torch.Tensor:
    """[ceil(S/64)] int32: the tile's segment id where all 64 rows (rows
    past S count as segment 0) share one id > 0, else -1. A kv tile with
    the same id >= 0 as the q tile is interior: no pair in it is masked."""
    s = seg.shape[0]
    t = seg.new_zeros(-(-s // FLASH_BLOCK) * FLASH_BLOCK, dtype=torch.int32)
    t[:s] = seg
    t = t.view(-1, FLASH_BLOCK)
    first = t[:, 0]
    uniform = (t == first[:, None]).all(1) & (first > 0)
    return torch.where(uniform, first, torch.full_like(first, -1))


def flash_images_plain(q, k, v, q_seg, kv_seg):
    """Plain version of the flash route's prologue (no rotation).

    q: [B, Sq, H, d]; k, v: [B, Sk, H_kv, d] (any strides); q_seg [B, Sq],
    kv_seg [B, Sk]. Returns (q images [B, H, ceil(Sq/64), 64 * dp], k and
    v^T images [B, H_kv, ceil(Sk/64), 64 * dp], q tile_seg [B,
    ceil(Sq/64)], kv tile_seg [B, ceil(Sk/64)])."""
    def per_batch(fn, x, **kw):
        return torch.stack([fn(x[i], **kw) for i in range(x.shape[0])])

    return (per_batch(pack_tiles, q), per_batch(pack_tiles, k),
            per_batch(pack_tiles, v, transpose=True),
            per_batch(tile_seg_plain, q_seg), per_batch(tile_seg_plain, kv_seg))


def images_attention_plain(q_img, k_img, vt_img, q_seg, kv_seg, d,
                           scale=None, kv_bounds=None, kv_iters=None,
                           do_mask=True, do_exp=True, causal=False):
    """Plain version of the wgmma main loop on the flash route: the images
    unpacked to q [B, Sq, H, d], k, v [B, Sk, H_kv, d], then ``flash_plain``
    (bounds, kv_iters, segments, causal), or ``ablate_plain`` when the mask
    or the exp is off (no bounds then, not causal, one seg for queries and
    keys)."""
    sq, sk = q_seg.shape[1], kv_seg.shape[1]

    def unpack(img, s, **kw):
        return torch.stack([unpack_tiles(x, s, d, **kw) for x in img])

    q, k = unpack(q_img, sq), unpack(k_img, sk)
    v = unpack(vt_img, sk, transpose=True)
    if do_mask and do_exp:
        return flash_plain(q, k, v, q_seg, kv_seg, causal=causal, scale=scale,
                           kv_bounds=kv_bounds, kv_iters=kv_iters)
    if kv_bounds is not None or kv_iters or causal or sq != sk:
        raise ValueError("the ablation variants take no bounds, no kv_iters, "
                         "no causal mask and one sequence")
    return ablate_plain(q, k, v, q_seg, do_mask, do_exp, scale)


def flash_steps_plain(q_seg, kv_seg, causal=False, kv_bounds=None,
                      kv_iters=None):
    """The wgmma main loop's schedule for one batch row: (visited,
    mask_free), [ceil(Sq/64), ceil(Sk/64)] bool. q tile iq visits kv tiles
    [lo, hi) of the bounds (the full range without), capped at lo +
    kv_iters and, when causal, at iq + 1; a causal q tile with no row of
    segment > 0 visits none. A visited tile takes the mask-free step iff
    its ``tile_seg`` equals the q tile's and is not -1, and, when causal,
    it lies below the diagonal (the diagonal tile compares positions).

    q_seg: [Sq], kv_seg: [Sk] int (rows past them count as segment 0)."""
    q_seg, kv_seg = torch.as_tensor(q_seg), torch.as_tensor(kv_seg)
    nq, nk = -(-q_seg.shape[0] // FLASH_BLOCK), -(-kv_seg.shape[0] //
                                                   FLASH_BLOCK)
    visited = _block_ranges(nq, nk, q_seg.device, causal, kv_bounds,
                            kv_iters)
    q_ts, kv_ts = tile_seg_plain(q_seg), tile_seg_plain(kv_seg)
    mask_free = visited & (q_ts[:, None] >= 0) & (kv_ts[None] == q_ts[:, None])
    if causal:
        rows = q_seg.new_zeros(nq * FLASH_BLOCK)
        rows[:q_seg.shape[0]] = q_seg
        visited = visited & (rows.view(nq, FLASH_BLOCK) > 0).any(1)[:, None]
        mask_free = mask_free & visited & torch.ones(
            nq, nk, dtype=torch.bool, device=q_seg.device).tril(-1)
    return visited, mask_free


# Tile kinds of the window kernel (the enum in csrc/diag_attn_fwd.cu).
DIAG_PAD, DIAG_UNIFORM, DIAG_MIXED = 0, 1, 2


def diag_tile_kinds_plain(seg: torch.Tensor) -> torch.Tensor:
    """[B, S] segment ids (S a multiple of 64) -> [B, S / 64] int32 kinds
    of the window kernel's tiles: DIAG_UNIFORM where ``tile_seg_plain``
    gives the tile a segment id (all 64 rows one segment > 0: no mask),
    DIAG_PAD where every row is padding (segment 0: not loaded, zeros
    stored), DIAG_MIXED otherwise (the segment mask per element)."""
    seg = torch.as_tensor(seg)
    b, s = seg.shape
    if s % FLASH_BLOCK:
        raise ValueError(f"sequence {s} is not a multiple of {FLASH_BLOCK}")
    ts = torch.stack([tile_seg_plain(x) for x in seg])
    pad = (seg.view(b, -1, FLASH_BLOCK) == 0).all(-1)
    kinds = torch.where(ts >= 0, DIAG_UNIFORM, DIAG_MIXED)
    return torch.where(pad, DIAG_PAD, kinds).to(torch.int32)


def diag_items_plain(b: int, s: int, h: int, n_blocks: int):
    """The window kernel's persistent schedule: for each of its
    min(n_blocks, items) blocks, the (batch, tile, head) items it walks in
    order. Item i = (batch * S / 64 + tile) * H + head; block j takes
    items j, j + grid, j + 2 grid, ..."""
    nt = s // FLASH_BLOCK
    n = b * nt * h
    return [[(i // h // nt, i // h % nt, i % h)
             for i in range(blk, n, n_blocks)]
            for blk in range(min(n_blocks, n))]
