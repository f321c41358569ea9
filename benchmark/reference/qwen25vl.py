"""Plain float32 Qwen2.5-VL vision tower (Hugging Face semantics): patch
embed, 2-D rotary, window attention over 112-px windows with full
attention at the configured blocks, the 2x2 patch merger, and the window
order undone. Weights by their Hugging Face names."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.common import (
    attention,
    block_diagonal,
    merge_block_ids,
    rms_norm,
    rotary,
)

VIS = "visual."


def window_index(mh: int, mw: int, ws: int):
    """(merged-token order that groups each window's tokens, row-major
    windows and row-major inside each; window id of each) for a (mh, mw)
    merged grid cut into ws x ws windows (the edge windows partial)."""
    idx = np.arange(mh * mw).reshape(mh, mw)
    order, wid = [], []
    w = 0
    for r in range(0, mh, ws):
        for c in range(0, mw, ws):
            block = idx[r:r + ws, c:c + ws].reshape(-1)
            order.append(block)
            wid.append(np.full(len(block), w))
            w += 1
    return np.concatenate(order), np.concatenate(wid)


def vision(W, vcfg: dict, pixels: torch.Tensor, grid, lin) -> torch.Tensor:
    """Merged tokens [n, out_hidden] of one image, in the processor's
    merge-block order. ``pixels`` [P, patch_dim] float32."""
    dev = pixels.device
    _, gh, gw = grid
    m = vcfg["spatial_merge_size"]
    unit = m * m
    heads = vcfg["num_heads"]
    d = vcfg["hidden_size"] // heads
    eps = vcfg["rms_norm_eps"]
    w_pe = W[VIS + "patch_embed.proj.weight"]
    x = lin(pixels, w_pe.reshape(w_pe.shape[0], -1))  # [P, E]
    # rotary: (h, w) ids per patch, d / 4 frequencies per axis
    pos = torch.as_tensor(merge_block_ids(gh, gw, m), device=dev)
    half = d // 2
    inv = 1.0 / (10000.0 ** (torch.arange(0, half, 2, dtype=torch.float32,
                                          device=dev) / half))
    freqs = (pos.float()[:, :, None] * inv).reshape(len(pos), -1)
    emb = torch.cat([freqs, freqs], dim=-1)
    cos, sin = torch.cos(emb), torch.sin(emb)
    # window order over merged tokens (each merged token = ``unit`` rows)
    ws = vcfg["window_size"] // m // vcfg["patch_size"]
    order, wid = window_index(gh // m, gw // m, ws)
    rows = torch.as_tensor((order[:, None] * unit + np.arange(unit)).reshape(
        -1), device=dev)
    x, cos, sin = x[rows], cos[rows], sin[rows]
    win_seg = torch.as_tensor(np.repeat(wid, unit), device=dev)
    full_mask = torch.ones(len(rows), len(rows), dtype=torch.bool,
                           device=dev)
    win_mask = block_diagonal(win_seg)
    s = x.shape[0]
    for i in range(vcfg["depth"]):
        p = f"{VIS}blocks.{i}."
        h = rms_norm(x, W[p + "norm1.weight"], eps)
        qkv = lin(h, W[p + "attn.qkv.weight"], W[p + "attn.qkv.bias"])
        q, k, v = qkv.view(s, 3, heads, d).unbind(1)
        q, k = rotary(q, cos, sin), rotary(k, cos, sin)
        mask = full_mask if i in vcfg["fullatt_block_indexes"] else win_mask
        a = attention(q, k, v, mask).reshape(s, -1)
        x = x + lin(a, W[p + "attn.proj.weight"], W[p + "attn.proj.bias"])
        h = rms_norm(x, W[p + "norm2.weight"], eps)
        g = lin(h, W[p + "mlp.gate_proj.weight"], W[p + "mlp.gate_proj.bias"])
        u = lin(h, W[p + "mlp.up_proj.weight"], W[p + "mlp.up_proj.bias"])
        x = x + lin(F.silu(g) * u, W[p + "mlp.down_proj.weight"],
                    W[p + "mlp.down_proj.bias"])
    h = rms_norm(x, W[VIS + "merger.ln_q.weight"], eps).reshape(
        s // unit, -1)
    h = F.gelu(lin(h, W[VIS + "merger.mlp.0.weight"],
                   W[VIS + "merger.mlp.0.bias"]))
    h = lin(h, W[VIS + "merger.mlp.2.weight"], W[VIS + "merger.mlp.2.bias"])
    return h[torch.as_tensor(np.argsort(order), device=dev)]
