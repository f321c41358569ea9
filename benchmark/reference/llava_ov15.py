"""Plain float32 RICE vision tower (LLaVA-OneVision-1.5): conv patch
embed, a learned CLS row before the image with its own learned rotary
row, pre-LayerNorm, LayerNorm blocks with full attention over the image,
the CLS row stripped, the 2x2 LayerNorm merger. Weights by their Hugging
Face names."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.common import attention, layer_norm, merge_block_ids
from benchmark.reference.common import rotary

VIS = "model.visual."


def vision(W, vcfg: dict, pixels: torch.Tensor, grid, lin) -> torch.Tensor:
    """Merged tokens [n, text_hidden] of one image, in the processor's
    merge-block order. ``pixels`` [P, patch_dim] float32."""
    dev = pixels.device
    _, gh, gw = grid
    m = vcfg["spatial_merge_size"]
    heads = vcfg["num_heads"]
    d = vcfg["hidden_size"] // heads
    eps = vcfg["layer_norm_eps"]
    w_pe = W[VIS + "patch_embed.proj.weight"]
    patches = lin(pixels, w_pe.reshape(w_pe.shape[0], -1))
    x = torch.cat([W[VIS + "class_embedding"].float()[None], patches])
    pos = torch.as_tensor(merge_block_ids(gh, gw, m), device=dev)
    half = d // 2
    inv = 1.0 / (10000.0 ** (torch.arange(0, half, 2, dtype=torch.float32,
                                          device=dev) / half))
    freqs = (pos.float()[:, :, None] * inv).reshape(len(pos), -1)
    freqs = torch.cat([W[VIS + "class_pos_emb"].float().reshape(1, -1),
                       freqs])
    emb = torch.cat([freqs, freqs], dim=-1)
    cos, sin = torch.cos(emb), torch.sin(emb)
    x = layer_norm(x, W[VIS + "pre_layernorm.weight"],
                   W[VIS + "pre_layernorm.bias"], eps)
    s = x.shape[0]
    everything = torch.ones(s, s, dtype=torch.bool, device=dev)
    for i in range(vcfg["depth"]):
        p = f"{VIS}blocks.{i}."
        h = layer_norm(x, W[p + "norm1.weight"], W[p + "norm1.bias"], eps)
        qkv = lin(h, W[p + "attn.qkv.weight"], W[p + "attn.qkv.bias"])
        q, k, v = qkv.view(s, 3, heads, d).unbind(1)
        q, k = rotary(q, cos, sin), rotary(k, cos, sin)
        a = attention(q, k, v, everything).reshape(s, -1)
        x = x + lin(a, W[p + "attn.proj.weight"], W[p + "attn.proj.bias"])
        h = layer_norm(x, W[p + "norm2.weight"], W[p + "norm2.bias"], eps)
        h = F.gelu(lin(h, W[p + "mlp.fc1.weight"], W[p + "mlp.fc1.bias"]))
        x = x + lin(h, W[p + "mlp.fc2.weight"], W[p + "mlp.fc2.bias"])
    x = x[1:]  # the CLS row
    h = layer_norm(x, W[VIS + "merger.ln_q.weight"],
                   W[VIS + "merger.ln_q.bias"], eps)
    h = h.reshape(x.shape[0] // (m * m), -1)
    h = F.gelu(lin(h, W[VIS + "merger.mlp.0.weight"],
                   W[VIS + "merger.mlp.0.bias"]))
    return lin(h, W[VIS + "merger.mlp.2.weight"],
               W[VIS + "merger.mlp.2.bias"])
