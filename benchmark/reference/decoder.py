"""The plain decoder: Qwen2.5's (q/k/v biases, 3-axis M-RoPE) and Qwen3's
(per-head RMSNorm of q and k, no biases, 1-D rope), in float32 over
Hugging Face-named weights, one whole causal forward, layer by layer.

Also the selection the server makes before it: the LIS scores and the
compaction of text and kept vision tokens into one sequence.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.common import attention, causal, rms_norm, rotary


def rope_cos_sin(pos3: torch.Tensor, tcfg: dict):
    """pos3 [3, T] -> cos, sin [T, Dh]: with ``mrope`` the doubled
    ``mrope_section`` chunks read the (t, h, w) axes in turn, else every
    channel reads axis 0 (plain rope)."""
    dh = tcfg["head_dim"]
    dev = pos3.device
    inv = 1.0 / (tcfg["rope_theta"] ** (
        torch.arange(0, dh, 2, dtype=torch.float64, device=dev) / dh))
    freqs = pos3.double()[..., None] * inv  # [3, T, Dh/2]
    emb = torch.cat([freqs, freqs], dim=-1)  # [3, T, Dh]
    if tcfg["mrope"]:
        sec = list(tcfg["mrope_section"]) * 2
        axis = torch.tensor([i % 3 for i, m in enumerate(sec)
                             for _ in range(m)], device=dev)
    else:
        axis = torch.zeros(dh, dtype=torch.long, device=dev)
    chan = torch.arange(dh, device=dev)
    sel = emb.permute(1, 2, 0)[:, chan, axis]  # [T, Dh]
    return torch.cos(sel).float(), torch.sin(sel).float()


def decoder_logits(W, prefix: str, head: str, tcfg: dict, embeds, pos3,
                   rows, lin):
    """Logits [len(rows), V] (float32) of a causal forward over ``embeds``
    [T, D] at positions ``pos3`` [3, T], read at sequence rows ``rows``.
    ``prefix``: the decoder's weight prefix; ``head``: the output head's
    weight name (the embedding's when tied)."""
    eps = tcfg["rms_norm_eps"]
    hq, hkv, dh = (tcfg["num_attention_heads"], tcfg["num_key_value_heads"],
                   tcfg["head_dim"])
    t = embeds.shape[0]
    cos, sin = rope_cos_sin(pos3, tcfg)
    mask = causal(t, embeds.device)
    x = embeds.float()
    for i in range(tcfg["num_hidden_layers"]):
        p = f"{prefix}layers.{i}."
        h = rms_norm(x, W[p + "input_layernorm.weight"], eps)
        bias = tcfg["attention_bias"]
        q = lin(h, W[p + "self_attn.q_proj.weight"],
                W[p + "self_attn.q_proj.bias"] if bias else None)
        k = lin(h, W[p + "self_attn.k_proj.weight"],
                W[p + "self_attn.k_proj.bias"] if bias else None)
        v = lin(h, W[p + "self_attn.v_proj.weight"],
                W[p + "self_attn.v_proj.bias"] if bias else None)
        q, k, v = (q.view(t, hq, dh), k.view(t, hkv, dh), v.view(t, hkv, dh))
        if tcfg["qk_norm"]:
            q = rms_norm(q, W[p + "self_attn.q_norm.weight"], eps)
            k = rms_norm(k, W[p + "self_attn.k_norm.weight"], eps)
        q, k = rotary(q, cos, sin), rotary(k, cos, sin)
        a = attention(q, k, v, mask).reshape(t, hq * dh)
        x = x + lin(a, W[p + "self_attn.o_proj.weight"])
        h = rms_norm(x, W[p + "post_attention_layernorm.weight"], eps)
        g = lin(h, W[p + "mlp.gate_proj.weight"])
        u = lin(h, W[p + "mlp.up_proj.weight"])
        x = x + lin(torch.nn.functional.silu(g) * u,
                    W[p + "mlp.down_proj.weight"])
    x = rms_norm(x[rows], W[prefix + "norm.weight"], eps)
    return lin(x, W[head])


def lis_scores(W, prefix: str, merged, lin):
    """The LIS scores of merged vision tokens [n, D]: q_i . mean_j(k_j) /
    sqrt(h), every row valid."""
    q = lin(merged, W[prefix + "q_proj.weight"], W[prefix + "q_proj.bias"])
    k = lin(merged, W[prefix + "k_proj.weight"], W[prefix + "k_proj.bias"])
    return (q @ k.mean(0)) * q.shape[1] ** -0.5


def top_k(scores: torch.Tensor, k: int) -> np.ndarray:
    """The k best indices, ties toward the lower index, ascending."""
    order = torch.sort(-scores, stable=True).indices[:k]
    return np.sort(order.cpu().numpy())


def compacted(ids: np.ndarray, image_token: int, kept: np.ndarray):
    """Original positions of the compacted sequence: every text token and
    the kept vision tokens (indices into the image's merged tokens), in
    original order."""
    img = np.where(ids == image_token)[0]
    keep = np.zeros(len(ids), bool)
    keep[ids != image_token] = True
    keep[img[kept]] = True
    return np.where(keep)[0], img


def served_logits(W, prefix: str, head: str, tcfg: dict, ids, merged, kept,
                  pos3_orig, start_delta: int, served, lin, image_token: int):
    """Logits [m, V] at the m positions that produced the ``served``
    tokens: the compacted prompt (text embeddings, and the vision tokens
    ``merged`` [n, D] at the ``kept`` indices), then ``served[:-1]`` fed at
    positions valid_len + ``start_delta`` + j, as the server decodes."""
    dev = merged.device
    pos_orig, img = compacted(np.asarray(ids), image_token, kept)
    emb_w = W[prefix + "embed_tokens.weight"]
    ids_t = torch.as_tensor(np.asarray(ids), device=dev)
    x = emb_w[ids_t].float()
    x[torch.as_tensor(img[kept], device=dev)] = merged[
        torch.as_tensor(kept, device=dev)].float()
    x = x[torch.as_tensor(pos_orig, device=dev)]
    valid = x.shape[0]
    served = np.asarray(served, np.int64)
    m = len(served)
    tail = emb_w[torch.as_tensor(served[:-1], device=dev)].float()
    p3 = torch.as_tensor(np.asarray(pos3_orig)[:, pos_orig], device=dev)
    start = valid + start_delta
    tail_pos = torch.arange(start, start + m - 1, device=dev)
    pos3 = torch.cat([p3, tail_pos.expand(3, m - 1)], dim=1)
    rows = torch.arange(valid - 1, valid - 1 + m, device=dev)
    return decoder_logits(W, prefix, head, tcfg, torch.cat([x, tail]),
                          pos3, rows, lin)
