"""Qwen2.5 decoder (GQA + M-RoPE).

Counterpart of ``visionselector_tpu.models.qwen25vl.lm`` (bf16 / fp32
weights; weight quantization, LoRA, Qwen3 and MoE variants are not ported
yet):

- M-RoPE: cos/sin from 3-axis position ids, each rotary channel taking the
  axis its ``mrope_section`` chunk names, applied in fp32,
- prefill: segment-masked causal flash attention (the CUDA kernel on the
  card) over the compacted valid-prefix sequence; GQA reads kv head
  h // n_rep inside the kernel, so kv is never expanded; under
  ``attn_variant="packed"`` a head dim that is a multiple of 128 takes the
  packed entry point on the q/k/v slabs (the same kernel),
- decode: length-aware attention against the KV cache (the decode kernel
  on the card), which is written in place; the cache may be bf16 / fp32 or
  int8 with per-row scales (``QuantKVCache``, serving slot pools). One
  step takes one row per slot (``lm_decode_step``), a chunk t_c rows,
  causal within the chunk (``lm_decode_chunk``: multiple-choice scoring).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from visionselector_tpu_torch.core.config import TextConfig
from visionselector_tpu_torch.core.params import add_params, init_random_
from visionselector_tpu_torch.kernels.attention import (
    attention,
    attention_packed,
    chunk_decode_attention,
)
from visionselector_tpu_torch.models.qwen25vl.vit import rms_norm, rotate_half


@dataclasses.dataclass
class KVCache:
    """Preallocated cache; decode steps write their row IN PLACE."""

    k: torch.Tensor  # [n_layers, B, T_max, H_kv, Dh]
    v: torch.Tensor  # [n_layers, B, T_max, H_kv, Dh]
    length: torch.Tensor  # [n_layers, B] int64 valid lengths


@dataclasses.dataclass
class QuantKVCache:
    """int8 KV cache (serving slot pools): entry [l, b, t, h] stores
    ``round(x / s)`` with its scale ``s = absmax / 127`` over the head dim
    kept beside it. Half the bytes of a bf16 pool, read by the decode kernel
    as int8 with the scales folded into the logits and p."""

    k: torch.Tensor  # int8 [n_layers, B, T_max, H_kv, Dh]
    v: torch.Tensor  # int8 [n_layers, B, T_max, H_kv, Dh]
    k_scale: torch.Tensor  # f32 [n_layers, B, T_max, H_kv]
    v_scale: torch.Tensor  # f32 [n_layers, B, T_max, H_kv]
    length: torch.Tensor  # [n_layers, B] int64 valid lengths


def quantize_kv(x: torch.Tensor):
    """[..., Dh] -> (int8 values, f32 scales over the last dim); the
    reference's per-row absmax rule (round half to even)."""
    xf = x.float()
    s = xf.abs().amax(dim=-1) / 127.0 + 1e-12
    return torch.round(xf / s[..., None]).to(torch.int8), s


def dequantize_kv(q: torch.Tensor, s: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * s[..., None].float()).to(dtype)


class DecoderLayer(nn.Module):
    """One decoder layer's weights (kernels ``[in, out]``)."""

    def __init__(self, cfg: TextConfig, device, dtype):
        super().__init__()
        d, i, dh = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
        hq, hkv = cfg.num_attention_heads, cfg.num_key_value_heads
        add_params(self, {
            "input_ln_scale": (d,), "post_ln_scale": (d,),
            "q_kernel": (d, hq * dh), "k_kernel": (d, hkv * dh),
            "v_kernel": (d, hkv * dh), "o_kernel": (hq * dh, d),
            "gate_kernel": (d, i), "up_kernel": (d, i),
            "down_kernel": (i, d),
            "q_bias": (hq * dh,), "k_bias": (hkv * dh,), "v_bias": (hkv * dh,),
        }, device, dtype)


class LanguageModel(nn.Module):
    """Token embedding, decoder layers, final norm (tied lm head)."""

    def __init__(self, cfg: TextConfig, device, dtype):
        super().__init__()
        if (cfg.qk_norm or cfg.num_experts or not cfg.mrope
                or not cfg.attention_bias):
            raise NotImplementedError(
                "the port runs the Qwen2.5 decoder only (Qwen3 / MoE text "
                "models are a later slice)")
        self.cfg = cfg
        add_params(self, {"embed_tokens": (cfg.vocab_size, cfg.hidden_size)},
                   device, dtype)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, device, dtype)
            for _ in range(cfg.num_hidden_layers))
        add_params(self, {"final_ln_scale": (cfg.hidden_size,)}, device, dtype)
        if not cfg.tie_word_embeddings:
            add_params(self, {"lm_head_kernel": (cfg.hidden_size,
                                                 cfg.vocab_size)},
                       device, dtype)


def mrope_axis_selector(cfg: TextConfig, device=None) -> torch.Tensor:
    """[Dh] int64: which of (t, h, w) feeds each rotary channel (channel d
    of the doubled ``mrope_section`` chunks reads axis ``chunk % 3``)."""
    sec = list(cfg.mrope_section) * 2
    axis = [i % 3 for i, m in enumerate(sec) for _ in range(m)]
    return torch.tensor(axis, dtype=torch.int64, device=device)


def mrope_cos_sin(position_ids: torch.Tensor, cfg: TextConfig):
    """position_ids [3, B, T] -> merged (cos, sin) [B, T, Dh] fp32."""
    dh = cfg.head_dim
    dev = position_ids.device
    inv_freq = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, dh, 2, dtype=torch.float32, device=dev) / dh))
    freqs = position_ids.float()[..., None] * inv_freq  # [3, B, T, Dh/2]
    emb = torch.cat([freqs, freqs], dim=-1)  # [3, B, T, Dh]
    axis = mrope_axis_selector(cfg, dev)
    chan = torch.arange(dh, device=dev)
    # Pick channel c from axis[c]: [B, T, Dh].
    cos = torch.cos(emb).permute(1, 2, 3, 0)[..., chan, axis]
    sin = torch.sin(emb).permute(1, 2, 3, 0)[..., chan, axis]
    return cos, sin


def _apply_mrope(q, k, cos, sin):
    """q: [B, T, H, Dh]; cos/sin: [B, T, Dh]. Rotation in fp32."""
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    qf, kf = q.float(), k.float()
    q_out = qf * cos + rotate_half(qf) * sin
    k_out = kf * cos + rotate_half(kf) * sin
    return q_out.to(q.dtype), k_out.to(k.dtype)


def _dense(x, p: nn.Module, name: str):
    """x @ kernel (bf16 / fp32 weights)."""
    return x @ getattr(p, name)


def _qkv(x, p: DecoderLayer, cfg: TextConfig):
    b, t, _ = x.shape
    dh = cfg.head_dim
    q = _dense(x, p, "q_kernel") + p.q_bias
    k = _dense(x, p, "k_kernel") + p.k_bias
    v = _dense(x, p, "v_kernel") + p.v_bias
    return (q.view(b, t, cfg.num_attention_heads, dh),
            k.view(b, t, cfg.num_key_value_heads, dh),
            v.view(b, t, cfg.num_key_value_heads, dh))


def _mlp(x, p: DecoderLayer):
    """Dense SwiGLU."""
    h = F.silu(_dense(x, p, "gate_kernel")) * _dense(x, p, "up_kernel")
    return _dense(h, p, "down_kernel")


def _prefill_layer(x, p: DecoderLayer, cos, sin, seg_ids, cfg: TextConfig,
                   packed: bool, attn_impl):
    """One decoder layer over the full sequence: (x out, rotated k, v)."""
    b, t = x.shape[:2]
    h = rms_norm(x, p.input_ln_scale, cfg.rms_norm_eps)
    q, k, v = _qkv(h, p, cfg)
    q, k = _apply_mrope(q, k, cos, sin)
    if packed:
        attn = attention_packed(
            q.flatten(2), k.flatten(2), v.flatten(2), seg_ids, seg_ids,
            cfg.num_attention_heads, cfg.num_key_value_heads,
            cfg.head_dim, causal=True, impl=attn_impl)
    else:
        attn = attention(q, k, v, seg_ids, seg_ids, causal=True,
                         impl=attn_impl)
    x = x + _dense(attn.reshape(b, t, -1), p, "o_kernel")
    h = rms_norm(x, p.post_ln_scale, cfg.rms_norm_eps)
    return x + _mlp(h, p), k, v


def lm_prefill(lm: LanguageModel, inputs_embeds, position_ids, seg_ids,
               attn_impl: str | None = None, attn_variant: str | None = None,
               remat: bool = False
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence forward (training and prefill). Differentiable: with
    inputs that require grad, attention goes through the flash kernel's
    autograd Function; inference callers run it under ``no_grad``.

    Args:
        inputs_embeds: [B, T, D] (valid-prefix layout; padding rows masked
            via seg_ids == 0).
        position_ids: [3, B, T] M-RoPE ids.
        seg_ids: [B, T] int32; 0 = padding.
        attn_variant: "packed" routes attention through the packed entry
            point on the [B, T, H * Dh] slabs when Dh is a multiple of 128
            (the reference's rule); any other value, or another Dh, runs
            the flash entry point.
        remat: wrap each decoder layer in ``torch.utils.checkpoint``
            (non-reentrant; the reference's ``jax.checkpoint``): the
            backward recomputes a layer's activations instead of keeping
            them, the same values and gradients.
    Returns:
        (final hidden [B, T, D] post-norm, (k_layers, v_layers) each
         [n_layers, B, T, H_kv, Dh] rotated keys / values for the cache).
    """
    cfg = lm.cfg
    cos, sin = mrope_cos_sin(position_ids, cfg)
    x = inputs_embeds
    packed = attn_variant == "packed" and cfg.head_dim % 128 == 0
    ks, vs = [], []
    for p in lm.layers:
        args = (x, p, cos, sin, seg_ids, cfg, packed, attn_impl)
        if remat:
            x, k, v = torch.utils.checkpoint.checkpoint(
                _prefill_layer, *args, use_reentrant=False)
        else:
            x, k, v = _prefill_layer(*args)
        ks.append(k)
        vs.append(v)
    x = rms_norm(x, lm.final_ln_scale, cfg.rms_norm_eps)
    return x, (torch.stack(ks), torch.stack(vs))


@torch.no_grad()
def lm_decode_step(lm: LanguageModel, cache, inputs_embeds, position_ids,
                   attn_impl: str | None = None):
    """One decode step: ``lm_decode_chunk`` with one row per slot.

    inputs_embeds: [B, 1, D]; position_ids: [3, B, 1]. Writes the new k/v
    row of every layer at that layer's length (per row: slots of a pool
    have their own lengths), in place in ``cache.k`` / ``cache.v`` —
    quantized, with its scales, when ``cache`` is a ``QuantKVCache``.
    ``attn_impl``: None (the decode kernel on the card) or "plain" (the
    dense plain path). Returns (hidden [B, 1, D] post-norm, the cache with
    length + 1).
    """
    return lm_decode_chunk(lm, cache, inputs_embeds, position_ids,
                           attn_impl)


@torch.no_grad()
def lm_decode_chunk(lm: LanguageModel, cache, inputs_embeds, position_ids,
                    attn_impl: str | None = None):
    """Multi-token decode step: t_c rows per slot in one forward.

    inputs_embeds: [B, t_c, D]; position_ids: [3, B, t_c]. Row i's k/v is
    written in place at ``cache.length[li] + i`` of every layer (quantized
    with its scales into a ``QuantKVCache``), and row i attends to the
    cache positions < length + i + 1: causal within the chunk plus the
    committed prefix (``chunk_decode_attention``, the decode kernel on the
    card). The rows must fit: length + t_c <= T_max. Returns (hidden [B,
    t_c, D] post-norm, a cache over the same tensors with length + t_c;
    ``cache.length`` itself is not changed, so a caller that scores
    several chunks from one prefix passes the same cache each time).
    """
    cfg = lm.cfg
    quant = isinstance(cache, QuantKVCache)
    cos, sin = mrope_cos_sin(position_ids, cfg)
    x = inputs_embeds
    b, t_c = x.shape[:2]
    rows = torch.arange(b, device=x.device)[:, None]
    chunk = torch.arange(t_c, device=x.device)
    for li, p in enumerate(lm.layers):
        h = rms_norm(x, p.input_ln_scale, cfg.rms_norm_eps)
        q, k, v = _qkv(h, p, cfg)
        q, k = _apply_mrope(q, k, cos, sin)
        base = cache.length[li]  # [B]
        at = base[:, None] + chunk  # [B, t_c]
        if quant:
            k8, ks = quantize_kv(k)
            v8, vs = quantize_kv(v)
            cache.k[li, rows, at] = k8  # in place
            cache.v[li, rows, at] = v8
            cache.k_scale[li, rows, at] = ks
            cache.v_scale[li, rows, at] = vs
            scales = dict(k_scale=cache.k_scale[li],
                          v_scale=cache.v_scale[li])
        else:
            cache.k[li, rows, at] = k  # in place
            cache.v[li, rows, at] = v
            scales = {}
        attn = chunk_decode_attention(q, cache.k[li], cache.v[li], base,
                                      impl=attn_impl, **scales)
        x = x + _dense(attn.reshape(b, t_c, -1), p, "o_kernel")
        h = rms_norm(x, p.post_ln_scale, cfg.rms_norm_eps)
        x = x + _mlp(h, p)
    x = rms_norm(x, lm.final_ln_scale, cfg.rms_norm_eps)
    return x, dataclasses.replace(cache, length=cache.length + t_c)


def embed_tokens(lm: LanguageModel, input_ids: torch.Tensor) -> torch.Tensor:
    return lm.embed_tokens[input_ids]


def lm_head(lm: LanguageModel, hidden: torch.Tensor) -> torch.Tensor:
    """[.., D] -> [.., V] fp32 logits. bf16 products are exact in fp32, so
    upcasting both operands gives the reference's bf16-in / fp32-accumulate
    result."""
    if lm.cfg.tie_word_embeddings:
        return F.linear(hidden.float(), lm.embed_tokens.float())
    return hidden.float() @ lm.lm_head_kernel.float()


def init_lm_params(cfg: TextConfig, generator: torch.Generator, device,
                   dtype) -> LanguageModel:
    """Random init with the reference's scales (std 0.02, norms ones)."""
    lm = LanguageModel(cfg, device, dtype)
    init_random_(lm, generator, std=0.02)
    return lm


def init_kv_cache(cfg: TextConfig, batch: int, max_len: int, device,
                  dtype, quant: bool = False):
    """A zeroed ``KVCache`` of ``dtype``, or a ``QuantKVCache`` (int8 with
    f32 scales) when ``quant``."""
    shape = (cfg.num_hidden_layers, batch, max_len, cfg.num_key_value_heads,
             cfg.head_dim)
    length = torch.zeros((cfg.num_hidden_layers, batch), dtype=torch.int64,
                         device=device)
    if quant:
        return QuantKVCache(
            k=torch.zeros(shape, device=device, dtype=torch.int8),
            v=torch.zeros(shape, device=device, dtype=torch.int8),
            k_scale=torch.zeros(shape[:4], device=device),
            v_scale=torch.zeros(shape[:4], device=device), length=length)
    return KVCache(k=torch.zeros(shape, device=device, dtype=dtype),
                   v=torch.zeros(shape, device=device, dtype=dtype),
                   length=length)
