"""Qwen2.5 decoder (GQA + M-RoPE), and the Qwen3 text model of
LLaVA-OneVision-1.5 through its config flags.

Counterpart of ``visionselector_tpu.models.qwen25vl.lm`` (bf16 / fp32
weights; weight quantization, LoRA and the MoE variant are not ported
yet):

- Qwen3 flags: ``head_dim_override``; ``qk_norm`` (a per-head RMSNorm of
  q and k after the head reshape and before the rotary, with ``q_norm_scale``
  / ``k_norm_scale`` [head_dim]); no q/k/v biases without
  ``attention_bias``; ``mrope`` off gives plain 1-D rope (every rotary
  channel reads axis 0 of the position ids),

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
        shapes = {
            "input_ln_scale": (d,), "post_ln_scale": (d,),
            "q_kernel": (d, hq * dh), "k_kernel": (d, hkv * dh),
            "v_kernel": (d, hkv * dh), "o_kernel": (hq * dh, d),
            "gate_kernel": (d, i), "up_kernel": (d, i),
            "down_kernel": (i, d),
        }
        if cfg.attention_bias:
            shapes.update(q_bias=(hq * dh,), k_bias=(hkv * dh,),
                          v_bias=(hkv * dh,))
        if cfg.qk_norm:
            shapes.update(q_norm_scale=(dh,), k_norm_scale=(dh,))
        add_params(self, shapes, device, dtype)


class LanguageModel(nn.Module):
    """Token embedding, decoder layers, final norm (tied lm head)."""

    def __init__(self, cfg: TextConfig, device, dtype):
        super().__init__()
        if cfg.num_experts:
            raise NotImplementedError(
                "the MoE text model (num_experts > 0) is not ported yet "
                "(ROADMAP §1 item 8, its MoE part)")
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
    of the doubled ``mrope_section`` chunks reads axis ``chunk % 3``). With
    ``mrope`` off (Qwen3) every channel reads axis 0: plain 1-D rope."""
    if not cfg.mrope:
        return torch.zeros(cfg.head_dim, dtype=torch.int64, device=device)
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
    """q [B, T, H, Dh], k and v [B, T, H_kv, Dh] before the rotary: biases
    under ``attention_bias``, the per-head RMSNorm of q and k under
    ``qk_norm``. Every decoder function computes its q, k, v here."""
    b, t, _ = x.shape
    dh = cfg.head_dim
    q = _dense(x, p, "q_kernel")
    k = _dense(x, p, "k_kernel")
    v = _dense(x, p, "v_kernel")
    if cfg.attention_bias:
        q, k, v = q + p.q_bias, k + p.k_bias, v + p.v_bias
    q = q.view(b, t, cfg.num_attention_heads, dh)
    k = k.view(b, t, cfg.num_key_value_heads, dh)
    v = v.view(b, t, cfg.num_key_value_heads, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm_scale, cfg.rms_norm_eps)
        k = rms_norm(k, p.k_norm_scale, cfg.rms_norm_eps)
    return q, k, v


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


def lm_prefill_layers(lm: LanguageModel, layers, inputs_embeds,
                      position_ids, seg_ids, attn_impl: str | None = None,
                      attn_variant: str | None = None, remat: bool = False
                      ) -> Tuple[torch.Tensor,
                                 Tuple[torch.Tensor, torch.Tensor]]:
    """Decoder layers ``layers`` (a ``range`` of layer indices: the whole
    stack, or a contiguous part of it for the two-stage LLM-side prefill)
    over a full sequence, no final norm. Arguments as ``lm_prefill``'s.

    Returns (hidden [B, T, D] after the last of ``layers``, (k, v) each
    [len(layers), B, T, H_kv, Dh]). Raises ValueError when ``layers``
    reaches past the stack: the reference clamps such an index to the
    last layer, which the port does not copy.
    """
    cfg = lm.cfg
    n = len(lm.layers)
    if len(layers) and (min(layers) < 0 or max(layers) >= n):
        raise ValueError(f"decoder layers {layers} out of range for a "
                         f"{n}-layer model")
    cos, sin = mrope_cos_sin(position_ids, cfg)
    x = inputs_embeds
    packed = attn_variant == "packed" and cfg.head_dim % 128 == 0
    ks, vs = [], []
    for li in layers:
        args = (x, lm.layers[li], cos, sin, seg_ids, cfg, packed, attn_impl)
        if remat:
            x, k, v = torch.utils.checkpoint.checkpoint(
                _prefill_layer, *args, use_reentrant=False)
        else:
            x, k, v = _prefill_layer(*args)
        ks.append(k)
        vs.append(v)
    if not ks:  # an empty range: no cache rows
        b, t = x.shape[:2]
        empty = x.new_zeros(0, b, t, cfg.num_key_value_heads, cfg.head_dim)
        return x, (empty, empty)
    return x, (torch.stack(ks), torch.stack(vs))


def lm_prefill(lm: LanguageModel, inputs_embeds, position_ids, seg_ids,
               attn_impl: str | None = None, attn_variant: str | None = None,
               remat: bool = False
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence forward (training and prefill): every decoder layer
    (``lm_prefill_layers``), then the final norm. Differentiable: with
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
    x, kv = lm_prefill_layers(lm, range(len(lm.layers)), inputs_embeds,
                              position_ids, seg_ids, attn_impl, attn_variant,
                              remat)
    return rms_norm(x, lm.final_ln_scale, lm.cfg.rms_norm_eps), kv


def layer_qk(lm: LanguageModel, layer_idx: int, hidden, position_ids):
    """Post-rotary (q, k) of decoder layer ``layer_idx`` given its INPUT
    hidden states [B, T, D] (the reference's ``layer_qk``: LLM-side
    compression recomputes the capture layer's attention statistics). k is
    expanded to q's head count (kv head h // n_rep for query head h).
    Returns q, k: [B, T, H, Dh]. Raises ValueError for an index outside the
    stack (the reference clamps it and reads the last layer)."""
    cfg = lm.cfg
    if not 0 <= layer_idx < len(lm.layers):
        raise ValueError(f"layer_qk: layer {layer_idx} out of range for a "
                         f"{len(lm.layers)}-layer model")
    p = lm.layers[layer_idx]
    cos, sin = mrope_cos_sin(position_ids, cfg)
    h = rms_norm(hidden, p.input_ln_scale, cfg.rms_norm_eps)
    q, k, _ = _qkv(h, p, cfg)
    q, k = _apply_mrope(q, k, cos, sin)
    n_rep = cfg.num_attention_heads // cfg.num_key_value_heads
    return q, k.repeat_interleave(n_rep, dim=2)


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
    """[.., D] -> [.., V] fp32 logits: the reference's bf16-in /
    fp32-accumulate product (its einsum with ``preferred_element_type``).

    On a CUDA tensor with no gradient to carry, one GEMM over the weight
    as it is stored with an fp32 output (``aten::mm.dtype``): no fp32 copy
    of the [D, V] weight. Elsewhere both operands are upcast (bf16
    products are exact in fp32, so the result is the same function):
    ``aten::mm.dtype`` has no CPU kernel, and on CUDA it has no derivative
    (torch 2.11), so the training head keeps the upcast."""
    tied = lm.cfg.tie_word_embeddings
    w = lm.embed_tokens.t() if tied else lm.lm_head_kernel  # [D, V]
    carries_grad = torch.is_grad_enabled() and hidden.requires_grad
    if (hidden.device.type == "cuda" and not carries_grad
            and w.dtype != torch.float32):
        flat = hidden.reshape(-1, hidden.shape[-1]).to(w.dtype)
        out = torch.mm(flat, w, out_dtype=torch.float32)
        return out.reshape(*hidden.shape[:-1], out.shape[-1])
    if tied:
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
