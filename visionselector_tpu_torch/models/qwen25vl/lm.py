"""Qwen2.5 decoder (GQA + M-RoPE), and the Qwen3 text model of
LLaVA-OneVision-1.5 through its config flags.

Counterpart of ``visionselector_tpu.models.qwen25vl.lm`` (bf16 / fp32
weights, LoRA adapters from ``train.lora``, weight-only quantization, the
Qwen3-MoE MLP of LLaVA-OneVision-1.5's MoE variant):

- weight-only quantization (``--quantize``: ``apply_weight_quantization``,
  ``quantize_lm_params``, ``init_lm_params_int8``): each of a layer's seven
  matmul kernels (``QUANT_KERNELS``) becomes int8 ``[in, out]`` or packed
  int4 uint8 ``[in, out / 2]`` (``pack_int4`` along the output axis) with
  an fp32 ``<name>_scale``, ``[out]`` per channel or ``[G, out]`` grouped.
  They are registered as BUFFERS, not parameters: integer tensors take no
  gradient, and every loop over ``named_parameters`` (``init_random_``,
  the trainers' ``requires_grad_``, the reference-tree loader) passes them
  by. Embeddings, norms, biases and the LM head stay in the model dtype.
  ``_dense`` routes a quantized product (``kernels.wq_matmul``): decode
  rows to the weight-only GEMM kernel on the card, prefill rows and
  products under grad to the dequantize kernel's transient and
  ``torch.matmul``,
  CPU tensors to its plain version,
- the MoE MLP (``num_experts > 0``: ``router_kernel`` [D, E] and the
  stacked ``expert_{gate,up,down}_kernel`` [E, D, mi] / [E, mi, D] in
  place of the dense SwiGLU's three kernels): a softmax router in fp32,
  the top ``num_experts_per_tok`` experts per token (ties toward the lower
  expert index), renormalised under ``norm_topk_prob``; ``_moe_mlp`` runs
  each expert on the rows routed to it only, ``moe_mlp_plain`` is the
  reference's dense scan over every expert. ``--quantize`` leaves the
  router and expert kernels in the model dtype, as the reference does,
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
- tensor parallelism (``shard_lm``, Megatron-style): each rank of the
  mesh's "model" axis holds its q / k / v heads' columns and its o rows,
  its gate / up columns and down rows (an MoE layer's inside every
  expert), the vocabulary rows of the embedding and columns of the head;
  ``_prefill_layer`` and ``lm_decode_chunk`` sum the o and MLP outputs over
  the ranks, ``embed_tokens`` is a masked lookup plus a sum and ``lm_head``
  gathers the logits; ``lm.cfg`` is the rank-local config, so every
  caller runs unchanged on local heads. ``moe_mlp_ep`` splits the MoE
  layer's experts instead (expert parallelism),
- decode: length-aware attention against the KV cache (the decode kernel
  on the card), which is written in place; the cache may be bf16 / fp32,
  int8 with per-row scales, or int4 packed two values a byte with per-row
  scales (``QuantKVCache``, serving slot pools; an int4 cache takes the
  plain int4 route of ``chunk_decode_attention``, as the reference keeps
  its int4 pools off its Pallas kernel). One step takes one row per slot
  (``lm_decode_step``), a chunk t_c rows, causal within the chunk
  (``lm_decode_chunk``: multiple-choice scoring, speculative verify).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from visionselector_tpu_torch.core import collectives
from visionselector_tpu_torch.core.config import TextConfig
from visionselector_tpu_torch.core.mesh import param_sharding_rules
from visionselector_tpu_torch.core.params import add_params, init_random_
from visionselector_tpu_torch.kernels import wq_matmul as wq
from visionselector_tpu_torch.kernels.attention import (
    attention,
    attention_packed,
    chunk_decode_attention,
)
from visionselector_tpu_torch.kernels.topk import stable_topk
from visionselector_tpu_torch.models.qwen25vl.vit import rms_norm, rotate_half


@dataclasses.dataclass
class KVCache:
    """Preallocated cache; decode steps write their row IN PLACE."""

    k: torch.Tensor  # [n_layers, B, T_max, H_kv, Dh]
    v: torch.Tensor  # [n_layers, B, T_max, H_kv, Dh]
    length: torch.Tensor  # [n_layers, B] int64 valid lengths


@dataclasses.dataclass
class QuantKVCache:
    """Quantized KV cache (serving slot pools): entry [l, b, t, h] stores
    ``round(x / s)`` with its scale ``s = absmax / qmax`` over the head dim
    kept beside it, qmax 127 (int8) or 7 (int4).

    int8: ``k`` / ``v`` int8 [L, B, T, H_kv, Dh], half the bytes of a bf16
    pool, read by the decode kernel as int8 with the scales folded into the
    logits and p.

    int4: torch has no int4 dtype, so ``k`` / ``v`` are uint8 [L, B, T,
    H_kv, Dh / 2], two values a byte along the head dim (``pack_int4``):
    byte j holds element 2j in its low nibble and element 2j + 1 in its
    high nibble, each a 4-bit two's complement number in [-7, 7]. A
    quarter of the bf16 pool's value bytes; read by the plain int4 route
    (``attention.decode_int4_plain``), never by the decode kernel."""

    k: torch.Tensor  # int8 [.., Dh] or packed int4 uint8 [.., Dh / 2]
    v: torch.Tensor
    k_scale: torch.Tensor  # f32 [n_layers, B, T_max, H_kv]
    v_scale: torch.Tensor  # f32 [n_layers, B, T_max, H_kv]
    length: torch.Tensor  # [n_layers, B] int64 valid lengths

    @property
    def packed(self) -> bool:
        """True for an int4 cache (two values a byte)."""
        return self.k.dtype == torch.uint8


def quantize_kv(x: torch.Tensor, bits: int = 8):
    """[..., Dh] -> (values, f32 scales over the last dim); the reference's
    per-row absmax rule, ``s = absmax / qmax + 1e-12`` and round half to
    even, with qmax 127 for ``bits`` 8 and 7 for ``bits`` 4. The values
    come back as int8 either way (in [-7, 7] for 4 bits: ``pack_int4``
    packs them for an int4 cache)."""
    if bits not in (4, 8):
        raise ValueError(f"quantize_kv: bits must be 4 or 8, got {bits}")
    xf = x.float()
    s = xf.abs().amax(dim=-1) / (7.0 if bits == 4 else 127.0) + 1e-12
    return torch.round(xf / s[..., None]).to(torch.int8), s


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-8, 7], [..., D] (D even) -> uint8 [..., D / 2]: byte
    j = (element 2j & 15) | (element 2j + 1 & 15) << 4 (the layout of
    ``QuantKVCache``)."""
    if q.shape[-1] % 2:
        raise ValueError(f"pack_int4: odd last dim {q.shape[-1]}")
    n = q.to(torch.int16) & 15
    return (n[..., 0::2] | (n[..., 1::2] << 4)).to(torch.uint8)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """uint8 [..., D / 2] -> int8 [..., D]: ``pack_int4``'s inverse (each
    nibble sign-extended from 4 bits)."""
    b = p.to(torch.int16)
    lo, hi = b & 15, b >> 4
    out = torch.stack(((lo ^ 8) - 8, (hi ^ 8) - 8), dim=-1)
    return out.reshape(*p.shape[:-1], 2 * p.shape[-1]).to(torch.int8)


def dequantize_kv(q: torch.Tensor, s: torch.Tensor, dtype) -> torch.Tensor:
    """int8 values (an int4 cache's unpacked) times their row scales."""
    return (q.float() * s[..., None].float()).to(dtype)


QUANT_KERNELS = ("q_kernel", "k_kernel", "v_kernel", "o_kernel",
                 "gate_kernel", "up_kernel", "down_kernel")


def _layer_shapes(cfg: TextConfig) -> dict:
    d, i, dh = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    hq, hkv = cfg.num_attention_heads, cfg.num_key_value_heads
    shapes = {
        "input_ln_scale": (d,), "post_ln_scale": (d,),
        "q_kernel": (d, hq * dh), "k_kernel": (d, hkv * dh),
        "v_kernel": (d, hkv * dh), "o_kernel": (hq * dh, d),
        "gate_kernel": (d, i), "up_kernel": (d, i),
        "down_kernel": (i, d),
    }
    if cfg.num_experts:  # the MoE MLP in place of the dense one
        e, mi = cfg.num_experts, cfg.moe_intermediate_size
        for name in ("gate_kernel", "up_kernel", "down_kernel"):
            del shapes[name]
        shapes.update(router_kernel=(d, e), expert_gate_kernel=(e, d, mi),
                      expert_up_kernel=(e, d, mi),
                      expert_down_kernel=(e, mi, d))
    if cfg.attention_bias:
        shapes.update(q_bias=(hq * dh,), k_bias=(hkv * dh,),
                      v_bias=(hkv * dh,))
    if cfg.qk_norm:
        shapes.update(q_norm_scale=(dh,), k_norm_scale=(dh,))
    return shapes


def quant_kernel_names(layer: nn.Module) -> tuple:
    """The matmul kernels of ``layer`` that ``--quantize`` takes: all seven
    of a dense layer, the four attention kernels of an MoE layer (its
    router and expert kernels stay in the model dtype, as the reference's
    ``quantize_lm_params`` leaves them)."""
    return tuple(n for n in QUANT_KERNELS if hasattr(layer, n))


class DecoderLayer(nn.Module):
    """One decoder layer's weights (kernels ``[in, out]``). With ``quant``
    = (bits, group_size) its matmul kernels (``quant_kernel_names``) are
    uninitialised quantized buffers (``register_quantized``) instead of
    parameters."""

    def __init__(self, cfg: TextConfig, device, dtype, quant=None):
        super().__init__()
        shapes = _layer_shapes(cfg)
        if quant:
            for name in QUANT_KERNELS:
                if name not in shapes:  # an MoE layer's MLP kernels
                    continue
                din, dout = shapes.pop(name)
                bits, group = quant
                register_quantized(
                    self, name,
                    torch.empty((din, dout // 2 if bits == 4 else dout),
                                device=device,
                                dtype=torch.uint8 if bits == 4
                                else torch.int8),
                    torch.empty((din // group, dout) if bits == 4 and group
                                else (dout,), device=device))
        add_params(self, shapes, device, dtype)


def register_quantized(layer: nn.Module, name: str, w: torch.Tensor,
                       scale: torch.Tensor) -> None:
    """Put a quantized kernel (int8, or packed int4 uint8) and its fp32
    scales on ``layer`` as the buffers ``name`` and ``name + "_scale"``,
    in place of the parameter ``name`` if it has one."""
    layer._parameters.pop(name, None)
    layer.register_buffer(name, w)
    layer.register_buffer(name + "_scale", scale)


def is_quantized(lm) -> bool:
    """Whether the decoder's matmul kernels are quantized."""
    return any(getattr(layer, name).dtype in wq.QUANT_DTYPES
               for layer in lm.layers for name in quant_kernel_names(layer))


def kernel_shape(layer: nn.Module, name: str) -> Tuple[int, int]:
    """(in, out) of a matmul kernel, quantized (packed or not) or not."""
    w = getattr(layer, name)
    if w.dtype in wq.QUANT_DTYPES:
        return w.shape[0], getattr(layer, name + "_scale").shape[-1]
    return tuple(w.shape)


class LanguageModel(nn.Module):
    """Token embedding, decoder layers (dense or, with ``num_experts > 0``,
    MoE MLPs), final norm, and an lm head (tied to the embedding or
    not)."""

    def __init__(self, cfg: TextConfig, device, dtype, quant=None):
        super().__init__()
        self.cfg = cfg
        add_params(self, {"embed_tokens": (cfg.vocab_size, cfg.hidden_size)},
                   device, dtype)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, device, dtype, quant)
            for _ in range(cfg.num_hidden_layers))
        add_params(self, {"final_ln_scale": (cfg.hidden_size,)}, device, dtype)
        if not cfg.tie_word_embeddings:
            add_params(self, {"lm_head_kernel": (cfg.hidden_size,
                                                 cfg.vocab_size)},
                       device, dtype)


def parse_quantize_spec(spec):
    """A ``--quantize`` spec as (bits, group_size), or None for no
    quantization (None, "" or "none"). Specs: ``int8`` (per output
    channel), ``int4`` (per channel), ``int4:g<N>`` (one scale per N
    inputs). Raises ValueError, with the reference's messages, for any
    other spec."""
    if not spec or spec == "none":
        return None
    m = re.fullmatch(r"int(8|4)(?::g(\d+))?", spec)
    if m is None:
        raise ValueError(
            f"bad --quantize spec {spec!r}: expected int8, int4 or int4:g<N>")
    bits, group = int(m.group(1)), int(m.group(2) or 0)
    if bits == 8 and group:
        raise ValueError("grouped scales are an int4 feature (int4:g<N>)")
    return bits, group


def apply_weight_quantization(params, spec):
    """Apply a ``--quantize`` spec to an engine's parameters (Qwen2.5-VL's
    or LLaVA-OneVision-1.5's: anything with ``.lm``): the decoder's matmul
    kernels are quantized IN PLACE, layer by layer (``quantize_lm_params``:
    the bf16 LM is not kept beside the quantized one); the vision tower,
    the scorer and the merger stay in the compute dtype. Returns
    ``params``. ``None`` or ``"none"`` leaves them as they are; a bad spec
    raises ValueError before anything changes."""
    parsed = parse_quantize_spec(spec)
    if parsed is not None:
        quantize_lm_params(params.lm, *parsed)
    return params


@torch.no_grad()
def quantize_lm_params(lm: LanguageModel, bits: int = 8,
                       group_size: int = 0) -> LanguageModel:
    """Symmetric weight-only quantization of every decoder matmul kernel
    (``quant_kernel_names``: an MoE layer's router and experts stay), in
    place (the reference's ``quantize_lm_params``, which returns a new
    tree): ``s = max(amax / qmax, 1e-12)`` by true division, values
    ``clip(round(w / s), -qmax, qmax)`` rounded half to even, qmax 127
    (``bits`` 8) or 7 (``bits`` 4, packed two a byte). Per output channel,
    or with ``bits`` 4 and ``group_size`` > 0 one scale per
    ``group_size`` inputs, scales [in / group_size, out]. Each kernel's
    fp32 copy lives only while it is quantized. Raises ValueError for
    other bits, a group size that does not divide a kernel's input width,
    or an LM already quantized, before anything changes. Returns ``lm``."""
    if bits not in (8, 4):
        raise ValueError(f"quantize_lm_params: bits must be 8 or 4, got "
                         f"{bits}")
    if is_quantized(lm):
        raise ValueError("quantize_lm_params: the LM is already quantized")
    group = group_size if bits == 4 and group_size > 0 else 0
    if group:
        for name in quant_kernel_names(lm.layers[0]):
            din = kernel_shape(lm.layers[0], name)[0]
            if din % group:
                raise ValueError(f"quantize_lm_params: group size {group} "
                                 f"does not divide {name}'s input width "
                                 f"{din}")
    qmax = 127.0 if bits == 8 else 7.0
    for layer in lm.layers:
        for name in quant_kernel_names(layer):
            wf = getattr(layer, name).float()
            din, dout = wf.shape
            if group:
                wg = wf.view(din // group, group, dout)
                scale = (wg.abs().amax(dim=1) / qmax).clamp_min(1e-12)
                q = torch.round(wg / scale[:, None, :]).clamp(-qmax, qmax)
            else:
                scale = (wf.abs().amax(dim=0) / qmax).clamp_min(1e-12)
                q = torch.round(wf / scale).clamp(-qmax, qmax)
            q = q.view(din, dout).to(torch.int8)
            del wf
            register_quantized(layer, name,
                               pack_int4(q) if bits == 4 else q, scale)
    return lm


def tp_text_config(cfg: TextConfig, tp: int) -> TextConfig:
    """The rank-local decoder config of ``tp``-way tensor parallelism:
    ``num_attention_heads / tp`` query heads, ``num_key_value_heads / tp``
    kv heads (one, replicated over ``tp / num_key_value_heads`` ranks, when
    tp exceeds them), ``intermediate_size`` (and an MoE layer's
    ``moe_intermediate_size``) over tp; the head dim is pinned. ValueError
    for a split that does not divide."""
    hq, hkv = cfg.num_attention_heads, cfg.num_key_value_heads
    widths = [("num_attention_heads", hq), ("intermediate_size",
                                            cfg.intermediate_size)]
    if cfg.num_experts:
        widths.append(("moe_intermediate_size", cfg.moe_intermediate_size))
    bad = [n for n, v in widths if v % tp]
    if (tp % hkv if tp > hkv else hkv % tp) or bad:
        raise ValueError(f"tensor parallelism over {tp} ranks does not "
                         f"split {bad or ['num_key_value_heads']} of "
                         f"{hq} / {hkv} heads")
    return dataclasses.replace(
        cfg, num_attention_heads=hq // tp,
        num_key_value_heads=max(1, hkv // tp),
        intermediate_size=cfg.intermediate_size // tp,
        moe_intermediate_size=cfg.moe_intermediate_size // tp,
        head_dim_override=cfg.head_dim)


def _slice_cols(w, s, c0: int, c1: int):
    """Columns [c0, c1) of a kernel (float, int8, or packed int4 two
    columns a byte) and of its scales (``s``: [out] or [G, out]; None)."""
    if w.dtype == torch.uint8:
        if c0 % 2 or c1 % 2:
            raise ValueError(f"a packed int4 column slice [{c0}, {c1}) must "
                             f"start and end on an even column")
        w = w[:, c0 // 2:c1 // 2]
    else:
        w = w[..., c0:c1]
    return w, None if s is None else s[..., c0:c1]


def _slice_rows(w, s, r0: int, r1: int, group: int):
    """Rows [r0, r1) (the input axis) of a kernel and its scales: per
    channel scales whole, grouped ones their groups [r0 / g, r1 / g)."""
    if s is not None and group:
        if r0 % group or r1 % group:
            raise ValueError(f"a row slice [{r0}, {r1}) of a grouped int4 "
                             f"kernel must cover whole groups of {group}")
        s = s[r0 // group:r1 // group]
    return w[..., r0:r1, :], s


@torch.no_grad()
def shard_lm(lm: LanguageModel, mesh, axis: str = "model") -> LanguageModel:
    """Megatron-style tensor parallelism of the decoder over the mesh's
    ``axis``, IN PLACE: every rank keeps only its slice of each tensor.
    Which axis of a leaf is split comes from ``mesh.param_sharding_rules``
    (the reference's rules): q / k / v / gate / up kernels by columns (an
    MoE layer's expert kernels inside every expert, along the
    intermediate axis, never the expert axis), o / down by rows, the
    embedding's vocabulary rows and the head's columns when n divides the
    vocabulary (else both whole, as the reference replicates a leaf that
    does not divide); norms and the router stay whole. Rank i of n takes
    part i of n contiguous parts, with two departures from the rules'
    contiguous split: a q / k / v bias goes with its kernel's columns
    (the reference replicates biases and GSPMD re-lays the sum out), and
    when n exceeds the kv heads each rank keeps the whole kv head its
    query heads read, the same on n / hkv ranks (the reference cuts head
    columns). ``--quantize`` buffers are sliced with their scales
    (ValueError for a packed int4 column slice that is not even, or a row
    slice of a grouped int4 kernel that does not cover whole groups,
    before anything changes). The layers and ``lm`` carry the axis's
    group (``tp``, ``tp_vocab``), which ``_prefill_layer``,
    ``lm_decode_chunk``, ``embed_tokens`` and ``lm_head`` sum or gather
    over; ``lm.cfg`` becomes ``tp_text_config``'s."""
    cfg, n, i = lm.cfg, mesh.size(axis), mesh.index(axis)
    group = mesh.groups[axis]
    local = tp_text_config(cfg, n)
    dh, hkv = cfg.head_dim, local.num_key_value_heads
    kv0 = (i * hkv if n <= cfg.num_key_value_heads
           else i // (n // cfg.num_key_value_heads))
    plan = []  # (layer, name, new tensor, new scale), checked first
    for layer in lm.layers:
        named = (dict(layer.named_parameters(recurse=False))
                 | dict(layer.named_buffers(recurse=False)))
        for name, w in named.items():
            if not name.endswith("_kernel"):  # scales and biases follow
                continue
            ax = param_sharding_rules(name, w.dim())
            if ax is None:
                continue
            s = named.get(name + "_scale")
            if ax == w.dim() - 1:  # columns, counted unpacked
                width = w.shape[-1] if s is None else s.shape[-1]
                part = ((kv0 * dh, (kv0 + hkv) * dh)
                        if name in ("k_kernel", "v_kernel")
                        else (i * width // n, (i + 1) * width // n))
                plan.append((layer, name, *_slice_cols(w, s, *part)))
                bias = name.replace("_kernel", "_bias")
                if bias in named:
                    plan.append((layer, bias, named[bias][..., slice(*part)],
                                 None))
            else:  # rows
                width = w.shape[-2]
                group_size = (width // s.shape[0]
                              if s is not None and s.dim() == 2 else 0)
                plan.append((layer, name, *_slice_rows(
                    w, s, i * width // n, (i + 1) * width // n,
                    group_size)))
    for layer, name, w, s in plan:
        _replace(layer, name, w)
        if s is not None:
            _replace(layer, name + "_scale", s)
    for layer in lm.layers:
        layer.tp = group
    if cfg.vocab_size % n == 0:
        rows = (i * cfg.vocab_size // n, (i + 1) * cfg.vocab_size // n)
        _replace(lm, "embed_tokens", lm.embed_tokens[rows[0]:rows[1]])
        if not cfg.tie_word_embeddings:
            _replace(lm, "lm_head_kernel", lm.lm_head_kernel[:, slice(*rows)])
        lm.tp_vocab = group
    lm.tp = group
    lm.cfg = local
    return lm


def _replace(module: nn.Module, name: str, t: torch.Tensor) -> None:
    """Swap a parameter's or buffer's tensor for a contiguous copy of
    ``t`` (the whole tensor it was cut from is freed)."""
    t = t.contiguous().clone()
    if name in module._parameters:
        module._parameters[name] = nn.Parameter(
            t, requires_grad=module._parameters[name].requires_grad)
    else:
        module._buffers[name] = t


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
    """x @ kernel, plus ``(x @ A) @ B * scale`` when the layer holds LoRA
    adapters for the kernel (``train.lora``; the reference's ``_dense``).
    The adapter term is added in x's dtype: the reference's fp32 scale
    leaf promotes its output to fp32, which the bf16 kernels after it do
    not take (ROADMAP section 3).

    A quantized kernel takes one of ``kernels.wq_matmul``'s routes: on the
    card, rows of a decode step (at most ``WQ_MAX_ROWS[w.dtype]``, bf16,
    no gradient to carry: ``wq.use_kernel``) the weight-only GEMM kernel;
    other rows (prefill) or a product under grad the dequantize kernel's
    transient and ``torch.matmul``; CPU tensors the plain version. Per
    channel ``(x @ q) * s``, grouped ``x @ (q * s_g)``, in x's dtype, as
    the reference."""
    w = getattr(p, name)
    if w.dtype in wq.QUANT_DTYPES:
        s = getattr(p, name + "_scale")
        if wq.use_kernel(x, w, s):
            y = wq.wq_matmul(x, w, s)
        else:
            y = wq.wq_dequant_matmul(x, w, s)
    else:
        y = x @ w
    a = p._parameters.get(name + "_lora_a")
    if a is not None:
        lora = (x @ a) @ p._parameters[name + "_lora_b"] * p.lora_scale
        y = y + lora.to(y.dtype)
    return y


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


def moe_route(x, p: DecoderLayer, cfg: TextConfig):
    """The MoE router: (top-k weights [.., k] fp32, expert ids [.., k]
    int64) of each token, the reference's ``_moe_mlp`` head: softmax of
    ``x @ router_kernel`` in fp32, the ``num_experts_per_tok`` largest
    probabilities with ties toward the lower expert index (as
    ``jax.lax.top_k``; ``topk.stable_topk``), divided by their sum under
    ``norm_topk_prob``. The weights carry the gradient of the softmax;
    the ids none."""
    probs = torch.softmax((x @ p.router_kernel).float(), dim=-1)
    topv, topi = stable_topk(probs, cfg.num_experts_per_tok)
    if cfg.norm_topk_prob:
        topv = topv / topv.sum(-1, keepdim=True)
    return topv, topi


def _moe_mlp(x, p: DecoderLayer, cfg: TextConfig):
    """The MoE MLP on the routed tokens only: for each expert in ascending
    index order, the rows routed to it (gathered), ``silu(x @ g) * (x @ u)
    @ d``, and ``y * w`` added into an output of x's dtype with
    ``index_add_``. The same function as ``moe_mlp_plain``: an unrouted
    expert's weight there is exactly 0 and its carry is also in x's dtype,
    added to in the same expert order. One host read a call (the experts'
    row counts). Carries autograd (``index_select`` / ``index_add_``)."""
    topv, topi = moe_route(x, p, cfg)
    return _moe_routed(x, topv, topi, p.expert_gate_kernel,
                       p.expert_up_kernel, p.expert_down_kernel, 0, cfg)


def _moe_routed(x, topv, topi, gate, up, down, e0: int, cfg: TextConfig):
    """``_moe_mlp``'s expert loop over experts [e0, e0 + len(gate)) whose
    kernels are ``gate`` / ``up`` / ``down`` (expert e at index e - e0);
    routing entries to other experts are left out."""
    k = cfg.num_experts_per_tok
    xf = x.reshape(-1, x.shape[-1])
    flat = topi.reshape(-1)
    order = torch.argsort(flat, stable=True)  # grouped by expert
    rows = order // k
    wts = topv.reshape(-1)[order].to(x.dtype)
    counts = torch.bincount(flat, minlength=cfg.num_experts).tolist()
    out = torch.zeros_like(xf)
    start = sum(counts[:e0])
    for j, n in enumerate(counts[e0:e0 + gate.shape[0]]):
        if n:
            r = rows[start:start + n]
            xe = xf.index_select(0, r)
            y = (F.silu(xe @ gate[j]) * (xe @ up[j])) @ down[j]
            out.index_add_(0, r, y * wts[start:start + n, None])
            start += n
    return out.view(x.shape)


def moe_mlp_ep(x, p: DecoderLayer, cfg: TextConfig, mesh,
               axis: str = "model"):
    """Expert-parallel MoE MLP (the reference's ``moe_mlp_ep``): rank i of
    the mesh's ``axis`` runs experts [i E / n, (i + 1) E / n) (the routed
    ``_moe_mlp`` restricted to those ids) on every token, and the partial
    outputs are summed over the ranks. The router is replicated. ``p``
    holds the layer's experts: all E (each rank takes its own slice, a
    view) or this rank's E / n. ValueError when n does not divide E (the
    reference asserts)."""
    n, e = mesh.size(axis), cfg.num_experts
    if e % n:
        raise ValueError(f"moe_mlp_ep: {e} experts do not split over {n} "
                         f"ranks")
    e_local = e // n
    e0 = mesh.index(axis) * e_local
    kernels = [getattr(p, name) for name in (
        "expert_gate_kernel", "expert_up_kernel", "expert_down_kernel")]
    if kernels[0].shape[0] == e:
        kernels = [w[e0:e0 + e_local] for w in kernels]
    topv, topi = moe_route(x, p, cfg)
    part = _moe_routed(x, topv, topi, *kernels, e0, cfg)
    return collectives.all_reduce(part, mesh.groups[axis])


def moe_mlp_plain(x, p: DecoderLayer, cfg: TextConfig):
    """The reference's ``_moe_mlp`` as it computes it: every expert on
    every token, scaled by the token's routing weight (0 where the expert
    is not among its top k) and accumulated in x's dtype. The plain
    version ``_moe_mlp`` is held to."""
    topv, topi = moe_route(x, p, cfg)
    out = torch.zeros_like(x)
    for e in range(cfg.num_experts):
        w = (topv * (topi == e)).sum(-1).to(x.dtype)
        y = (F.silu(x @ p.expert_gate_kernel[e])
             * (x @ p.expert_up_kernel[e])) @ p.expert_down_kernel[e]
        out = out + y * w[..., None]
    return out


def _mlp(x, p: DecoderLayer, cfg: TextConfig):
    """Dense SwiGLU, or the MoE MLP on a layer that holds a router."""
    if "router_kernel" in p._parameters:
        return _moe_mlp(x, p, cfg)
    h = F.silu(_dense(x, p, "gate_kernel")) * _dense(x, p, "up_kernel")
    return _dense(h, p, "down_kernel")


def _tp_sum(p: nn.Module, y):
    """A row-parallel output summed over the tensor-parallel ranks (``p``
    a sharded decoder layer; unsharded layers pass ``y`` through)."""
    group = getattr(p, "tp", None)
    return y if group is None else collectives.all_reduce(y, group)


def _prefill_layer(x, p: DecoderLayer, cos, sin, seg_ids, cfg: TextConfig,
                   packed: bool, attn_impl):
    """One decoder layer over the full sequence: (x out, rotated k, v).
    Under tensor parallelism the o and MLP outputs are summed over the
    ranks here (``_tp_sum``)."""
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
    x = x + _tp_sum(p, _dense(attn.reshape(b, t, -1), p, "o_kernel"))
    h = rms_norm(x, p.post_ln_scale, cfg.rms_norm_eps)
    return x + _tp_sum(p, _mlp(h, p, cfg)), k, v


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
    with its scales into a ``QuantKVCache``, packed when it is int4), and
    row i attends to the
    cache positions < length + i + 1: causal within the chunk plus the
    committed prefix (``chunk_decode_attention``, the decode kernel on the
    card). The rows must fit: length + t_c <= T_max. Under tensor
    parallelism the o and MLP outputs are summed over the ranks here.
    Returns (hidden [B,
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
            bits = 4 if cache.packed else 8
            (k8, ks), (v8, vs) = quantize_kv(k, bits), quantize_kv(v, bits)
            if cache.packed:
                k8, v8 = pack_int4(k8), pack_int4(v8)
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
        x = x + _tp_sum(p, _dense(attn.reshape(b, t_c, -1), p, "o_kernel"))
        h = rms_norm(x, p.post_ln_scale, cfg.rms_norm_eps)
        x = x + _tp_sum(p, _mlp(h, p, cfg))
    x = rms_norm(x, lm.final_ln_scale, cfg.rms_norm_eps)
    return x, dataclasses.replace(cache, length=cache.length + t_c)


def embed_tokens(lm: LanguageModel, input_ids: torch.Tensor) -> torch.Tensor:
    """Token embeddings; with the vocabulary split over tensor-parallel
    ranks (``shard_lm``) each rank looks up the ids in its rows (zeros
    elsewhere) and the ranks' rows are summed: exactly one rank's is not
    zero, so the sum is the row itself."""
    group = getattr(lm, "tp_vocab", None)
    if group is None:
        return lm.embed_tokens[input_ids]
    n = lm.embed_tokens.shape[0]
    local = input_ids - dist.get_rank(group) * n
    inside = (local >= 0) & (local < n)
    rows = lm.embed_tokens[local.clamp(0, n - 1)]
    return collectives.all_reduce(
        torch.where(inside[..., None], rows, torch.zeros_like(rows)), group)


def lm_head(lm: LanguageModel, hidden: torch.Tensor,
            upcast: bool = False) -> torch.Tensor:
    """[.., D] -> [.., V] fp32 logits: the reference's bf16-in /
    fp32-accumulate product (its einsum with ``preferred_element_type``).

    On a CUDA tensor with no gradient to carry, one GEMM over the weight
    as it is stored with an fp32 output (``aten::mm.dtype``): no fp32 copy
    of the [D, V] weight. Elsewhere both operands are upcast (bf16
    products are exact in fp32, so the result is the same function):
    ``aten::mm.dtype`` has no CPU kernel, and on CUDA it has no derivative
    (torch 2.11), so the training head keeps the upcast. ``upcast=True``
    takes the upcast route in any case: the DPO / GRPO reference policy's
    no-grad forward then computes bit for bit what the trained forward
    does. With the vocabulary split over tensor-parallel ranks each rank
    computes its columns and the logits are gathered in rank order, so
    an argmax breaks ties toward the lower id as on one device."""
    group = getattr(lm, "tp_vocab", None)
    if group is not None:
        return collectives.all_gather(_head(lm, hidden, upcast), group,
                                      dim=-1)
    return _head(lm, hidden, upcast)


def _head(lm: LanguageModel, hidden, upcast: bool):
    tied = lm.cfg.tie_word_embeddings
    w = lm.embed_tokens.t() if tied else lm.lm_head_kernel  # [D, V]
    carries_grad = torch.is_grad_enabled() and hidden.requires_grad
    if (hidden.device.type == "cuda" and not carries_grad and not upcast
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


@torch.no_grad()
def init_lm_params_int8(cfg: TextConfig, generator: torch.Generator, device,
                        dtype, bits: int = 8) -> LanguageModel:
    """Random LM built directly with int8 (or packed int4) matmul kernels,
    never holding bf16 ones (the reference's ``init_lm_params_int8``):
    uniform ints in [-qmax, qmax] with one per-channel scale, 0.02 over
    their std, so the dequantized weights have std 0.02; the other
    tensors as ``init_lm_params``."""
    if bits not in (8, 4):
        raise ValueError(f"init_lm_params_int8: bits must be 8 or 4, got "
                         f"{bits}")
    qmax = 127 if bits == 8 else 7
    scale = 0.02 / float(np.sqrt(((2 * qmax + 1) ** 2 - 1) / 12.0))
    lm = LanguageModel(cfg, device, dtype, quant=(bits, 0))
    init_random_(lm, generator, std=0.02)
    for layer in lm.layers:
        for name in quant_kernel_names(layer):
            din, dout = kernel_shape(layer, name)
            q = torch.randint(-qmax, qmax + 1, (din, dout),
                              generator=generator, device=device,
                              dtype=torch.int8)
            getattr(layer, name).copy_(pack_int4(q) if bits == 4 else q)
            getattr(layer, name + "_scale").fill_(scale)
    return lm


def init_kv_cache(cfg: TextConfig, batch: int, max_len: int, device,
                  dtype, quant=False):
    """A zeroed ``KVCache`` of ``dtype``, or a ``QuantKVCache`` with f32
    scales: int8 when ``quant`` is True or "int8", packed int4 when it is
    "int4"."""
    shape = (cfg.num_hidden_layers, batch, max_len, cfg.num_key_value_heads,
             cfg.head_dim)
    length = torch.zeros((cfg.num_hidden_layers, batch), dtype=torch.int64,
                         device=device)
    if quant not in (False, None, True, "int8", "int4"):
        raise ValueError(f"init_kv_cache: quant must be False, True, 'int8' "
                         f"or 'int4', got {quant!r}")
    if quant:
        vals, vdt = shape, torch.int8
        if quant == "int4":  # two values a byte along the head dim
            vals, vdt = shape[:4] + (cfg.head_dim // 2,), torch.uint8
        return QuantKVCache(
            k=torch.zeros(vals, device=device, dtype=vdt),
            v=torch.zeros(vals, device=device, dtype=vdt),
            k_scale=torch.zeros(shape[:4], device=device),
            v_scale=torch.zeros(shape[:4], device=device), length=length)
    return KVCache(k=torch.zeros(shape, device=device, dtype=dtype),
                   v=torch.zeros(shape, device=device, dtype=dtype),
                   length=length)
