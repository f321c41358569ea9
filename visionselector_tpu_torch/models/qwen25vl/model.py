"""Qwen2.5-VL end-to-end model: vision encode -> (select) -> prefill -> decode.

Counterpart of ``visionselector_tpu.models.qwen25vl.model`` for requests
with images (one or several), a video, images and a video, or text only.
Image pixel rows come first, then video rows, through one ViT call. The
host computes the data-dependent index arrays (vision batch, image / text
positions, M-RoPE ids, bucket choices) exactly as the reference engine
does, and the device runs

  _prefill:      ViT -> LIS scorer -> hard top-k -> sequence compaction ->
                 causal prefill over the valid-prefix compacted sequence ->
                 first token,
  _prefill_text: causal prefill of a text-only request,
  _decode:       one token against the KV cache (written in place),

and, for the training-free strategies (``selector.baselines``),

  _vision_stats -> host strategy -> _prefill_from_vision: the ViT-side
                 baselines (the ViT's last block also returns each key's
                 received attention and its keys),
  _stage_a_from_vision -> host strategy -> _stage_b: FastV / DART /
                 Dynamic-Qwen,
                 decoder layers [0, target) over the whole sequence, then
                 [target, n) over the kept one (per-layer cache lengths),

then a decode loop with early EOS exit: greedy, or temperature / top-k /
top-p sampling, with an optional repetition penalty. Sampling noise comes
from a ``torch.Generator`` seeded from the request's ``seed``: each decode
step draws one vocabulary-sized Gumbel vector from it, so a request's
rollout does not depend on what else shares a batch (``continuous.py``).

Scoring (the evaluation harness's ``loglikelihood`` requests):
``QwenVLEngine.loglikelihood`` prefills context + continuation once and
reads the continuation's log-probs from the prefill's hidden states;
``run_loglikelihood_choices`` prefills a context once and scores each
choice with one chunked decode forward (``lm.lm_decode_chunk``).

Serving: streaming (``generate(on_token_chunk=)``), decode-batched
generation (``generate_batch``), segmented admission prefills for the
continuous batcher (``start_chunked_prefill`` -> ``ChunkedPrefill``),
multi-turn chat sessions and the cross-request prefix cache, the last two
through chunked appends (``lm_decode_chunk``).

Speculative decoding (the last section): ``generate_speculative`` proposes
m tokens by prompt lookup and verifies them in one ``lm_decode_chunk`` of
m + 1 rows (the decode kernel at t_c = m + 1), greedy or by the
speculative-sampling rule; the batcher's speculative slots share its
pieces (``_verify_logits``, ``_greedy_accept``, ``_nucleus_probs``,
``_spec_accept``).
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import time
from types import SimpleNamespace
from typing import List, Optional, Protocol, Tuple

import numpy as np
import torch
import torch.distributed
import torch.nn.functional as F
from torch import nn

from visionselector_tpu_torch.core import collectives
from visionselector_tpu_torch.core.config import OVConfig, VLConfig
from visionselector_tpu_torch.core.params import init_random_
from visionselector_tpu_torch.models.qwen25vl import lm as lm_mod
from visionselector_tpu_torch.models.qwen25vl import vit as vit_mod
from visionselector_tpu_torch.preprocess.indices import (
    aligned_window_len,
    build_vision_batch,
    pick_bucket,
)
from visionselector_tpu_torch.preprocess.rope import get_rope_index
from visionselector_tpu_torch.selector.scorer import Scorer
from visionselector_tpu_torch.selector.select import (
    Selection,
    compact_sequence,
    select_hard,
)

# Same buckets as the reference engine (dropping them waits on a
# measurement of what they cost here).
VISION_BUCKETS = (512, 1024, 2048, 4096, 6144, 8192, 16384)
TEXT_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096)


class VLMParams(Protocol):
    """What the shared decoder-side helpers read of a family's weights
    (``QwenVLParams``, ``llava_ov15.model.OVParams``): the decoder and the
    optional scorer, never the vision tower."""

    lm: lm_mod.LanguageModel
    scorer: Optional[Scorer]


class VLMEngine(Protocol):
    """What the shared serving helpers (batched decode, scoring, sessions,
    the prefix cache, ``continuous.ContinuousBatcher``) read of an engine
    (``QwenVLEngine``, ``llava_ov15.model.OVEngine``): ``cfg.text`` and the
    token ids, ``params.lm`` / ``params.scorer``, the device, the attention
    path, the strategy, and ``generate(..., _defer_decode=True)``."""

    cfg: object
    params: VLMParams
    device: torch.device
    attn_impl: Optional[str]
    strategy: object

    def generate(self, input_ids, *args, **kwargs): ...


class QwenVLParams(nn.Module):
    """All weights: vision tower, decoder, optional LIS scorer (fp32)."""

    def __init__(self, visual: vit_mod.VisionTower, lm: lm_mod.LanguageModel,
                 scorer: Optional[Scorer] = None):
        super().__init__()
        self.visual = visual
        self.lm = lm
        self.scorer = scorer


def init_params(cfg: VLConfig, generator: torch.Generator, device,
                dtype: torch.dtype | None = None,
                with_selector: bool = True) -> QwenVLParams:
    """Random weights drawn from ``generator`` (on ``device``) with the
    reference's scales: std 0.02 for matmul kernels and embeddings, ones
    for norm scales, zeros for biases; the scorer in fp32 with std
    ``SelectorConfig.init_scale``."""
    dtype = dtype or cfg.torch_dtype
    visual = vit_mod.init_vit_params(cfg.vision, generator, device, dtype)
    lm = lm_mod.init_lm_params(cfg.text, generator, device, dtype)
    scorer = None
    if with_selector:
        sel = cfg.selector or cfg.with_selector().selector
        scorer = Scorer(sel, device)
        init_random_(scorer, generator, std=sel.init_scale)
    return QwenVLParams(visual, lm, scorer)


def _compact_stage(params: QwenVLParams, k_max: int,
                   use_selector: bool, vb: dict, num_merged: int, k: int,
                   input_ids, image_positions, text_positions,
                   num_text: int, position_ids_orig, attn_impl=None,
                   attn_variant=None):
    """ViT -> selection -> compaction (no decoder layers). Under "packed"
    the ViT's padded heads pick the packed layout themselves."""
    vision_embeds = vit_mod.vit_forward(
        params.visual, attn_impl=attn_impl,
        attn_variant="fused" if attn_variant == "fused" else None, **vb)
    return _select_and_compact(
        params, k_max, use_selector, vision_embeds, num_merged, k,
        input_ids, image_positions, text_positions, num_text,
        position_ids_orig)


def _select_and_compact(params: VLMParams, k_max: int,
                        use_selector: bool, vision_embeds, num_merged: int,
                        k: int, input_ids, image_positions, text_positions,
                        num_text: int, position_ids_orig):
    """Selection + sequence compaction given merged vision embeddings."""
    text_embeds = lm_mod.embed_tokens(params.lm, input_ids)  # [T_orig, D]
    if use_selector:
        selection = select_hard(params.scorer, vision_embeds, num_merged, k,
                                k_max)
    else:
        # keep everything: identity "selection" over all L_pad slots
        n_pad = vision_embeds.shape[0]
        idx = torch.arange(k_max, dtype=torch.int32,
                           device=vision_embeds.device)
        valid = idx < num_merged
        selection = Selection(
            indices=torch.where(valid, idx, n_pad), valid=valid,
            scores=torch.zeros(n_pad, dtype=torch.float32,
                               device=vision_embeds.device),
            k=num_merged)
    comp = compact_sequence(text_embeds, vision_embeds, selection,
                            image_positions, text_positions, num_text,
                            position_ids_orig)
    return comp, selection


def _prefill_core(params: QwenVLParams, k_max: int,
                  use_selector: bool, vb: dict, num_merged: int, k: int,
                  input_ids, image_positions, text_positions, num_text: int,
                  position_ids_orig, attn_impl=None, attn_variant=None):
    """ViT -> selection -> compaction -> LM. Returns (hidden, comp,
    selection, (k_layers, v_layers))."""
    comp, selection = _compact_stage(
        params, k_max, use_selector, vb, num_merged, k, input_ids,
        image_positions, text_positions, num_text, position_ids_orig,
        attn_impl, attn_variant)
    hidden, kv = lm_mod.lm_prefill(
        params.lm, comp.embeds[None], comp.position_ids[:, None, :],
        comp.seg_ids[None], attn_impl=attn_impl, attn_variant=attn_variant)
    return hidden, comp, selection, kv


@torch.no_grad()
def _prefill(params: QwenVLParams, k_max: int,
             use_selector: bool, vb: dict, num_merged: int, k: int,
             input_ids, image_positions, text_positions, num_text: int,
             position_ids_orig, attn_impl=None, attn_variant=None):
    """Returns (next_token, selection indices, valid, scores, compacted
    valid_len, (k_layers, v_layers), logits row)."""
    hidden, comp, selection, kv = _prefill_core(
        params, k_max, use_selector, vb, num_merged, k, input_ids,
        image_positions, text_positions, num_text, position_ids_orig,
        attn_impl, attn_variant)
    logits = lm_mod.lm_head(params.lm, hidden[0, comp.valid_len - 1])
    next_token = torch.argmax(logits, dim=-1)
    return (next_token, selection.indices, selection.valid, selection.scores,
            comp.valid_len, kv, logits)


def _score_continuation(params: VLMParams, hidden, valid_len: int,
                        cont_ids, cont_len: int, c_max: int):
    """Sum of the log-probs of the last ``cont_len`` tokens of the
    (compacted) sequence, whose ids are ``cont_ids[:cont_len]``, and whether
    each is the argmax: (ll, greedy) 0-d tensors.

    The compacted layout sorts real tokens by original position with
    padding after, so the continuation (a text suffix that compaction
    always keeps) sits at positions [valid_len - cont_len, valid_len) of
    the compacted sequence; token i is predicted by the hidden state one
    position earlier. ``valid_len`` is the compacted length, not the
    original one."""
    dev = hidden.device
    c_idx = torch.arange(c_max, device=dev)
    pos = valid_len - cont_len + c_idx  # continuation token positions
    valid = c_idx < cont_len
    logits = lm_mod.lm_head(params.lm, hidden[0, (pos - 1).clamp(min=0)])
    logp = torch.log_softmax(logits, dim=-1)
    ids = cont_ids.long()
    tok_lp = logp.gather(-1, ids[:, None])[:, 0]
    ll = torch.where(valid, tok_lp, 0.0).sum()
    greedy = torch.where(valid, logits.argmax(-1) == ids, True).all()
    return ll, greedy


@torch.no_grad()
def _prefill_ll(params: QwenVLParams, k_max: int, use_selector: bool,
                c_max: int, vb: dict, num_merged: int, k: int, input_ids,
                image_positions, text_positions, num_text: int,
                position_ids_orig, cont_ids, cont_len: int, attn_impl=None,
                attn_variant=None):
    """Loglikelihood prefill: (sum log-prob of the continuation, greedy).
    The whole prompt (context + continuation) is prefilled once; the
    vision tokens are selected (or not, for ``orig``) as in generation."""
    hidden, comp, _, _ = _prefill_core(
        params, k_max, use_selector, vb, num_merged, k, input_ids,
        image_positions, text_positions, num_text, position_ids_orig,
        attn_impl, attn_variant)
    return _score_continuation(params, hidden, comp.valid_len, cont_ids,
                               cont_len, c_max)


def _vision_stats(params: QwenVLParams, vb: dict, attn_impl=None):
    """ViT forward with the last block's attention statistics (the
    ViT-side baselines): (merged [L_pad, D], recv [L_pad], keys [L_pad,
    H * dp])."""
    return vit_mod.vit_forward_stats(params.visual, attn_impl=attn_impl,
                                     **vb)


def _from_vision_core(params: VLMParams, vision_embeds, indices, valid,
                      k: int, input_ids, image_positions, text_positions,
                      num_text: int, position_ids_orig, attn_impl=None):
    """Compaction of externally selected vision tokens + causal prefill:
    (hidden [1, T, D], comp, (k_layers, v_layers)). Family-agnostic: it
    takes merged vision embeddings from any tower."""
    text_embeds = lm_mod.embed_tokens(params.lm, input_ids)
    selection = Selection(
        indices=indices.to(torch.int32), valid=valid,
        scores=torch.zeros(vision_embeds.shape[0], dtype=torch.float32,
                           device=vision_embeds.device), k=k)
    comp = compact_sequence(text_embeds, vision_embeds, selection,
                            image_positions, text_positions, num_text,
                            position_ids_orig)
    hidden, kv = lm_mod.lm_prefill(
        params.lm, comp.embeds[None], comp.position_ids[:, None, :],
        comp.seg_ids[None], attn_impl=attn_impl)
    return hidden, comp, kv


@torch.no_grad()
def _prefill_from_vision(params: VLMParams, vision_embeds, indices,
                         valid, k: int, input_ids, image_positions,
                         text_positions, num_text: int, position_ids_orig,
                         attn_impl=None):
    """Compaction + causal prefill given vision tokens a training-free
    strategy selected (``vision_embeds`` [L_pad, D] with its replacement
    embeddings written in; ``indices`` [k_max] ascending, sentinel L_pad
    where ``valid`` is False). Returns (next_token, compacted valid_len,
    (k_layers, v_layers), logits row)."""
    hidden, comp, kv = _from_vision_core(
        params, vision_embeds, indices, valid, k, input_ids, image_positions,
        text_positions, num_text, position_ids_orig, attn_impl)
    logits = lm_mod.lm_head(params.lm, hidden[0, comp.valid_len - 1])
    return torch.argmax(logits, dim=-1), comp.valid_len, kv, logits


@torch.no_grad()
def _prefill_from_vision_ll(params: VLMParams, c_max: int, vision_embeds,
                            indices, valid, k: int, input_ids,
                            image_positions, text_positions, num_text: int,
                            position_ids_orig, cont_ids, cont_len: int,
                            attn_impl=None):
    """Loglikelihood over the from-vision prefill (the OV family, whose
    tower runs on its own): (sum log-prob of the continuation, greedy)."""
    hidden, comp, _ = _from_vision_core(
        params, vision_embeds, indices, valid, k, input_ids, image_positions,
        text_positions, num_text, position_ids_orig, attn_impl)
    return _score_continuation(params, hidden, comp.valid_len, cont_ids,
                               cont_len, c_max)


def capture_layer(target: int, capture: str, n_layers: int) -> int:
    """The decoder layer whose statistics an LLM-side strategy reads: FastV
    the attention of layer target - 1, DART (and Dynamic-Qwen) the keys or
    hidden states at layer target. Raises ValueError when that layer is not
    in the stack: the reference clamps a static out-of-range index (on a
    2-layer model DART's target 2 reads layer 1's weights and stage B runs
    no layer), which the port does not copy."""
    cap = target - 1 if capture == "fastv" else target
    if capture not in ("fastv", "dart") or not 0 <= cap < n_layers:
        raise ValueError(
            f"LLM-side strategy: capture {capture!r} at target layer "
            f"{target} reads layer {cap}, outside the {n_layers}-layer "
            f"decoder")
    return cap


@torch.no_grad()
def _stage_a_from_vision(params: VLMParams, target: int, capture: str,
                         vision_embeds, num_merged: int, input_ids,
                         image_positions, text_positions, num_text: int,
                         position_ids_orig, attn_impl=None):
    """LLM-side compression, stage A, given merged vision embeddings from
    any tower: decoder layers [0, target) over the whole (uncompressed)
    sequence with the capture layer's statistics.

    FastV ranks image positions by the attention they receive in layer
    target - 1 (``capture="fastv"``); DART picks pivots by key L1 norm at
    layer target (``capture="dart"``, which Dynamic-Qwen shares for its
    hidden states). Both then gather the sequence at layer ``target``.
    The reference also computes the attention column sum under "dart",
    where nothing reads it; the port skips it there (None).

    Returns (hidden at layer target's input [1, T, D], (k_a, v_a) for
    layers [0, target) each [target, 1, T, H_kv, Dh], fastv_scores [T] or
    None, key_l1 [T] (|k| summed over the GQA-expanded heads, so each kv
    head counts n_rep times, as in the reference), the valid length,
    position ids [3, T], the selected positions [T]). On a
    tensor-parallel decoder both statistics are summed over the ranks'
    heads.
    """
    n_pad = vision_embeds.shape[0]
    comp, _ = _select_and_compact(
        params, n_pad, False, vision_embeds, num_merged, num_merged,
        input_ids, image_positions, text_positions, num_text,
        position_ids_orig)
    cfg = params.lm.cfg
    cap = capture_layer(target, capture, cfg.num_hidden_layers)
    pos, seg = comp.position_ids[:, None, :], comp.seg_ids[None]
    hidden, (k_a, v_a) = lm_mod.lm_prefill_layers(
        params.lm, range(cap), comp.embeds[None], pos, seg, attn_impl)
    q_cap, k_cap = lm_mod.layer_qk(params.lm, cap, hidden, pos)
    key_l1 = k_cap[0].float().abs().sum(dim=(1, 2))
    group = getattr(params.lm, "tp", None)  # local heads: sum over ranks
    if group is not None:
        key_l1 = collectives.all_reduce(key_l1, group)
    fastv_scores = None
    if capture == "fastv":
        fastv_scores = _fastv_attention_colsum(
            q_cap[0], k_cap[0], comp.seg_ids, cfg.head_dim**-0.5)
        if group is not None:  # a mean over each rank's equal head count
            fastv_scores = collectives.all_reduce(
                fastv_scores, group) / torch.distributed.get_world_size(group)
        # the capture layer itself, to reach layer target's input
        hidden, (k1, v1) = lm_mod.lm_prefill_layers(
            params.lm, range(cap, target), hidden, pos, seg, attn_impl)
        k_a, v_a = torch.cat([k_a, k1]), torch.cat([v_a, v1])
    return (hidden, (k_a, v_a), fastv_scores, key_l1, comp.valid_len,
            comp.position_ids, comp.selected_positions)


def _fastv_attention_colsum(q, k, seg_ids, scale, block: int = 128,
                            fault=None):
    """Mean attention received per key under the causal masked softmax,
    streamed over query blocks of ``block`` rows (the FastV capture without
    the [H, T, T] map; plain fp32 PyTorch, as the reference computes it
    outside any Pallas kernel).

    q, k: [T, H, D] (k expanded to q's heads); seg_ids: [T] (0 = padding).
    Returns [T] fp32: the softmax probabilities, masked to causal pairs
    between valid positions, averaged over heads and summed over the valid
    queries, over the valid query count. ``fault="no_causal"`` drops the
    causal mask (a planted error for checks that must catch it).
    """
    t = q.shape[0]
    valid = seg_ids > 0
    kf = k.float()
    ki = torch.arange(t, device=q.device)
    colsum = torch.zeros(t, dtype=torch.float32, device=q.device)
    for q0 in range(0, t, block):
        q1 = min(t, q0 + block)
        logits = torch.einsum("bhd,khd->hbk", q[q0:q1].float(), kf) * scale
        mask = valid[None, :] & valid[q0:q1, None]
        if fault != "no_causal":
            mask = mask & (ki[q0:q1, None] >= ki[None, :])
        probs = torch.softmax(torch.where(mask[None], logits, -1e30), dim=-1)
        probs = torch.where(mask[None], probs, 0.0)
        colsum += probs.mean(dim=0).sum(dim=0)
    return colsum / valid.sum().clamp(min=1)


@torch.no_grad()
def _stage_b(params: VLMParams, target: int, hidden, position_ids_full,
             keep_indices, keep_valid_len: int, attn_impl=None):
    """LLM-side compression, stage B: gather the sequence at layer
    ``target`` (``keep_indices`` [T_keep] ascending positions into the
    stage-A sequence, sentinel T for padding: a zero row at position 0),
    then layers [target, n), the final norm and the head. Returns
    (next_token, (k_b, v_b) each [n - target, 1, T_keep, H_kv, Dh], logits
    row)."""
    lm = params.lm
    h_pad = torch.cat([hidden[0], torch.zeros_like(hidden[0, :1])])
    h_comp = h_pad[keep_indices][None]
    pos_comp = F.pad(position_ids_full, (0, 1))[:, keep_indices]
    t_keep = keep_indices.shape[0]
    seg = (torch.arange(t_keep, device=hidden.device)
           < keep_valid_len).to(torch.int32)
    x, kv = lm_mod.lm_prefill_layers(
        lm, range(target, len(lm.layers)), h_comp, pos_comp[:, None, :],
        seg[None], attn_impl)
    x = vit_mod.rms_norm(x, lm.final_ln_scale, lm.cfg.rms_norm_eps)
    logits = lm_mod.lm_head(lm, x[0, keep_valid_len - 1])
    return torch.argmax(logits, dim=-1), kv, logits


def ll_continuation_arrays(continuation_ids):
    """(cont_padded [c_max] int64, c, c_max) for loglikelihood scoring:
    c_max is c rounded up to a multiple of 16, at least 16."""
    continuation_ids = np.asarray(continuation_ids).reshape(-1)
    c = len(continuation_ids)
    if c == 0:
        raise ValueError("empty continuation")
    c_max = max(16, -(-c // 16) * 16)
    cont_padded = np.zeros(c_max, np.int64)
    cont_padded[:c] = continuation_ids
    return cont_padded, c, c_max


def _text_inputs(input_ids, text_buckets, device):
    """A text-only request's prefill inputs, right-padded to its bucket (a
    multiple of 128): ids [T_pad], 1-D positions on all three M-RoPE axes
    [3, T_pad], segment ids [T_pad] (1 on the ids, 0 after)."""
    t_orig = len(input_ids)
    t_bucket = pick_bucket(t_orig, list(text_buckets))
    t_bucket += (-t_bucket) % 128
    ids_padded = np.zeros(t_bucket, np.int64)
    ids_padded[:t_orig] = input_ids
    pos = np.zeros((3, t_bucket), np.int64)
    pos[:, :t_orig] = np.arange(t_orig)
    seg = (np.arange(t_bucket) < t_orig).astype(np.int32)
    return tuple(torch.as_tensor(x, device=device)
                 for x in (ids_padded, pos, seg))


def _text_prefill(params: VLMParams, input_ids, position_ids, seg_ids,
                  attn_impl=None, attn_variant=None):
    """Causal prefill with no vision branch: (hidden [1, T, D], (k_layers,
    v_layers))."""
    embeds = lm_mod.embed_tokens(params.lm, input_ids)
    return lm_mod.lm_prefill(params.lm, embeds[None],
                             position_ids[:, None, :], seg_ids[None],
                             attn_impl=attn_impl, attn_variant=attn_variant)


def text_only_loglikelihood(params: VLMParams, full_ids, cont_padded,
                            c: int, c_max: int, text_buckets=TEXT_BUCKETS, *,
                            device, attn_impl=None, attn_variant=None):
    """Text-only (ll, greedy) over the padded causal prefill of
    ``full_ids`` (context + continuation)."""
    with torch.no_grad():
        hidden, _ = _text_prefill(
            params, *_text_inputs(full_ids, text_buckets, device),
            attn_impl, attn_variant)
        ll, greedy = _score_continuation(
            params, hidden, len(full_ids),
            torch.as_tensor(cont_padded, device=device), c, c_max)
    return float(ll), bool(greedy)


@torch.no_grad()
def _prefill_text(params: VLMParams, input_ids, position_ids, seg_ids,
                  valid_len: int, attn_impl=None, attn_variant=None):
    """Causal prefill with no vision branch (text-only requests). Returns
    (next_token, (k_layers, v_layers), logits row)."""
    hidden, kv = _text_prefill(params, input_ids, position_ids, seg_ids,
                               attn_impl, attn_variant)
    logits = lm_mod.lm_head(params.lm, hidden[0, valid_len - 1])
    return torch.argmax(logits, dim=-1), kv, logits


@torch.no_grad()
def _decode(params: VLMParams, cache, token, pos: int, attn_impl=None):
    """token: [] int64; pos: the M-RoPE position, shared by all 3 axes."""
    embed = lm_mod.embed_tokens(params.lm, token.reshape(1, 1))  # [1, 1, D]
    pos3 = torch.full((3, 1, 1), pos, dtype=torch.int64, device=embed.device)
    hidden, cache = lm_mod.lm_decode_step(params.lm, cache, embed, pos3,
                                          attn_impl=attn_impl)
    logits = lm_mod.lm_head(params.lm, hidden[0, 0])
    return torch.argmax(logits, dim=-1), cache, logits


def gumbel_noise(generator: torch.Generator, vocab_size: int) -> torch.Tensor:
    """One [V] fp32 Gumbel vector from ``generator`` (on its device): what
    one sampled decode step consumes."""
    u = torch.rand(vocab_size, generator=generator, device=generator.device)
    return -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))


def sampling_generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A request's noise source: stream 0 feeds its decode steps; the
    repetition penalty's first-token re-pick uses stream ``FIRST_STREAM``."""
    g = torch.Generator(device=device)
    return g.manual_seed(((int(seed) << 16) ^ stream) & (2**64 - 1))


FIRST_STREAM = 0x5157


def sample_token(logits, noise, temperature, top_p, top_k=0):
    """Greedy where temperature == 0, else top-k / top-p (nucleus) sampling
    with the reference's arithmetic (``_sample_token``).

    logits [..., V]; noise [..., V]: Gumbel noise indexed by SORTED
    position (entry j perturbs the j-th most probable token), as
    ``jax.random.categorical`` adds it; temperature / top_p / top_k:
    scalars or [...] tensors (top_k <= 0 is off). Order of the warpers, as
    HF's: temperature, then the top-k cut, then the smallest prefix of the
    top-k-renormalised sorted mass that reaches top_p (the top token is
    always kept). Returns int64 [...].
    """
    lg = logits.float()
    dev, lead, v = lg.device, lg.shape[:-1], lg.shape[-1]

    def per_row(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=dev).expand(lead)

    temp = per_row(temperature, torch.float32)
    probs = torch.softmax(lg / temp.clamp(min=1e-6)[..., None], dim=-1)
    sort_idx = torch.argsort(-probs, dim=-1, stable=True)
    sp = probs.gather(-1, sort_idx)
    tk = per_row(top_k, torch.int64)
    kmask = (torch.arange(v, device=dev)
             < torch.where(tk <= 0, v, tk)[..., None])
    sp = torch.where(kmask, sp, 0.0)
    z = sp.sum(-1, keepdim=True)
    keep = ((sp.cumsum(-1) - sp)
            < per_row(top_p, torch.float32)[..., None] * z) & kmask
    masked = torch.where(keep, torch.log(sp + 1e-20), -torch.inf)
    choice = torch.argmax(masked + noise, dim=-1, keepdim=True)
    sampled = sort_idx.gather(-1, choice)[..., 0]
    return torch.where(temp > 0.0, sampled, torch.argmax(lg, dim=-1))


def penalize_logits(logits, presence, penalty):
    """HF ``RepetitionPenaltyLogitsProcessor``: tokens already seen
    (``presence``, a vocab-shaped bool mask) get score / penalty when
    positive and score * penalty when negative. Broadcasts over leading
    batch axes; fp32 out."""
    lg = logits.float()
    pen = torch.where(lg > 0, lg / penalty, lg * penalty)
    return torch.where(presence, pen, lg)


def rep_penalty_setup(vocab_size: int, input_ids, last_logits, next_token,
                      repetition_penalty: float, temperature: float = 0.0,
                      top_p: float = 1.0, top_k: int = 0, seed: int = 0):
    """Repetition-penalty seeding: the presence mask starts as the prompt's
    ids, and the FIRST token is re-picked from the penalized prefill logits
    (argmax when greedy, sampled from the request's ``FIRST_STREAM`` when
    temperature > 0), as HF's processor also penalizes the prefill logits.
    Returns (presence [V] bool on the logits' device, first token)."""
    dev = last_logits.device if last_logits is not None else "cpu"
    pres = torch.zeros(vocab_size, dtype=torch.bool, device=dev)
    ids = np.asarray(input_ids).reshape(-1)
    pres[torch.as_tensor(ids, dtype=torch.int64, device=dev)] = True
    if last_logits is not None:
        lg = penalize_logits(last_logits, pres, repetition_penalty)
        if float(temperature) > 0.0:
            gen = sampling_generator(seed, dev, FIRST_STREAM)
            first = int(sample_token(lg, gumbel_noise(gen, vocab_size),
                                     temperature, top_p, top_k))
        else:
            first = int(lg.argmax())
    else:
        first = int(next_token)
    pres[first] = True
    return pres, first


def _decode_rows(params: VLMParams, cache, tok, pos, live=None,
                 gens=None, temperature=0.0, top_p=1.0, top_k=0,
                 presence=None, penalty=1.0, attn_impl=None):
    """One decode step of B rows, the body every decode loop shares.

    The k/v of ``tok`` [B] at rope positions ``pos`` [B] go into ``cache``
    in place; then each row's next token: its logits penalized where
    ``presence`` [B, V] is given (``penalty`` a scalar or [B, 1]), sampled
    with one Gumbel vector from ``gens[i]`` (None: no draw) under
    temperature / top_p / top_k (scalars or [B]) when ``gens`` is given,
    else greedy. Rows where ``live`` [B] is False keep ``tok``. The chosen
    tokens are marked in ``presence``. Returns (next [B] int64, cache)."""
    b = tok.shape[0]
    embed = lm_mod.embed_tokens(params.lm, tok)[:, None]  # [B, 1, D]
    pos3 = pos[None, :, None].expand(3, b, 1)
    hidden, cache = lm_mod.lm_decode_step(params.lm, cache, embed, pos3,
                                          attn_impl=attn_impl)
    logits = lm_mod.lm_head(params.lm, hidden[:, 0])  # [B, V]
    if presence is not None:
        logits = penalize_logits(logits, presence, penalty)
    if gens is not None:
        vocab = logits.shape[-1]
        noise = torch.stack([gumbel_noise(g, vocab) if g is not None
                             else logits.new_zeros(vocab) for g in gens])
        nxt = sample_token(logits, noise, temperature, top_p, top_k)
    else:
        nxt = torch.argmax(logits, dim=-1)
    if live is not None:
        nxt = torch.where(live, nxt, tok)
    if presence is not None:
        presence[torch.arange(b, device=nxt.device), nxt] = True
    return nxt, cache


@torch.no_grad()
def _decode_batch(params: VLMParams, cache, firsts, starts,
                  eos_token_ids, max_steps: int, temperature: float = 0.0,
                  top_p: float = 1.0, seed: int = 0, top_k: int = 0,
                  repetition_penalty: float = 1.0, presence=None,
                  attn_impl=None, on_token=None):
    """Decode of B requests over one pool-shaped cache [L, B, T, H_kv, Dh]
    with per-layer and per-row lengths (selector, ``orig``, text-only and
    the LLM-side strategies' caches batch together).

    firsts / starts: [B] first tokens and rope positions. Each step writes
    its input tokens' k/v rows into ``cache`` in place. A row that emits
    an EOS stays frozen on its last token while the others step; its
    further cache writes land above its valid rows and are never read. A
    sampled row draws one Gumbel vector per live step from its own
    ``sampling_generator(seed)``, so each row's rollout equals its own
    ``generate``. ``presence`` [B, V] (from ``rep_penalty_setup``) is
    required when ``repetition_penalty != 1`` and grows in place.
    ``on_token(t)`` (B = 1 only) sees each emitted token that is not an
    EOS. Stops once every row is done. Returns (toks [steps, B] int64
    numpy, counts [B]: each row's tokens before its EOS, the cache with
    its lengths advanced by the steps run)."""
    dev = cache.k.device
    b = len(firsts)
    if on_token is not None and b != 1:
        raise ValueError("_decode_batch: on_token needs a batch of one")
    if max_steps > 0 and (int(cache.length.max()) + max_steps
                          > cache.k.shape[2]):
        raise ValueError(f"decode: {max_steps} steps do not fit the "
                         f"{cache.k.shape[2]}-row cache")
    tok = torch.as_tensor(np.asarray(firsts, np.int64), device=dev)
    pos = torch.as_tensor(np.asarray(starts, np.int64), device=dev)
    eos = list(eos_token_ids)
    done = np.isin(np.asarray(firsts), eos)
    finish = np.where(done, -1, max_steps)
    gens = ([sampling_generator(seed, dev) for _ in range(b)]
            if temperature > 0.0 else None)
    live = None  # all rows live: no freeze needed
    toks = []
    for step in range(max_steps):
        if done.all():
            break
        if done.any():
            live = torch.as_tensor(~done, device=dev)
        tok, cache = _decode_rows(
            params, cache, tok, pos + step, live,
            None if gens is None else
            [None if d else g for d, g in zip(done, gens)],
            temperature, top_p, top_k, presence, repetition_penalty,
            attn_impl)
        host = tok.cpu().numpy()  # host sync: the EOS check
        toks.append(host)
        now = np.isin(host, eos) & ~done
        finish = np.where(now, step, finish)
        done = done | now
        if on_token is not None and not done[0]:
            on_token(int(host[0]))
    toks = np.stack(toks) if toks else np.zeros((0, b), np.int64)
    counts = np.clip(np.minimum(finish, len(toks)), 0, None)
    return toks, counts, cache


def _decode_steps(params: VLMParams, cache, first_token: int,
                  start_pos: int, eos_token_ids, max_steps: int,
                  temperature: float = 0.0, top_p: float = 1.0,
                  seed: int = 0, top_k: int = 0,
                  repetition_penalty: float = 1.0, presence=None,
                  attn_impl=None, on_token=None):
    """``_decode_batch`` of one request from ``first_token`` at rope
    position ``start_pos`` (``presence`` [V]). Returns (the emitted tokens
    without the EOS, the cache with its lengths advanced by the steps run,
    the last token emitted: the EOS when one stopped the loop,
    ``first_token`` when no step ran)."""
    toks, counts, cache = _decode_batch(
        params, cache, [first_token], [start_pos], eos_token_ids, max_steps,
        temperature, top_p, seed, top_k, repetition_penalty,
        None if presence is None else presence[None], attn_impl, on_token)
    last = int(toks[-1, 0]) if len(toks) else first_token
    return toks[:int(counts[0]), 0].tolist(), cache, last


STREAM_CHUNK = 8  # tokens per streamed chunk after the first token


def _run_decode_loop(params: VLMParams, cache, first_token: int,
                     start_pos: int, eos_token_ids, max_new_tokens: int,
                     temperature: float = 0.0, top_p: float = 1.0,
                     seed: int = 0, top_k: int = 0,
                     repetition_penalty: float = 1.0, presence=None,
                     attn_impl=None, on_chunk=None) -> List[int]:
    """Decode with early EOS exit. Returns the tokens, the first one
    included, without a trailing EOS (the reference's count).

    ``on_chunk`` (streaming): called with the first token alone, then with
    each run of up to STREAM_CHUNK decoded tokens, the reference's chunk
    boundaries: a chunk that an EOS cuts short is delivered without the
    EOS (empty when the EOS opens it), and a first-token EOS delivers one
    empty chunk. The reference splits its sampling key per chunk; here the
    request's generator simply continues, so a streamed sampled rollout
    equals this loop's own non-streamed one (greedy equals the
    reference's)."""
    if first_token in eos_token_ids:
        if on_chunk is not None:
            on_chunk([])
        return []
    if max_new_tokens <= 1:
        if on_chunk is not None:
            on_chunk([first_token])
        return [first_token]
    on_token, pending = None, []
    if on_chunk is not None:
        on_chunk([first_token])

        def on_token(t):
            pending.append(t)
            if len(pending) == STREAM_CHUNK:
                on_chunk(pending[:])
                pending.clear()

    toks, _, last = _decode_steps(
        params, cache, first_token, start_pos, eos_token_ids,
        max_new_tokens - 1, temperature, top_p, seed, top_k,
        repetition_penalty, presence, attn_impl, on_token)
    if on_chunk is not None and (pending or last in eos_token_ids):
        on_chunk(pending[:])
    return [first_token] + toks


@dataclasses.dataclass
class GenerationResult:
    tokens: List[int]
    selected_indices: Optional[np.ndarray]  # kept vision indices, sorted
    num_vision_tokens: int  # original N
    prefill_len: int  # compacted valid length
    prefill_seconds: float = 0.0
    total_seconds: float = 0.0
    scores: Optional[np.ndarray] = None  # raw LIS scores
    logits: Optional[torch.Tensor] = None  # fp32 first-token logits [V]
    # seconds from the request's arrival to its first token (the prefill,
    # plus the queue wait under continuous batching)
    first_token_seconds: Optional[float] = None
    # decode dispatches the request took: chunks under continuous
    # batching, verify steps under speculative decoding (None for the
    # one-shot per-token loop)
    decode_dispatches: Optional[int] = None
    # speculative decoding: prompt-lookup proposals made / accepted for
    # this request (None when speculative decoding was off)
    spec_proposed: Optional[int] = None
    spec_accepted: Optional[int] = None


@dataclasses.dataclass
class PrefillState:
    """Deferred-decode prefill output (``generate(..., _defer_decode=True)``):
    what a slot pool needs to take the request over."""

    # KVCache [L, 1, T, H_kv, Dh] (T = prefill len + max_new); per-layer
    # lengths differ on the LLM-side strategies' path
    cache: object
    next_token: int
    # valid_len + rope_delta (t_orig + rope_delta on the LLM-side path)
    start_pos: int
    eos_token_ids: Tuple[int, ...]
    max_new_tokens: int
    result: GenerationResult  # tokens empty; filled after decode
    t_start: float = 0.0
    logits: Optional[torch.Tensor] = None  # prefill's last-row logits [V]
    # rope delta of the ORIGINAL (uncompacted) prompt: a trailing text token
    # at ids index i sits at rope position i + rope_delta. The prefix
    # cache's suffix append needs it: under compression start_pos is
    # valid_len + delta, which does not give the kept rows' positions
    rope_delta: int = 0


def _prefill_state(cfg: "VLConfig | OVConfig", parts, next_token: int,
                   start_pos: int, eos_token_ids, max_new_tokens: int,
                   result: GenerationResult, t_start: float, logits,
                   rope_delta: int = 0):
    """The prefill's k/v in a cache with room for ``max_new_tokens`` more
    rows. ``parts``: [(k, v [L_i, 1, T_i, H, D], valid length)] in layer
    order, covering every decoder layer: one part for a one-stage prefill;
    two for the LLM-side strategies, whose layers [0, target) hold the
    whole sequence and the others the kept one."""
    rows = max(k.shape[2] for k, _, _ in parts)
    k0 = parts[0][0]
    cache = lm_mod.init_kv_cache(cfg.text, 1, rows + max_new_tokens,
                                 k0.device, k0.dtype)
    l0 = 0
    for k, v, length in parts:
        l1 = l0 + k.shape[0]
        cache.k[l0:l1, :, :k.shape[2]] = k
        cache.v[l0:l1, :, :v.shape[2]] = v
        cache.length[l0:l1] = length
        l0 = l1
    if l0 != cfg.text.num_hidden_layers:
        raise ValueError(f"_prefill_state: the parts cover {l0} layers, the "
                         f"decoder has {cfg.text.num_hidden_layers}")
    return PrefillState(
        cache=cache, next_token=next_token, start_pos=start_pos,
        eos_token_ids=tuple(eos_token_ids), max_new_tokens=max_new_tokens,
        result=result, t_start=t_start, logits=logits, rope_delta=rope_delta)


def _decode_request(params: VLMParams, state: PrefillState, input_ids,
                    temperature, top_p, seed, top_k, repetition_penalty,
                    attn_impl=None, on_chunk=None) -> GenerationResult:
    """One-shot decode of a prefilled request (streamed through
    ``on_chunk`` when given, see ``_run_decode_loop``)."""
    presence, first = None, state.next_token
    if repetition_penalty != 1.0:
        presence, first = rep_penalty_setup(
            params.lm.cfg.vocab_size, input_ids, state.logits, first,
            repetition_penalty, temperature, top_p, top_k, seed)
    res = state.result
    res.tokens = _run_decode_loop(
        params, state.cache, first, state.start_pos, state.eos_token_ids,
        state.max_new_tokens, temperature, top_p, seed, top_k,
        repetition_penalty, presence, attn_impl, on_chunk)
    res.total_seconds = time.perf_counter() - state.t_start
    return res


@torch.no_grad()
def generate_text_only(params: VLMParams, cfg: "VLConfig | OVConfig",
                       input_ids,
                       max_new_tokens: int, eos_token_ids,
                       temperature: float = 0.0, top_p: float = 1.0,
                       seed: int = 0, text_buckets=TEXT_BUCKETS,
                       _defer_decode: bool = False, top_k: int = 0,
                       repetition_penalty: float = 1.0, *, device,
                       attn_impl=None, attn_variant=None,
                       on_token_chunk=None):
    """Text-only generation: plain causal prefill (1-D rope on all three
    M-RoPE axes) + decode, no vision branch (streamed through
    ``on_token_chunk`` when given)."""
    input_ids = np.asarray(input_ids).reshape(-1)
    t_orig = len(input_ids)
    t_start = time.perf_counter()
    next_token, (k_l, v_l), logits = _prefill_text(
        params, *_text_inputs(input_ids, text_buckets, device), t_orig,
        attn_impl, attn_variant)
    first = int(next_token)  # waits for the prefill
    t_prefill = time.perf_counter() - t_start
    result = GenerationResult(
        tokens=[], selected_indices=None, num_vision_tokens=0,
        prefill_len=t_orig, prefill_seconds=t_prefill, logits=logits,
        first_token_seconds=t_prefill)
    state = _prefill_state(cfg, [(k_l, v_l, t_orig)], first, t_orig,
                           eos_token_ids, max_new_tokens, result, t_start,
                           logits)
    if _defer_decode:
        return state
    return _decode_request(params, state, input_ids, temperature, top_p,
                           seed, top_k, repetition_penalty, attn_impl,
                           on_token_chunk)


def _vision_inputs(pixel_values, grid_thw, pixel_values_videos,
                   video_grid_thw):
    """One ViT call's inputs, as the reference engine concatenates them:
    (pixel rows, grids, the image grids or None, the video grids or None),
    image rows first, then video rows. Pixel rows None for a text-only
    request."""
    if pixel_values is not None and grid_thw is None:
        raise ValueError("pixel_values without grid_thw")
    if pixel_values_videos is not None and video_grid_thw is None:
        raise ValueError("pixel_values_videos without video_grid_thw")
    img_grid = grid_thw if pixel_values is not None else None
    vid_grid = video_grid_thw if pixel_values_videos is not None else None
    if pixel_values is not None and pixel_values_videos is not None:
        pixel_values = np.concatenate([pixel_values, pixel_values_videos])
        grid_thw = np.concatenate([grid_thw, video_grid_thw])
    elif pixel_values_videos is not None:
        pixel_values, grid_thw = pixel_values_videos, video_grid_thw
    return pixel_values, grid_thw, img_grid, vid_grid


def sequence_tensors(p, input_ids, device):
    """The prefill's sequence inputs on the device (from an engine's
    ``_prep_vision`` namespace ``p``): ids, padded image and text
    positions, the text count, the original rope ids."""
    return (torch.as_tensor(input_ids, device=device),
            torch.as_tensor(p.image_pos_padded, device=device),
            torch.as_tensor(p.text_pos_padded, device=device), p.num_text,
            torch.as_tensor(p.position_ids, device=device))


def _one_stage_state(engine: VLMEngine, p, next_token, valid_len, k_l, v_l,
                     logits, selected, scores, eos_token_ids,
                     max_new_tokens: int, t_start: float) -> PrefillState:
    """A one-stage prefill's outputs as a ``PrefillState`` (decode starts
    at the compacted length + rope delta)."""
    first = int(next_token)  # waits for the prefill
    t_prefill = time.perf_counter() - t_start
    valid_len = int(valid_len)
    result = GenerationResult(
        tokens=[], selected_indices=selected, num_vision_tokens=p.n,
        prefill_len=valid_len, prefill_seconds=t_prefill, scores=scores,
        logits=logits, first_token_seconds=t_prefill)
    return _prefill_state(
        engine.cfg, [(k_l, v_l, valid_len)], first,
        valid_len + int(p.rope_delta), eos_token_ids, max_new_tokens,
        result, t_start, logits, int(p.rope_delta))


def from_vision_state(engine: VLMEngine, p, input_ids, vision_embeds,
                      indices, valid, k: int, selected, scores,
                      eos_token_ids, max_new_tokens: int,
                      t_start: float) -> PrefillState:
    """Compaction of the chosen vision tokens (``indices`` [k_max] on the
    device, sentinel L_pad where ``valid`` is False) + causal prefill
    (``_prefill_from_vision``), as a ``PrefillState``."""
    next_token, valid_len, (k_l, v_l), logits = _prefill_from_vision(
        engine.params, vision_embeds, indices, valid, k,
        *sequence_tensors(p, input_ids, engine.device),
        attn_impl=engine.attn_impl)
    return _one_stage_state(engine, p, next_token, valid_len, k_l, v_l,
                            logits, selected, scores, eos_token_ids,
                            max_new_tokens, t_start)


def vit_side_state(engine: VLMEngine, p, input_ids, merged, recv, keys,
                   eos_token_ids, max_new_tokens: int,
                   t_start: float) -> PrefillState:
    """A ViT-side strategy (VisionZip, PruMerge+, DivPrune, HoloV, Random)
    on a tower's merged tokens and last-block statistics (``merged`` [L_pad,
    D], ``recv`` [L_pad], ``keys`` [L_pad, H * d]): the host strategy, the
    replacement embeddings written back, then ``from_vision_state``."""
    n, stats = p.n, engine.strategy.needs_stats
    # bf16 has no numpy dtype: the host strategies get fp32 copies, and
    # replacement embeddings are rounded to the model's dtype when they
    # are written back into the vision rows, before compaction
    idx, new_embeds = engine.strategy(
        merged[:n].float().cpu().numpy(),
        recv[:n].cpu().numpy() if stats else None,
        keys[:n].cpu().numpy() if stats else None,
        engine.budget, p.grid_thw)
    idx = np.asarray(idx, np.int64)[:p.k_max]
    dev = engine.device
    if new_embeds is not None:
        merged = merged.clone()
        merged[torch.as_tensor(idx, device=dev)] = torch.as_tensor(
            np.asarray(new_embeds)[:len(idx)], device=dev).to(merged.dtype)
    k = len(idx)
    idx_padded = np.full(p.k_max, p.l_pad, np.int64)
    idx_padded[:k] = idx
    return from_vision_state(
        engine, p, input_ids, merged, torch.as_tensor(idx_padded, device=dev),
        torch.arange(p.k_max, device=dev) < k, k, idx, None, eos_token_ids,
        max_new_tokens, t_start)


def llm_side_state(engine: VLMEngine, p, input_ids, vision_embeds,
                   eos_token_ids, max_new_tokens: int,
                   t_start: float) -> PrefillState:
    """FastV / DART / Dynamic-Qwen on a tower's merged tokens: the
    two-stage prefill. Stage A runs decoder layers [0, target) over the
    whole sequence; the strategy picks image positions on the host from
    stage A's statistics; stage B gathers the kept positions at layer
    target and runs the rest. The cache's layers [0, target) hold t_orig
    rows, the others the kept ones, and decode continues at t_orig +
    rope_delta, the original sequence's next position (the reference's
    convention)."""
    dev, strategy = engine.device, engine.strategy
    target = strategy.target_layer
    t_orig = p.t_orig
    (hidden_t, (k_a, v_a), fv, key_l1, _, pos_full,
     _) = _stage_a_from_vision(
        engine.params, target, strategy.capture, vision_embeds, p.n,
        *sequence_tensors(p, input_ids, dev), attn_impl=engine.attn_impl)
    t_pad_full = hidden_t.shape[1]
    retained = np.asarray(strategy.select(
        fv[:t_orig].cpu().numpy() if fv is not None else None,
        key_l1[:t_orig].cpu().numpy(),
        hidden_t[0, :t_orig].float().cpu().numpy(),
        p.image_pos, engine.budget), np.int64)
    keep = np.sort(np.concatenate([retained, p.text_pos]))
    k_img_max = p.k_max + 8  # DART's pivots can exceed the budget
    t_keep_pad = k_img_max + p.t_text_bucket
    keep_padded = np.full(t_keep_pad, t_pad_full, np.int64)
    keep_padded[:len(keep)] = keep
    keep_valid = len(keep)
    next_token, (k_b, v_b), logits = _stage_b(
        engine.params, target, hidden_t, pos_full,
        torch.as_tensor(keep_padded, device=dev), keep_valid,
        attn_impl=engine.attn_impl)
    first = int(next_token)  # waits for the prefill
    t_prefill = time.perf_counter() - t_start
    # retained sequence positions -> vision-token indices
    pos_to_vis = {int(q): j for j, q in enumerate(p.image_pos)}
    selected = np.asarray(sorted(pos_to_vis[int(q)] for q in retained),
                          np.int64)
    result = GenerationResult(
        tokens=[], selected_indices=selected, num_vision_tokens=p.n,
        prefill_len=keep_valid, prefill_seconds=t_prefill, logits=logits,
        first_token_seconds=t_prefill)
    return _prefill_state(
        engine.cfg, [(k_a, v_a, t_orig), (k_b, v_b, keep_valid)], first,
        t_orig + int(p.rope_delta), eos_token_ids, max_new_tokens, result,
        t_start, logits, int(p.rope_delta))


class QwenVLEngine:
    """Batch-1 generation engine (images, a video, both, or text only);
    many requests share one decode through ``continuous.ContinuousBatcher``.

    ``attn_impl="plain"`` runs every attention (prefill and decode) through
    the plain PyTorch paths (to compare the whole model against the
    kernels on the card); the default runs the CUDA kernels on a CUDA
    device.

    ``attn_variant`` picks the attention configuration of the prefill (the
    reference's ``VST_FUSED_ATTN`` / ``VST_PACKED_ATTN``, which are not
    read): None (diag kernel for ViT window layers, flash for ViT full
    layers and LM prefill); "fused" (every ViT layer through the fused
    rotary + attention kernel on the qkv slab; LM prefill as None);
    "packed" (the ViT's heads zero-padded to 128 in a copy of its weights,
    made once here; window layers run the diag kernel at head dim 128, the
    ViT full layers and an LM prefill with a head dim that is a multiple of
    128 the packed flash entry point). Either takes the unpadded weights
    (ValueError otherwise); with ``attn_impl="plain"`` it runs its plain
    versions. Decode is the same under all three.

    ``strategy``: a training-free baseline (``selector.baselines.
    get_baseline(name)``) in place of the LIS selector. A ViT-side one
    (VisionZip, PruMerge+, DivPrune, HoloV, Random) runs the ViT with its
    last block's statistics (``vit_forward_stats``), selects on the host,
    and prefills the compacted sequence; an LLM-side one (FastV, DART,
    Dynamic-Qwen) runs the two-stage prefill. Both take the default
    attention route: ``attn_variant`` with a strategy raises ValueError.
    """

    def __init__(self, cfg: VLConfig, params: QwenVLParams,
                 use_selector: bool = True, budget: float = 0.2,
                 vision_buckets=VISION_BUCKETS, text_buckets=TEXT_BUCKETS,
                 strategy=None, *, device, attn_impl: Optional[str] = None,
                 attn_variant: Optional[str] = None):
        if attn_variant not in (None, "fused", "packed"):
            raise ValueError(f"attn_variant must be None, 'fused' or "
                             f"'packed', got {attn_variant!r}")
        dp = vit_mod.head_width(params.visual)
        if attn_variant is not None and dp != cfg.vision.head_dim:
            raise ValueError(
                f"attn_variant={attn_variant!r} takes the unpadded ViT "
                f"weights; these hold heads padded to {dp} (head dim "
                f"{cfg.vision.head_dim})")
        if attn_variant == "packed" and cfg.vision.head_dim % 128:
            from visionselector_tpu_torch.models.qwen25vl.weights import (
                pad_vit_head_dim,
            )

            params = QwenVLParams(pad_vit_head_dim(params.visual, cfg.vision),
                                  params.lm, params.scorer)
        if strategy is not None and attn_variant is not None:
            raise ValueError(
                f"attn_variant={attn_variant!r} with a strategy: the "
                f"strategies run the default attention route (the "
                f"reference's vit_forward_stats and two-stage prefill)")
        self.cfg = cfg
        self.params = params
        self.strategy = strategy
        self.use_selector = (strategy is None and use_selector
                             and params.scorer is not None)
        self.budget = budget
        self.vision_buckets = vision_buckets
        self.text_buckets = text_buckets
        self.device = torch.device(device)
        self.attn_impl = attn_impl
        self.attn_variant = attn_variant
        if getattr(strategy, "device", False) is None:
            strategy.device = self.device  # Dynamic-Qwen's predictor

    def _prep_vision(self, input_ids, pixel_values, grid_thw, img_grid,
                     vid_grid, second_per_grid_ts):
        """Host-side prep, as the reference engine's: bucket choice,
        vision-batch index arrays, k/k_max, padded position maps and M-RoPE
        ids. ``pixel_values`` / ``grid_thw``: the image + video rows and
        grids as ``_vision_inputs`` concatenates them; ``img_grid`` /
        ``vid_grid``: each modality's own grids (None where absent)."""
        cfg = self.cfg
        input_ids = np.asarray(input_ids).reshape(-1)
        t_orig = len(input_ids)
        merge_unit = cfg.vision.spatial_merge_unit
        s_real = pixel_values.shape[0]
        # Window-aligned layout (the reference's default): every window in
        # its own slot -> block-diagonal window attention (the diag kernel).
        align = True
        s_need = aligned_window_len(
            grid_thw, window_size=cfg.vision.window_size,
            spatial_merge_size=cfg.vision.spatial_merge_size,
            patch_size=cfg.vision.patch_size,
        )
        if s_need > self.vision_buckets[-1] >= s_real:
            # slot padding would push past the largest bucket while the raw
            # length still fits — keep the classic layout
            align = False
            s_need = s_real
        s_bucket = pick_bucket(s_need, list(self.vision_buckets))
        vb = build_vision_batch(
            pixel_values, grid_thw,
            window_size=cfg.vision.window_size,
            spatial_merge_size=cfg.vision.spatial_merge_size,
            patch_size=cfg.vision.patch_size,
            pad_to=s_bucket,
            align_windows=align,
        )
        l_pad = s_bucket // merge_unit
        n = vb.num_merged

        if self.use_selector:
            k = max(1, int(n * self.budget))
            k_max = max(1, int(l_pad * self.budget))
            k = min(k, k_max)
        elif self.strategy is not None:
            k = None  # the strategy decides
            k_max = min(l_pad, int(l_pad * self.budget) + 2)
        else:
            k = n
            k_max = l_pad

        # Merged tokens come in pixel order (image grids, then video
        # grids), so the merged -> sequence map lists image-token positions
        # first; compaction sorts by sequence position, so a prompt with the
        # video before the image stays right.
        is_img = input_ids == cfg.image_token_id
        is_vid = input_ids == cfg.video_token_id
        is_vision = ((is_img if img_grid is not None else False)
                     | (is_vid if vid_grid is not None else False))
        image_pos = np.concatenate([
            np.where(is_img)[0] if img_grid is not None else [],
            np.where(is_vid)[0] if vid_grid is not None else [],
        ]).astype(np.int64)
        if len(image_pos) != n:
            raise ValueError(
                f"{len(image_pos)} image / video tokens in the prompt for "
                f"{n} merged vision tokens of the grids")
        text_pos = np.where(~is_vision)[0]
        num_text = len(text_pos)

        image_pos_padded = np.full(l_pad, t_orig, np.int64)
        image_pos_padded[:n] = image_pos
        t_text_bucket = pick_bucket(num_text, list(self.text_buckets))
        # Round the compacted length (k_max + text bucket) to a 128 multiple,
        # as the reference does.
        t_text_bucket += (-(k_max + t_text_bucket)) % 128
        text_pos_padded = np.full(t_text_bucket, t_orig, np.int64)
        text_pos_padded[:num_text] = text_pos

        position_ids, rope_delta = get_rope_index(
            input_ids,
            image_grid_thw=img_grid,
            video_grid_thw=vid_grid,
            second_per_grid_ts=second_per_grid_ts,
            spatial_merge_size=cfg.vision.spatial_merge_size,
            tokens_per_second=cfg.vision.tokens_per_second,
            image_token_id=cfg.image_token_id,
            video_token_id=cfg.video_token_id,
            vision_start_token_id=cfg.vision_start_token_id,
        )
        return SimpleNamespace(
            vb=vb, n=n, k=k, k_max=k_max, l_pad=l_pad, s_bucket=s_bucket,
            image_pos=image_pos, text_pos=text_pos, num_text=num_text,
            image_pos_padded=image_pos_padded,
            text_pos_padded=text_pos_padded, t_text_bucket=t_text_bucket,
            position_ids=position_ids, rope_delta=rope_delta, t_orig=t_orig,
            grid_thw=grid_thw,
        )

    def _vision_tensors(self, vb) -> dict:
        """The ``vit_forward`` inputs of a VisionBatch, on the device."""
        dev = self.device

        def t(x):
            return torch.as_tensor(np.asarray(x), device=dev)

        return dict(
            pixel_values=t(vb.pixel_values), rot_pos_ids=t(vb.rot_pos_ids),
            window_seg_ids=t(vb.window_seg_ids),
            full_seg_ids=t(vb.full_seg_ids),
            reverse_index=t(vb.reverse_index),
            window_kv_bounds=t(vb.window_kv_bounds),
            full_kv_bounds=t(vb.full_kv_bounds),
            window_diag=vb.window_diag,
            window_kv_iters=vb.window_kv_iters,
            full_kv_iters=vb.full_kv_iters,
        )

    def loglikelihood(
        self,
        input_ids: np.ndarray,
        continuation_ids: np.ndarray,
        pixel_values: Optional[np.ndarray] = None,
        grid_thw: Optional[np.ndarray] = None,
        pixel_values_videos: Optional[np.ndarray] = None,
        video_grid_thw: Optional[np.ndarray] = None,
        second_per_grid_ts: Optional[np.ndarray] = None,
    ) -> Tuple[float, bool]:
        """Score a continuation given a context (images, a video, both, or
        text only): (sum log P(continuation | context), is_greedy), the lmms
        model ABC's ``loglikelihood``.

        The whole prompt, context + continuation, is prefilled once; the
        selector (or no compression, for ``orig``) applies to the vision
        tokens as in generation, and the continuation, a text suffix that
        compaction always keeps, is scored from the prefill's hidden
        states. An engine with a training-free strategy raises
        NotImplementedError (the reference's compression adapters give only
        ``generate_until``)."""
        if self.strategy is not None:
            raise NotImplementedError(
                "loglikelihood supports the selector and orig paths only")
        input_ids = np.asarray(input_ids).reshape(-1)
        if len(input_ids) == 0:
            raise ValueError(
                "loglikelihood needs a non-empty context: token 0 has no "
                "position before it to be predicted from")
        cont_padded, c, c_max = ll_continuation_arrays(continuation_ids)
        full_ids = np.concatenate([input_ids, cont_padded[:c]])
        dev = self.device
        pixels, grid, img_grid, vid_grid = _vision_inputs(
            pixel_values, grid_thw, pixel_values_videos, video_grid_thw)
        if pixels is None:
            return text_only_loglikelihood(
                self.params, full_ids, cont_padded, c, c_max,
                self.text_buckets, device=dev, attn_impl=self.attn_impl,
                attn_variant=self.attn_variant)
        p = self._prep_vision(full_ids, pixels, grid, img_grid, vid_grid,
                              second_per_grid_ts)
        ll, greedy = _prefill_ll(
            self.params, p.k_max, self.use_selector, c_max,
            self._vision_tensors(p.vb), p.n, p.k,
            *sequence_tensors(p, full_ids, dev),
            torch.as_tensor(cont_padded, device=dev), c,
            attn_impl=self.attn_impl, attn_variant=self.attn_variant)
        return float(ll), bool(greedy)

    @torch.no_grad()
    def generate(
        self,
        input_ids: np.ndarray,
        pixel_values: Optional[np.ndarray] = None,
        grid_thw: Optional[np.ndarray] = None,
        max_new_tokens: int = 64,
        eos_token_ids: Optional[Tuple[int, ...]] = None,
        pixel_values_videos: Optional[np.ndarray] = None,
        video_grid_thw: Optional[np.ndarray] = None,
        second_per_grid_ts: Optional[np.ndarray] = None,
        temperature: float = 0.0,
        top_p: float = 1.0,
        seed: int = 0,
        on_token_chunk=None,
        _defer_decode: bool = False,
        top_k: int = 0,
        repetition_penalty: float = 1.0,
    ):
        """Generation for a request with images (``pixel_values``, one
        ``grid_thw`` row each), a video (``pixel_values_videos``,
        ``video_grid_thw``, ``second_per_grid_ts``), both, or neither
        (text only): greedy, or sampled with ``temperature`` / ``top_k`` /
        ``top_p`` from ``seed``, with an optional ``repetition_penalty``.

        input_ids: [T_orig] with the ``<|image_pad|>`` / ``<|video_pad|>``
        runs already expanded. Image and video rows go through one ViT call
        (images first); kept video tokens keep the M-RoPE ids of the
        original sequence, as kept image tokens do. ``on_token_chunk``
        streams the tokens: the first alone, then chunks of up to 8
        (``_run_decode_loop``). ``_defer_decode=True`` returns the
        ``PrefillState`` instead of decoding (how a slot pool admits the
        request).
        """
        cfg = self.cfg
        dev = self.device
        if eos_token_ids is None:
            eos_token_ids = (cfg.eos_token_id,)
        input_ids = np.asarray(input_ids).reshape(-1)
        sampling = (temperature, top_p, seed, top_k, repetition_penalty)
        pixels, grid, img_grid, vid_grid = _vision_inputs(
            pixel_values, grid_thw, pixel_values_videos, video_grid_thw)
        if pixels is None:
            return generate_text_only(
                self.params, cfg, input_ids, max_new_tokens, eos_token_ids,
                temperature, top_p, seed, self.text_buckets, _defer_decode,
                top_k, repetition_penalty, device=dev,
                attn_impl=self.attn_impl, attn_variant=self.attn_variant,
                on_token_chunk=on_token_chunk)
        t_start = time.perf_counter()

        p = self._prep_vision(input_ids, pixels, grid, img_grid, vid_grid,
                              second_per_grid_ts)
        if getattr(self.strategy, "llm_side", False):
            state = self._prefill_llm_side(p, input_ids, eos_token_ids,
                                           max_new_tokens, t_start)
        else:
            state = self._prefill_one_stage(p, input_ids, eos_token_ids,
                                            max_new_tokens, t_start)
        if _defer_decode:
            return state
        return _decode_request(self.params, state, input_ids, *sampling,
                               attn_impl=self.attn_impl,
                               on_chunk=on_token_chunk)

    def _prefill_one_stage(self, p, input_ids, eos_token_ids,
                           max_new_tokens: int, t_start: float):
        """Selector, ``orig`` or a ViT-side strategy: one prefill over the
        compacted sequence."""
        if self.strategy is not None:
            merged, recv, keys = _vision_stats(
                self.params, self._vision_tensors(p.vb), self.attn_impl)
            return vit_side_state(self, p, input_ids, merged, recv, keys,
                                  eos_token_ids, max_new_tokens, t_start)
        (next_token, sel_idx, sel_valid, sel_scores, valid_len,
         (k_l, v_l), logits) = _prefill(
            self.params, p.k_max, self.use_selector,
            self._vision_tensors(p.vb), p.n, p.k,
            *sequence_tensors(p, input_ids, self.device),
            attn_impl=self.attn_impl, attn_variant=self.attn_variant)
        selected = scores = None
        if self.use_selector:
            selected = sel_idx.cpu().numpy()[sel_valid.cpu().numpy()]
            scores = sel_scores.cpu().numpy()[:p.n]
        return _one_stage_state(self, p, next_token, valid_len, k_l, v_l,
                                logits, selected, scores, eos_token_ids,
                                max_new_tokens, t_start)

    def _prefill_llm_side(self, p, input_ids, eos_token_ids,
                          max_new_tokens: int, t_start: float):
        """FastV / DART / Dynamic-Qwen: the ViT, then the two-stage prefill
        (``llm_side_state``)."""
        vision_embeds = vit_mod.vit_forward(
            self.params.visual, attn_impl=self.attn_impl,
            **self._vision_tensors(p.vb))
        return llm_side_state(self, p, input_ids, vision_embeds,
                              eos_token_ids, max_new_tokens, t_start)

    def start_chunked_prefill(self, input_ids, pixel_values=None,
                              grid_thw=None, pixel_values_videos=None,
                              video_grid_thw=None, second_per_grid_ts=None,
                              max_new_tokens: int = 64, eos_token_ids=None,
                              prefill_chunk: int = 256,
                              vit_segments: int = 0
                              ) -> Optional["ChunkedPrefill"]:
        """Begin a segmented admission prefill (``ChunkedPrefill``).

        ``vit_segments`` <= 1: the tower, selection and compaction run here
        in one step, and ``step()`` feeds ``prefill_chunk`` compacted rows
        through the decoder per call. ``vit_segments`` > 1: nothing runs
        here; ``step()`` first advances ceil(depth / vit_segments) tower
        blocks at a time, then the merger + selection + compaction
        epilogue (the one host read of the admission), then the decoder
        segments. Images, a video or both take one ViT call, as in
        ``generate``. Returns None for a request the fused path should
        take: a strategy engine (its capture stages are one program) and a
        text-only request (its prefill is already short)."""
        if self.strategy is not None:
            return None
        pixels, grid, img_grid, vid_grid = _vision_inputs(
            pixel_values, grid_thw, pixel_values_videos, video_grid_thw)
        if pixels is None:
            return None
        if eos_token_ids is None:
            eos_token_ids = (self.cfg.eos_token_id,)
        input_ids = np.asarray(input_ids).reshape(-1)
        t_start = time.perf_counter()
        p = self._prep_vision(input_ids, pixels, grid, img_grid, vid_grid,
                              second_per_grid_ts)
        seg = max(1, int(prefill_chunk))
        t_comp = p.k_max + p.t_text_bucket
        t_cap = -(-t_comp // seg) * seg  # whole segments
        vt = self._vision_tensors(p.vb)
        seq = sequence_tensors(p, input_ids, self.device)
        job = ChunkedPrefill(
            engine=self, seg=seg, eos_token_ids=tuple(eos_token_ids),
            max_new_tokens=max_new_tokens, rope_delta=int(p.rope_delta),
            result=GenerationResult(tokens=[], selected_indices=None,
                                    num_vision_tokens=p.n, prefill_len=0),
            t_start=t_start)
        if vit_segments > 1:
            depth = self.cfg.vision.depth
            job._vit = dict(x=vt["pixel_values"], vt=vt, seq=seq, lo=0,
                            group=max(1, -(-depth // int(vit_segments))),
                            k_max=p.k_max, n=p.n, k=p.k, t_cap=t_cap)
            return job
        with torch.no_grad():
            comp, selection = _compact_stage(
                self.params, p.k_max, self.use_selector, vt, p.n, p.k, *seq,
                attn_impl=self.attn_impl, attn_variant=self.attn_variant)
        job._arm(_pad_comp(comp, t_cap), selection, t_cap)
        return job

    def generate_batch(self, requests: List[dict], max_new_tokens: int = 64,
                       eos_token_ids=None, temperature: float = 0.0,
                       top_p: float = 1.0, seed: int = 0, top_k: int = 0,
                       repetition_penalty: float = 1.0
                       ) -> List[GenerationResult]:
        """Decode-batched generation (``run_generate_batch``): each request
        (a dict of ``generate`` keywords) prefills on its own, then one
        batched decode serves them all; each row's tokens equal its own
        ``generate``'s."""
        return run_generate_batch(
            self, requests, max_new_tokens=max_new_tokens,
            eos_token_ids=eos_token_ids, temperature=temperature,
            top_p=top_p, seed=seed, top_k=top_k,
            repetition_penalty=repetition_penalty)


@torch.no_grad()
def _score_chunk(params: VLMParams, cache, cont_padded, cont_len: int,
                 pos_start: int, ctx_logits, c_max: int, attn_impl=None):
    """(ll, greedy) of one continuation given a prefilled cache and the
    context's last-row logits: one chunked decode forward of the c_max
    padded ids (``lm_decode_chunk``) instead of a prefill. The chunk
    writes rows [length, length + c_max) of ``cache`` in place, every one
    before it is read (row i sees positions < length + i + 1), and
    ``cache.length`` stays as it was, so every choice scored from the
    same cache starts at the same length and none reads another's rows.
    Positions follow the decode convention: pos_start + i on all three
    M-RoPE axes."""
    ids = cont_padded.long()
    embeds = lm_mod.embed_tokens(params.lm, ids)[None]
    pos = pos_start + torch.arange(c_max, device=ids.device)
    pos3 = pos.expand(3, 1, c_max)
    hidden, _ = lm_mod.lm_decode_chunk(params.lm, cache, embeds, pos3,
                                       attn_impl=attn_impl)
    rows = lm_mod.lm_head(params.lm, hidden[0])  # [c_max, V] fp32

    ll = torch.log_softmax(ctx_logits.float(), dim=-1)[ids[0]]
    greedy = ctx_logits.argmax() == ids[0]
    # token j >= 1 is predicted by chunk row j - 1
    lp_rows = torch.log_softmax(rows, dim=-1)
    tok_lp = lp_rows[:-1].gather(-1, ids[1:, None])[:, 0]
    tail_valid = torch.arange(1, c_max, device=ids.device) < cont_len
    ll = ll + torch.where(tail_valid, tok_lp, 0.0).sum()
    greedy = greedy & torch.where(
        tail_valid, rows[:-1].argmax(-1) == ids[1:], True).all()
    return ll, greedy


def run_loglikelihood_choices(engine: "VLMEngine", input_ids,
                              choices_ids: List[np.ndarray],
                              **gen_kwargs) -> List[Tuple[float, bool]]:
    """Score several continuations of one context with a single prefill:
    the context prefills once (``generate(..., _defer_decode=True)``), then
    each choice costs one chunked decode forward of c_max rows, c_max the
    largest choice's, so an N-choice doc is about N times cheaper than N
    ``engine.loglikelihood`` calls.

    On ``orig`` this equals per-pair ``loglikelihood`` up to fp32 order;
    under compression the chunk numbers its positions by the decode
    convention (those generated tokens would get) where the full prefill
    numbers them on the original sequence, so the two agree in ranking,
    not in value. An engine with a training-free strategy raises
    NotImplementedError, as ``loglikelihood`` does."""
    if engine.strategy is not None:
        raise NotImplementedError(
            "loglikelihood supports the selector and orig paths only")
    prepped = [ll_continuation_arrays(c) for c in choices_ids]
    c_max = max(p[2] for p in prepped)
    state = engine.generate(
        np.asarray(input_ids), max_new_tokens=c_max + 1,
        eos_token_ids=(-1,), _defer_decode=True, **gen_kwargs)
    out = []
    for padded, c, _ in prepped:
        padded_u = np.zeros(c_max, np.int64)
        padded_u[:len(padded)] = padded
        ll, greedy = _score_chunk(
            engine.params, state.cache,
            torch.as_tensor(padded_u, device=engine.device), c,
            state.start_pos, state.logits, c_max, engine.attn_impl)
        out.append((float(ll), bool(greedy)))
    return out


# ---------------------------------------------------------------------------
# Serving paths: decode-batched generation, chunked admission prefill, chat
# sessions and the cross-request prefix cache. The port writes every cache
# in place (``lm.lm_decode_chunk``), so every path that appends to a cache
# it must keep (a prefix snapshot, an older chat session) first copies it
# (``_ensure_capacity``).
# ---------------------------------------------------------------------------


def run_generate_batch(engine: "VLMEngine", requests: List[dict],
                       max_new_tokens: int = 64, eos_token_ids=None,
                       temperature: float = 0.0, top_p: float = 1.0,
                       seed: int = 0, top_k: int = 0,
                       repetition_penalty: float = 1.0
                       ) -> List[GenerationResult]:
    """Decode-batched generation: each request prefills on its own
    (``generate(..., _defer_decode=True)``), then one batched decode
    (``_decode_batch``) serves them all. The batch is exactly the requests
    (the reference pads it to a power of two to bound its compiled
    programs; the port has none)."""
    if not requests:
        return []
    states = [engine.generate(**req, max_new_tokens=max_new_tokens,
                              eos_token_ids=eos_token_ids,
                              _defer_decode=True) for req in requests]
    presence = None
    if repetition_penalty != 1.0:
        # per-row presence from each prompt; the first token re-picked from
        # each prefill's penalized last-row logits (HF semantics)
        rows = []
        for req, s in zip(requests, states):
            pres, s.next_token = rep_penalty_setup(
                engine.cfg.text.vocab_size, req["input_ids"], s.logits,
                s.next_token, repetition_penalty, temperature, top_p, top_k,
                seed)
            rows.append(pres)
        presence = torch.stack(rows)
    eos = states[0].eos_token_ids
    if any(s.eos_token_ids != eos for s in states):
        raise ValueError("generate_batch: the requests' EOS ids differ")
    cache = _assemble_batch_cache([s.cache for s in states])
    t_dec0 = time.perf_counter()
    if max_new_tokens > 1:
        toks, counts, _ = _decode_batch(
            engine.params, cache, [s.next_token for s in states],
            [s.start_pos for s in states], eos, max_new_tokens - 1,
            temperature, top_p, seed, top_k, repetition_penalty, presence,
            engine.attn_impl)
    else:
        toks = np.zeros((0, len(states)), np.int64)
        counts = np.zeros(len(states), np.int64)
    t_decode = time.perf_counter() - t_dec0
    results = []
    for i, s in enumerate(states):
        res = s.result
        res.tokens = ([] if s.next_token in eos else
                      [s.next_token] + toks[:int(counts[i]), i].tolist())
        # a request's own prefill plus the shared decode (its wall since
        # its own t_start would charge it every later request's prefill)
        res.total_seconds = res.prefill_seconds + t_decode
        results.append(res)
    return results


def _assemble_batch_cache(caches) -> lm_mod.KVCache:
    """One [L, B, T, H_kv, Dh] cache from B one-row caches (T the largest;
    the shorter ones zero-padded), with their per-layer lengths."""
    k0 = caches[0].k
    t_all = max(c.k.shape[2] for c in caches)
    shape = (k0.shape[0], len(caches), t_all) + tuple(k0.shape[3:])
    k = k0.new_zeros(shape)
    v = k0.new_zeros(shape)
    for i, c in enumerate(caches):
        k[:, i, :c.k.shape[2]] = c.k[:, 0]
        v[:, i, :c.v.shape[2]] = c.v[:, 0]
    return lm_mod.KVCache(k=k, v=v, length=torch.cat(
        [c.length for c in caches], dim=1))


# -- chunked admission prefill ----------------------------------------------


def _vit_segment(params: QwenVLParams, x, vt: dict, lo: int, hi: int,
                 first: bool, attn_impl=None, attn_variant=None):
    """Vision-tower blocks [lo, hi) as one chunked-admission step
    (``first`` also runs the patch embed on the raw pixel rows); ``vt``:
    the ``vit_forward`` inputs (``QwenVLEngine._vision_tensors``)."""
    if first:
        x = vit_mod.vit_embed(params.visual, x)
    return vit_mod.vit_forward_segment(
        params.visual, x, vt["rot_pos_ids"], vt["window_seg_ids"],
        vt["full_seg_ids"], lo, hi, vt["window_kv_bounds"],
        vt["full_kv_bounds"], vt["window_diag"], vt["window_kv_iters"],
        vt["full_kv_iters"], attn_impl, attn_variant)


def _pad_comp(comp, pad_to: int):
    """The compacted sequence's embeds and positions zero-padded to
    ``pad_to`` rows (the segments' static capacity)."""
    t = comp.embeds.shape[0]
    if pad_to <= t:
        return comp
    return comp._replace(
        embeds=F.pad(comp.embeds, (0, 0, 0, pad_to - t)),
        position_ids=F.pad(comp.position_ids, (0, pad_to - t)))


def _compact_from_hidden(params: QwenVLParams, k_max: int,
                         use_selector: bool, x, reverse_index,
                         num_merged: int, k: int, input_ids, image_positions,
                         text_positions, num_text: int, position_ids_orig,
                         pad_to: int = 0):
    """Chunked-admission epilogue of the vision phase: merger + selection +
    compaction on the tower's final hidden states."""
    vision_embeds = vit_mod.vit_merge(params.visual, x, reverse_index,
                                      params.visual.cfg)
    comp, selection = _select_and_compact(
        params, k_max, use_selector, vision_embeds, num_merged, k,
        input_ids, image_positions, text_positions, num_text,
        position_ids_orig)
    return _pad_comp(comp, pad_to), selection


def _prefill_chunk_seg(params: VLMParams, cache, embeds, pos, base: int,
                       p: int, attn_impl=None):
    """One chunked-prefill segment: compacted rows [base, base + p) through
    every decoder layer against the growing cache (``lm_decode_chunk``:
    each row's k/v lands at the layer's length + i, and row i attends the
    committed rows and the segment's rows up to itself; the decode kernel
    at t_c = p). Returns (hidden [1, p, D], cache)."""
    return lm_mod.lm_decode_chunk(
        params.lm, cache, embeds[base:base + p][None],
        pos[:, base:base + p][:, None, :], attn_impl=attn_impl)


def _prefill_chunk_logits(params: VLMParams, hidden, idx: int):
    logits = lm_mod.lm_head(params.lm, hidden[0, idx])
    return torch.argmax(logits, dim=-1), logits


@dataclasses.dataclass
class ChunkedPrefill:
    """An admission prefill run in steps (continuous batching), so that
    the batcher can run decode chunks between them: the tower in
    ``vit_segments`` block groups (or in one step), then the merger +
    selection + compaction epilogue, then the compacted sequence in
    ``seg``-row decoder segments.

    The compacted layout puts the real rows first, so every segment but
    the last is all real, and the last one's padding rows sit after the
    real ones: causal attention keeps the real rows from reading them, and
    their k/v lands above the final cache length, where nothing reads it.
    The cache holds the segments' capacity plus ``max_new_tokens`` rows,
    as ``generate``'s does."""

    engine: "QwenVLEngine"
    seg: int
    eos_token_ids: Tuple[int, ...]
    max_new_tokens: int
    rope_delta: int
    result: GenerationResult
    t_start: float
    embeds: Optional[torch.Tensor] = None  # [t_cap, D] compacted, padded
    position_ids: Optional[torch.Tensor] = None  # [3, t_cap]
    cache: Optional[object] = None  # KVCache [L, 1, t_cap + max_new]
    valid_len: int = 0
    n_seg: int = 0
    selection: Optional[Selection] = None
    i: int = 0
    _hidden_last: Optional[torch.Tensor] = None
    # the segmented tower's cursor and inputs; None once compacted
    _vit: Optional[dict] = None

    @property
    def done(self) -> bool:
        return (self._vit is None and self.cache is not None
                and self.i >= self.n_seg)

    def step(self) -> bool:
        """Run one step (a tower block group, the compact epilogue or a
        decoder segment); True when the prefill is complete."""
        if self.done:
            raise RuntimeError("ChunkedPrefill.step after its last segment")
        with torch.no_grad():
            if self._vit is not None:
                self._vit_step()
                return False
            hidden, self.cache = _prefill_chunk_seg(
                self.engine.params, self.cache, self.embeds,
                self.position_ids, self.i * self.seg, self.seg,
                self.engine.attn_impl)
        self.i += 1
        if self.done:
            self._hidden_last = hidden
        return self.done

    def _vit_step(self):
        eng, v = self.engine, self._vit
        depth = eng.cfg.vision.depth
        if v["lo"] < depth:
            hi = min(v["lo"] + v["group"], depth)
            v["x"] = _vit_segment(
                eng.params, v["x"], v["vt"], v["lo"], hi, v["lo"] == 0,
                eng.attn_impl,
                "fused" if eng.attn_variant == "fused" else None)
            v["lo"] = hi
            return
        comp, selection = _compact_from_hidden(
            eng.params, v["k_max"], eng.use_selector, v["x"],
            v["vt"]["reverse_index"], v["n"], v["k"], *v["seq"],
            pad_to=v["t_cap"])
        self._vit = None
        self._arm(comp, selection, v["t_cap"])

    def _arm(self, comp, selection, t_cap: int):
        """Allocate the cache and enter the decoder phase."""
        cfg = self.engine.cfg
        self.cache = lm_mod.init_kv_cache(
            cfg.text, 1, t_cap + self.max_new_tokens, comp.embeds.device,
            comp.embeds.dtype)
        self.valid_len = int(comp.valid_len)
        self.n_seg = -(-self.valid_len // self.seg)
        self.embeds, self.position_ids = comp.embeds, comp.position_ids
        self.selection = selection if self.engine.use_selector else None
        self.result.prefill_len = self.valid_len

    @torch.no_grad()
    def finish(self) -> PrefillState:
        """After the last segment: the first token and the prefill state
        (the cache's lengths set to the valid length)."""
        if not self.done:
            raise RuntimeError("ChunkedPrefill.finish before its last "
                               "segment")
        idx = (self.valid_len - 1) - (self.n_seg - 1) * self.seg
        next_tok, logits = _prefill_chunk_logits(
            self.engine.params, self._hidden_last, idx)
        cache = dataclasses.replace(
            self.cache, length=torch.full_like(self.cache.length,
                                               self.valid_len))
        res = self.result
        if self.selection is not None:
            sel = self.selection
            res.selected_indices = (
                sel.indices.cpu().numpy()[sel.valid.cpu().numpy()])
            res.scores = sel.scores.cpu().numpy()[:res.num_vision_tokens]
        first = int(next_tok)  # waits for the last segment
        res.prefill_len = self.valid_len
        res.prefill_seconds = time.perf_counter() - self.t_start
        res.first_token_seconds = res.prefill_seconds
        res.logits = logits
        return PrefillState(
            cache=cache, next_token=first,
            start_pos=self.valid_len + self.rope_delta,
            eos_token_ids=self.eos_token_ids,
            max_new_tokens=self.max_new_tokens, result=res,
            t_start=self.t_start, logits=logits, rope_delta=self.rope_delta)


# -- chat sessions -------------------------------------------------------------


def _ensure_capacity(cache, need: int) -> lm_mod.KVCache:
    """A fresh copy of ``cache`` with at least ``need`` rows: the rows
    below its longest layer length copied, the others zero. Always a new
    buffer, never ``cache`` itself: the port writes caches in place, and a
    stored prefix snapshot or a kept chat session must not see another
    request's rows."""
    l, b, t, h, d = cache.k.shape
    rows = int(cache.length.max())
    k = cache.k.new_zeros((l, b, max(t, need), h, d))
    v = cache.v.new_zeros((l, b, max(t, need), h, d))
    k[:, :, :rows] = cache.k[:, :, :rows]
    v[:, :, :rows] = cache.v[:, :, :rows]
    return lm_mod.KVCache(k=k, v=v, length=cache.length.clone())


@torch.no_grad()
def _append_chunk(params: VLMParams, cache, ids, pos_start: int,
                  attn_impl=None):
    """Consume n new text tokens (host ids) against the cache in one
    chunked forward of c = max(32, 32 * ceil(n / 32)) rows (one launch
    shape per 32 rows), written IN PLACE at each layer's length, at rope
    positions pos_start + i. Returns (next_token, the cache with lengths +
    n, the last real row's logits [V]). The padding rows write k/v above
    the returned length, which the next append or decode step overwrites;
    within the chunk they follow the real rows, so no real row attends
    one. Raises ValueError when the c rows do not fit."""
    ids = np.asarray(ids, np.int64).reshape(-1)
    n = len(ids)
    c = max(32, -(-n // 32) * 32)
    if int(cache.length.max()) + c > cache.k.shape[2]:
        raise ValueError(f"_append_chunk: {c} rows past length "
                         f"{int(cache.length.max())} do not fit the "
                         f"{cache.k.shape[2]}-row cache")
    padded = np.zeros(c, np.int64)
    padded[:n] = ids
    dev = cache.k.device
    embeds = lm_mod.embed_tokens(params.lm,
                                 torch.as_tensor(padded, device=dev))[None]
    pos = pos_start + torch.arange(c, device=dev)
    hidden, cache = lm_mod.lm_decode_chunk(
        params.lm, cache, embeds, pos.expand(3, 1, c), attn_impl=attn_impl)
    logits = lm_mod.lm_head(params.lm, hidden[0, n - 1])
    cache = dataclasses.replace(cache, length=cache.length - (c - n))
    return torch.argmax(logits, dim=-1), cache, logits


@dataclasses.dataclass
class ChatSession:
    """Multi-turn decoding state: the KV cache survives across turns, so a
    follow-up question costs one chunked append and its decode instead of
    a prefill of the whole (vision-heavy) conversation. A turn never writes
    into an earlier session's cache, so an older session stays usable
    (retries, branches)."""

    cache: lm_mod.KVCache
    pos: int  # next rope position
    pending: int  # last emitted, not yet consumed token (the turn's EOS)
    eos_token_ids: Tuple[int, ...]


def _session_turn(engine: "VLMEngine", cache, first: int, pos: int,
                  eos, max_new_tokens: int, temperature, top_p, seed,
                  top_k):
    """Decode a turn from its first token: (tokens, the next session)."""
    if first in eos:
        return [], ChatSession(cache, pos, first, eos)
    toks, cache, last = _decode_steps(
        engine.params, cache, first, pos, eos, max_new_tokens - 1,
        temperature, top_p, seed, top_k, attn_impl=engine.attn_impl)
    consumed = len(toks) + (1 if last in eos else 0)
    return [first] + toks, ChatSession(cache, pos + consumed, last, eos)


def start_chat_session(engine: "VLMEngine", input_ids,
                       pixel_values=None, grid_thw=None,
                       max_new_tokens: int = 64, eos_token_ids=None,
                       temperature: float = 0.0, top_p: float = 1.0,
                       seed: int = 0, top_k: int = 0, **gen_kwargs):
    """First turn: the engine's prefill and decode, with the cache kept as
    a ``ChatSession``. A sampled first turn draws what ``engine.generate``
    with the same seed draws (the same rollout)."""
    state = engine.generate(
        input_ids, pixel_values, grid_thw, max_new_tokens=max_new_tokens,
        eos_token_ids=eos_token_ids, _defer_decode=True, **gen_kwargs)
    tokens, sess = _session_turn(
        engine, state.cache, state.next_token, state.start_pos,
        tuple(state.eos_token_ids), max_new_tokens, temperature, top_p,
        seed, top_k)
    return dataclasses.replace(
        state.result, tokens=tokens,
        total_seconds=time.perf_counter() - state.t_start), sess


def continue_chat_session(engine: "VLMEngine", sess: ChatSession,
                          new_ids, max_new_tokens: int = 64,
                          temperature: float = 0.0, top_p: float = 1.0,
                          seed: int = 0, top_k: int = 0):
    """Follow-up turn: [pending EOS + the new turn's ids] through one
    chunked append on a copy of the session's cache (a multiple of 32 rows;
    K5 at that t_c), then its decode. No vision encode and no prompt
    prefill. Sampling is per turn (a fresh generator from ``seed``)."""
    t_start = time.perf_counter()
    chunk = np.concatenate([[sess.pending],
                            np.asarray(new_ids).reshape(-1)]).astype(np.int64)
    n = len(chunk)
    c = max(32, -(-n // 32) * 32)
    cache = _ensure_capacity(
        sess.cache, int(sess.cache.length.max()) + c + max_new_tokens + 1)
    next_token, cache, logits = _append_chunk(engine.params, cache, chunk,
                                              sess.pos, engine.attn_impl)
    first = int(next_token)
    t_prefill = time.perf_counter() - t_start
    tokens, new_sess = _session_turn(
        engine, cache, first, sess.pos + n, sess.eos_token_ids,
        max_new_tokens, temperature, top_p, seed, top_k)
    return GenerationResult(
        tokens=tokens, selected_indices=None, num_vision_tokens=0,
        prefill_len=n, prefill_seconds=t_prefill,
        total_seconds=time.perf_counter() - t_start, logits=logits,
        first_token_seconds=t_prefill), new_sess


# -- cross-request prefix cache ------------------------------------------------


@dataclasses.dataclass
class PrefixEntry:
    """One stored post-prefill snapshot for cross-request KV reuse."""

    sig: Optional[str]  # image signature (None = text-only prompt)
    ids: np.ndarray  # the stored prompt's ids
    vis_end: int  # ids index after the last vision span (0 = none)
    cache: Optional[lm_mod.KVCache]  # per-layer lengths at the prompt's end
    pos: int  # next rope position after the prompt
    result: Optional[GenerationResult]  # prefill metadata
    # the original prompt's rope delta: trailing text at ids index i has
    # rope position i + delta (under compression ``pos`` is based on the
    # compacted length, while kept rows keep their original positions)
    delta: int = 0


class PrefixCacheStore:
    """Cross-request KV prefix cache (LRU).

    Requests that share an (image, prompt prefix) pair skip the prefill of
    the shared prefix: the stored cache rolls back to the common prefix and
    only the suffix runs, through the chunked append chat sessions use.

    Under token compression ids map one to one onto cache rows only after
    the last vision span (``vis_end``), so a hit needs the common prefix to
    cover every vision token; the rolled-back tokens are all text, so every
    layer's length shifts by the rollback count (FastV's per-layer lengths
    too: a text row lands in every layer). Re-appended suffix tokens take
    original-index rope positions (consumed + delta), decode continues at
    the compacted length + delta, both as a fresh prefill gives them.
    A hit appends into a copy (``_ensure_capacity``), so the stored
    snapshot survives any number of hits with different suffixes.

    Distinct from ``ChatSession``, which extends one conversation's cache:
    this store serves independent requests that share a prefix. Not
    thread-safe: call it under the server's engine lock."""

    def __init__(self, max_entries: int = 4, min_prefix: int = 32):
        self.entries: "collections.OrderedDict[int, PrefixEntry]" = (
            collections.OrderedDict())
        self.max_entries = max_entries
        self.min_prefix = min_prefix
        self.hits = 0
        self.misses = 0
        self._next_id = 0

    @staticmethod
    def signature(pixel_values, grid_thw, pixel_values_videos=None,
                  video_grid_thw=None,
                  second_per_grid_ts=None) -> Optional[str]:
        """A hash of the request's vision inputs, images and video (None
        for a text-only prompt). The reference hashes the image arrays
        only, so two clips with the same grid (whose ``<|video_pad|>`` ids
        are equal) share an entry there and the second reads the first's
        vision k/v; here they do not."""
        parts = (pixel_values, grid_thw, pixel_values_videos,
                 video_grid_thw, second_per_grid_ts)
        if pixel_values is None and pixel_values_videos is None:
            return None
        h = hashlib.sha1()
        for i, x in enumerate(parts):
            if x is not None:
                h.update(f"{i}:".encode())
                h.update(np.ascontiguousarray(x).tobytes())
        return h.hexdigest()

    def lookup(self, sig, ids: np.ndarray, exact_only: bool = False):
        """The longest usable (entry, consumed) for a new prompt, or None.

        ``consumed`` is capped at len(ids) - 1, so at least one token goes
        through the append, which gives the next-token logits (an exact
        repeat needs no stored logits). ``exact_only``: whole-prompt repeats
        only (the text-dependent strategies, FastV / DART, whose selection
        depends on the question; the LIS selector and ``orig`` score vision
        tokens only, so a different suffix reuses the prefix exactly)."""
        best, best_consumed = None, 0
        for key, e in self.entries.items():
            if e.sig != sig:
                continue
            if exact_only and (len(e.ids) != len(ids)
                               or not (e.ids == ids).all()):
                continue
            n = min(len(e.ids), len(ids))
            neq = np.nonzero(e.ids[:n] != ids[:n])[0]
            j = int(neq[0]) if len(neq) else n
            consumed = min(j, len(ids) - 1)
            if consumed < max(e.vis_end, 1, self.min_prefix):
                continue
            if consumed > best_consumed:
                best, best_consumed = (key, e), consumed
        if best is None:
            return None
        key, e = best
        self.entries.move_to_end(key)
        return e, best_consumed

    def insert(self, entry: PrefixEntry):
        for e in self.entries.values():  # a repeat of a stored prompt
            if (e.sig == entry.sig and len(e.ids) == len(entry.ids)
                    and (e.ids == entry.ids).all()):
                return
        self.entries[self._next_id] = entry
        self._next_id += 1
        while len(self.entries) > self.max_entries:
            self.entries.popitem(last=False)


def _vision_span_end(ids: np.ndarray, cfg: "VLConfig | OVConfig") -> int:
    ends = np.nonzero(ids == cfg.vision_end_token_id)[0]
    return int(ends[-1]) + 1 if len(ends) else 0


def prefix_cached_prefill(engine: "VLMEngine", store: PrefixCacheStore,
                          input_ids, pixel_values=None, grid_thw=None,
                          max_new_tokens: int = 64, eos_token_ids=None,
                          **gen_kwargs) -> PrefillState:
    """Prefill through the prefix cache; the returned state's cache is the
    caller's to write (the stored snapshot is never aliased into it).

    Miss: the engine's prefill; its cache is stored and a copy handed out.
    Hit: a copy of the stored cache, rolled back to the common prefix,
    takes the suffix in one chunked append; the vision encode and the
    shared text's prefill are skipped."""
    input_ids = np.asarray(input_ids).reshape(-1)
    sig = PrefixCacheStore.signature(
        pixel_values, grid_thw, gen_kwargs.get("pixel_values_videos"),
        gen_kwargs.get("video_grid_thw"),
        gen_kwargs.get("second_per_grid_ts"))
    hit = store.lookup(sig, input_ids,
                       exact_only=getattr(engine, "strategy", None)
                       is not None)
    if hit is None:
        store.misses += 1
        state = engine.generate(
            input_ids, pixel_values, grid_thw,
            max_new_tokens=max_new_tokens, eos_token_ids=eos_token_ids,
            _defer_decode=True, **gen_kwargs)
        store.insert(PrefixEntry(
            sig=sig, ids=input_ids.copy(),
            vis_end=_vision_span_end(input_ids, engine.cfg),
            cache=state.cache, pos=state.start_pos,
            result=dataclasses.replace(state.result),
            delta=state.rope_delta))
        return dataclasses.replace(state,
                                   cache=_ensure_capacity(state.cache, 0))
    store.hits += 1
    t_start = time.perf_counter()
    entry, consumed = hit
    d = len(entry.ids) - consumed  # trailing text rows rolled back
    suffix = input_ids[consumed:]
    n = len(suffix)
    c = max(32, -(-n // 32) * 32)
    rolled = dataclasses.replace(entry.cache,
                                 length=entry.cache.length - d)
    cache = _ensure_capacity(
        rolled, int(rolled.length.max()) + c + max_new_tokens + 1)
    # the suffix is trailing text of the original prompt: positions
    # consumed + delta onward, as a fresh prefill gives them
    next_token, cache, logits = _append_chunk(
        engine.params, cache, suffix, consumed + entry.delta,
        engine.attn_impl)
    first = int(next_token)
    t_prefill = time.perf_counter() - t_start
    eos = (tuple(eos_token_ids) if eos_token_ids is not None
           else (engine.cfg.eos_token_id,))
    base = dataclasses.replace(
        entry.result, tokens=[], logits=logits,
        prefill_len=entry.result.prefill_len - d + n,
        prefill_seconds=t_prefill, first_token_seconds=t_prefill)
    # decode continues at the new prompt's compacted length + delta
    return PrefillState(
        cache=cache, next_token=first, start_pos=entry.pos - d + n,
        eos_token_ids=eos, max_new_tokens=max_new_tokens, result=base,
        t_start=t_start, logits=logits, rope_delta=entry.delta)


def generate_prefix_cached(engine: "VLMEngine", store: PrefixCacheStore,
                           input_ids, pixel_values=None, grid_thw=None,
                           max_new_tokens: int = 64, eos_token_ids=None,
                           temperature: float = 0.0, top_p: float = 1.0,
                           seed: int = 0, top_k: int = 0,
                           repetition_penalty: float = 1.0,
                           **gen_kwargs) -> GenerationResult:
    """Generation through the prefix cache: greedy tokens equal a fresh
    prefill's, and a sampled hit draws what ``engine.generate`` with the
    same seed draws. ``repetition_penalty != 1`` bypasses the store (the
    reference's rule: its penalized first token reads the prefill's
    logits), so its tokens are ``engine.generate``'s."""
    if repetition_penalty != 1.0:
        return engine.generate(
            input_ids, pixel_values, grid_thw,
            max_new_tokens=max_new_tokens, eos_token_ids=eos_token_ids,
            temperature=temperature, top_p=top_p, seed=seed, top_k=top_k,
            repetition_penalty=repetition_penalty, **gen_kwargs)
    state = prefix_cached_prefill(
        engine, store, input_ids, pixel_values, grid_thw,
        max_new_tokens=max_new_tokens, eos_token_ids=eos_token_ids,
        **gen_kwargs)
    tokens = _run_decode_loop(
        engine.params, state.cache, state.next_token, state.start_pos,
        tuple(state.eos_token_ids), max_new_tokens, temperature, top_p,
        seed, top_k, attn_impl=engine.attn_impl)
    return dataclasses.replace(
        state.result, tokens=tokens,
        total_seconds=time.perf_counter() - state.t_start)


# -- speculative decoding -----------------------------------------------------


def _prompt_lookup(ctx: list, n: int, m: int) -> list:
    """Prompt-lookup proposal: the m tokens that followed the most recent
    EARLIER occurrence of the context's final n-gram, zero-padded to m;
    [0] * m when there is none (the step then emits one token)."""
    pad = [0] * m
    if len(ctx) <= n:
        return pad
    tail = ctx[-n:]
    for i in range(len(ctx) - n - 1, -1, -1):
        if ctx[i:i + n] == tail:
            cont = ctx[i + n:i + n + m]
            if cont:
                return cont + [0] * (m - len(cont))
    return pad


def _verify_logits(params: VLMParams, cache, cur, props, pos_start,
                   attn_impl=None):
    """One verify forward: each row's [cur, props...] (cur [B], props [B,
    m]) through ``lm_decode_chunk`` at rope positions pos_start [B] + i,
    written in place at each layer's length. Returns (logits [B, m + 1, V]
    fp32, the cache with length + m + 1)."""
    b, m = props.shape
    ids = torch.cat([cur[:, None], props], dim=1)
    embeds = lm_mod.embed_tokens(params.lm, ids)  # [B, m + 1, D]
    pos = pos_start[:, None] + torch.arange(m + 1, device=ids.device)
    hidden, cache = lm_mod.lm_decode_chunk(
        params.lm, cache, embeds, pos[None].expand(3, b, m + 1),
        attn_impl=attn_impl)
    return lm_mod.lm_head(params.lm, hidden), cache


def _greedy_accept(greedy, props):
    """Accepted proposals a [...]: the length of props' [..., m] longest
    prefix equal to the greedy rows' argmaxes (greedy [..., m + 1])."""
    m = props.shape[-1]
    eq = props == greedy[..., :m]
    return torch.where(eq.all(-1), m, (~eq).to(torch.int64).argmax(-1))


def _roll_back(cache, rejected):
    """The cache with every layer's length lowered by ``rejected`` (a
    tensor [] or [B]): the rejected rows stay in place above the length,
    and the next chunk's rows overwrite them before any row reads them."""
    return dataclasses.replace(cache, length=cache.length - rejected)


@torch.no_grad()
def _spec_verify(params: VLMParams, cache, cur, props, pos_start: int,
                 attn_impl=None):
    """One greedy speculative step: [cur, props...] (cur [], props [m]) in
    one chunked forward. Returns (greedy [m + 1], accepted count a [], the
    cache rolled back over the m - a rejected rows): the step emits
    greedy[:a + 1]."""
    m = props.shape[0]
    logits, cache = _verify_logits(
        params, cache, cur.reshape(1), props[None],
        torch.full((1,), pos_start, device=props.device), attn_impl)
    greedy = logits[0].argmax(-1)
    a = _greedy_accept(greedy, props)
    return greedy, a, _roll_back(cache, m - a)


def _nucleus_probs(logits, temperature, top_p, top_k=0):
    """The top-k / nucleus-truncated sampling distribution over the vocab,
    ``sample_token``'s sampling branch written out as probabilities:
    temperature, the top-k cut, the smallest sorted prefix of the cut
    mass reaching top_p (the top token always kept), renormalised.

    logits [..., V]; temperature / top_p / top_k: scalars or tensors that
    broadcast to logits' leading dims (top_k <= 0 is off). Returns [..., V]
    fp32 rows summing to 1. The sort is stable, as ``jnp.argsort``."""
    lg = logits.float()
    dev, lead, v = lg.device, lg.shape[:-1], lg.shape[-1]

    def per_row(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=dev).expand(lead)

    temp = per_row(temperature, torch.float32).clamp(min=1e-6)
    probs = torch.softmax(lg / temp[..., None], dim=-1)
    sort_idx = torch.argsort(-probs, dim=-1, stable=True)
    sp = probs.gather(-1, sort_idx)
    tk = per_row(top_k, torch.int64)
    kmask = (torch.arange(v, device=dev)
             < torch.where(tk <= 0, v, tk)[..., None])
    sp = torch.where(kmask, sp, 0.0)
    z = sp.sum(-1, keepdim=True)
    keep = ((sp.cumsum(-1) - sp)
            < per_row(top_p, torch.float32)[..., None] * z) & kmask
    kept = torch.where(keep, sp, 0.0)
    kept = kept / kept.sum(-1, keepdim=True)
    return torch.zeros_like(kept).scatter_(-1, sort_idx, kept)


def _spec_accept(probs, props, uniforms, gumbel):
    """Speculative-sampling acceptance for a point-mass draft (Leviathan et
    al. 2023 with q = delta at props[i]), batched over leading dims.

    probs [..., m + 1, V]: the target distributions (row i given the first
    i proposals); props [..., m]; uniforms [..., m] in [0, 1): proposal i
    is accepted while u_i < p_i(props[i]); gumbel [..., V]: the noise of
    the one categorical draw at the first rejection a, from p_a with the
    rejected proposal's entry zeroed (the residual of a point mass), or
    from p_m when all m were accepted (``jax.random.categorical``'s
    argmax(log p + g), g indexed by token id). Returns (emitted [...,
    m + 1] int64, of which [..., :a + 1] is meaningful, a [...]). Every
    emitted token's law is the target's."""
    m = props.shape[-1]
    v = probs.shape[-1]
    p_draft = probs[..., :m, :].gather(-1, props[..., None])[..., 0]
    rej = uniforms >= p_draft
    a = torch.where(rej.any(-1), rej.to(torch.int64).argmax(-1), m)
    at_a = a[..., None, None].expand(*a.shape, 1, v)
    row = probs.gather(-2, at_a)[..., 0, :]
    drop = props.gather(-1, a.clamp(max=m - 1)[..., None])
    zeroed = row.scatter(-1, drop, 0.0)
    row = torch.where((a < m)[..., None], zeroed, row)
    t_a = torch.argmax(torch.log(row + 1e-20) + gumbel, dim=-1)
    emitted = torch.cat([props, torch.zeros_like(props[..., :1])], dim=-1)
    emitted = emitted.scatter(-1, a[..., None], t_a[..., None])
    return emitted, a


def spec_draws(gen: torch.Generator, m: int, vocab_size: int):
    """One sampled verify step's noise from a request's generator: m
    uniforms for the acceptance tests, then one [V] Gumbel vector for the
    categorical draw (``_spec_accept``)."""
    u = torch.rand(m, generator=gen, device=gen.device)
    return u, gumbel_noise(gen, vocab_size)


@torch.no_grad()
def _spec_verify_sampled(params: VLMParams, cache, cur, props,
                         pos_start: int, gen, temperature, top_p, top_k=0,
                         attn_impl=None):
    """A sampled speculative step: ``_spec_verify``'s forward, acceptance
    by the speculative-sampling rule on the nucleus distributions, its
    noise drawn from ``gen`` (``spec_draws``). Returns (emitted [m + 1],
    a [], the rolled-back cache)."""
    m = props.shape[0]
    logits, cache = _verify_logits(
        params, cache, cur.reshape(1), props[None],
        torch.full((1,), pos_start, device=props.device), attn_impl)
    probs = _nucleus_probs(logits[0], temperature, top_p, top_k)
    u, g = spec_draws(gen, m, probs.shape[-1])
    emitted, a = _spec_accept(probs, props, u, g)
    return emitted, a, _roll_back(cache, m - a)


def generate_speculative(engine: "VLMEngine", input_ids, pixel_values=None,
                         grid_thw=None, max_new_tokens: int = 64,
                         eos_token_ids=None, propose_len: int = 7,
                         ngram: int = 3, temperature: float = 0.0,
                         top_p: float = 1.0, seed: int = 0, top_k: int = 0,
                         repetition_penalty: float = 1.0,
                         **gen_kwargs) -> GenerationResult:
    """Generation with prompt-lookup speculative decoding, on any engine
    whose ``generate`` takes ``_defer_decode`` (``QwenVLEngine``,
    ``OVEngine``; the selector, ``orig`` and every strategy).

    The prefill runs as ``engine.generate``'s, with ``propose_len`` + 1
    rows of headroom in its cache: a verify step may write that far past
    the per-token budget. Each step then proposes ``propose_len`` tokens
    (``_prompt_lookup`` over the prompt ids and the tokens so far) and
    verifies them in one chunked forward, emitting 1..propose_len + 1
    tokens; one host read per step. temperature 0: the tokens equal
    ``engine.generate``'s by construction (only exact greedy continuations
    are accepted). temperature > 0: speculative-sampling acceptance, so
    every emitted token has the nucleus sampler's law, with the first
    token sampled from the prefill's logits and every draw from the
    request's ``sampling_generator(seed)`` (same distribution as
    ``engine.generate``, other draws).

    Two cases run ``engine.generate`` instead, as the reference does:
    ``repetition_penalty != 1`` (a parallel verify cannot see the presence
    updates of earlier rows of its chunk), and a sampled request whose
    prefill gives no logits to sample its first token from."""
    if repetition_penalty != 1.0:
        return engine.generate(
            input_ids, pixel_values, grid_thw,
            max_new_tokens=max_new_tokens, eos_token_ids=eos_token_ids,
            temperature=temperature, top_p=top_p, seed=seed, top_k=top_k,
            repetition_penalty=repetition_penalty, **gen_kwargs)
    m = int(propose_len)
    if m < 1:
        raise ValueError(f"propose_len must be >= 1, got {propose_len}")
    sampling = temperature is not None and temperature > 0.0
    state = engine.generate(
        input_ids, pixel_values, grid_thw,
        max_new_tokens=max_new_tokens + m + 1, eos_token_ids=eos_token_ids,
        _defer_decode=True, **gen_kwargs)
    if sampling and state.logits is None:
        return engine.generate(
            input_ids, pixel_values, grid_thw,
            max_new_tokens=max_new_tokens, eos_token_ids=eos_token_ids,
            temperature=temperature, top_p=top_p, seed=seed, top_k=top_k,
            **gen_kwargs)
    cache = state.cache
    dev = cache.k.device
    gen = None
    if sampling:
        gen = sampling_generator(seed, dev)
        first = int(sample_token(
            state.logits, gumbel_noise(gen, state.logits.shape[-1]),
            temperature, top_p, top_k))
    else:
        first = state.next_token
    eos = set(state.eos_token_ids)
    base = state.result
    if first in eos:
        return dataclasses.replace(
            base, tokens=[], total_seconds=time.perf_counter()
            - state.t_start)
    out = [first]
    ctx = list(map(int, np.asarray(input_ids).reshape(-1))) + [first]
    pos, cur = state.start_pos, first
    steps = proposed = accepted = 0
    attn_impl = engine.attn_impl
    while len(out) < max_new_tokens:
        props = torch.as_tensor(_prompt_lookup(ctx, ngram, m),
                                dtype=torch.int64, device=dev)
        cur_t = torch.tensor(cur, dtype=torch.int64, device=dev)
        if sampling:
            emitted, a, cache = _spec_verify_sampled(
                engine.params, cache, cur_t, props, pos, gen, temperature,
                top_p, top_k, attn_impl)
        else:
            emitted, a, cache = _spec_verify(engine.params, cache, cur_t,
                                             props, pos, attn_impl)
        host = torch.cat([emitted, a.reshape(1)]).tolist()  # the host read
        a_i = host[-1]
        new = host[:a_i + 1]
        steps += 1
        proposed += m
        accepted += a_i
        stop = False
        for t in new:
            if t in eos or len(out) >= max_new_tokens:
                stop = True
                break
            out.append(t)
            ctx.append(t)
        if stop:
            break
        cur = new[-1]
        pos += a_i + 1
    return dataclasses.replace(
        base, tokens=out, total_seconds=time.perf_counter() - state.t_start,
        decode_dispatches=steps, spec_proposed=proposed,
        spec_accepted=accepted)
