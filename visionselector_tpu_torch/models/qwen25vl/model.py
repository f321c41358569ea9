"""Qwen2.5-VL end-to-end model: vision encode -> (select) -> prefill -> decode.

Counterpart of ``visionselector_tpu.models.qwen25vl.model`` for requests
with one image or none. The host computes the data-dependent index arrays
(vision batch, image / text positions, M-RoPE ids, bucket choices) exactly
as the reference engine does, and the device runs

  _prefill:      ViT -> LIS scorer -> hard top-k -> sequence compaction ->
                 causal prefill over the valid-prefix compacted sequence ->
                 first token,
  _prefill_text: causal prefill of a text-only request,
  _decode:       one token against the KV cache (written in place),

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
"""

from __future__ import annotations

import dataclasses
import time
from types import SimpleNamespace
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from visionselector_tpu_torch.core.config import VLConfig
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


def _select_and_compact(params: QwenVLParams, k_max: int,
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


def _score_continuation(params: QwenVLParams, hidden, valid_len: int,
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


def _text_prefill(params: QwenVLParams, input_ids, position_ids, seg_ids,
                  attn_impl=None, attn_variant=None):
    """Causal prefill with no vision branch: (hidden [1, T, D], (k_layers,
    v_layers))."""
    embeds = lm_mod.embed_tokens(params.lm, input_ids)
    return lm_mod.lm_prefill(params.lm, embeds[None],
                             position_ids[:, None, :], seg_ids[None],
                             attn_impl=attn_impl, attn_variant=attn_variant)


def text_only_loglikelihood(params: QwenVLParams, full_ids, cont_padded,
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
def _prefill_text(params: QwenVLParams, input_ids, position_ids, seg_ids,
                  valid_len: int, attn_impl=None, attn_variant=None):
    """Causal prefill with no vision branch (text-only requests). Returns
    (next_token, (k_layers, v_layers), logits row)."""
    hidden, kv = _text_prefill(params, input_ids, position_ids, seg_ids,
                               attn_impl, attn_variant)
    logits = lm_mod.lm_head(params.lm, hidden[0, valid_len - 1])
    return torch.argmax(logits, dim=-1), kv, logits


@torch.no_grad()
def _decode(params: QwenVLParams, cache, token, pos: int, attn_impl=None):
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


def _run_decode_loop(params: QwenVLParams, cache, first_token: int,
                     start_pos: int, eos_token_ids, max_new_tokens: int,
                     temperature: float = 0.0, top_p: float = 1.0,
                     seed: int = 0, top_k: int = 0,
                     repetition_penalty: float = 1.0, presence=None,
                     attn_impl=None) -> List[int]:
    """Decode with early EOS exit. Returns the tokens, the first one
    included, without a trailing EOS (the reference's count). A sampled
    request draws one Gumbel vector per step from
    ``sampling_generator(seed)``; ``presence`` (from ``rep_penalty_setup``)
    is required when ``repetition_penalty != 1`` and grows in place."""
    if first_token in eos_token_ids:
        return []
    out = [first_token]
    if max_new_tokens <= 1:
        return out
    dev = cache.k.device
    vocab = params.lm.cfg.vocab_size
    gen = sampling_generator(seed, dev) if temperature > 0.0 else None
    tok = torch.tensor(first_token, device=dev)
    for step in range(max_new_tokens - 1):
        greedy, cache, logits = _decode(params, cache, tok, start_pos + step,
                                        attn_impl)
        if repetition_penalty != 1.0:
            logits = penalize_logits(logits, presence, repetition_penalty)
            greedy = torch.argmax(logits, dim=-1)
        tok = (sample_token(logits, gumbel_noise(gen, vocab), temperature,
                            top_p, top_k) if gen is not None else greedy)
        if repetition_penalty != 1.0:
            presence[tok] = True
        t = int(tok)  # host sync: the EOS check needs the token
        if t in eos_token_ids:
            break
        out.append(t)
    return out


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
    # decode chunks a continuous-batching request took (None one-shot)
    decode_dispatches: Optional[int] = None


@dataclasses.dataclass
class PrefillState:
    """Deferred-decode prefill output (``generate(..., _defer_decode=True)``):
    what a slot pool needs to take the request over."""

    cache: object  # KVCache [L, 1, T, H_kv, Dh] (T = prefill len + max_new)
    next_token: int
    start_pos: int  # valid_len + rope_delta
    eos_token_ids: Tuple[int, ...]
    max_new_tokens: int
    result: GenerationResult  # tokens empty; filled after decode
    t_start: float = 0.0
    logits: Optional[torch.Tensor] = None  # prefill's last-row logits [V]


def _prefill_state(cfg: VLConfig, k_l, v_l, valid_len: int, next_token: int,
                   start_pos: int, eos_token_ids, max_new_tokens: int,
                   result: GenerationResult, t_start: float, logits):
    """The prefill's k/v [L, 1, T, H, D] in a cache with room for
    ``max_new_tokens`` more rows."""
    rows = k_l.shape[2]
    cache = lm_mod.init_kv_cache(cfg.text, 1, rows + max_new_tokens,
                                 k_l.device, k_l.dtype)
    cache.k[:, :, :rows] = k_l
    cache.v[:, :, :rows] = v_l
    cache.length.fill_(valid_len)
    return PrefillState(
        cache=cache, next_token=next_token, start_pos=start_pos,
        eos_token_ids=tuple(eos_token_ids), max_new_tokens=max_new_tokens,
        result=result, t_start=t_start, logits=logits)


def _decode_request(params: QwenVLParams, state: PrefillState, input_ids,
                    temperature, top_p, seed, top_k, repetition_penalty,
                    attn_impl=None) -> GenerationResult:
    """One-shot decode of a prefilled request."""
    presence, first = None, state.next_token
    if repetition_penalty != 1.0:
        presence, first = rep_penalty_setup(
            params.lm.cfg.vocab_size, input_ids, state.logits, first,
            repetition_penalty, temperature, top_p, top_k, seed)
    res = state.result
    res.tokens = _run_decode_loop(
        params, state.cache, first, state.start_pos, state.eos_token_ids,
        state.max_new_tokens, temperature, top_p, seed, top_k,
        repetition_penalty, presence, attn_impl)
    res.total_seconds = time.perf_counter() - state.t_start
    return res


@torch.no_grad()
def generate_text_only(params: QwenVLParams, cfg: VLConfig, input_ids,
                       max_new_tokens: int, eos_token_ids,
                       temperature: float = 0.0, top_p: float = 1.0,
                       seed: int = 0, text_buckets=TEXT_BUCKETS,
                       _defer_decode: bool = False, top_k: int = 0,
                       repetition_penalty: float = 1.0, *, device,
                       attn_impl=None, attn_variant=None):
    """Text-only generation: plain causal prefill (1-D rope on all three
    M-RoPE axes) + decode, no vision branch."""
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
    state = _prefill_state(cfg, k_l, v_l, t_orig, first, t_orig,
                           eos_token_ids, max_new_tokens, result, t_start,
                           logits)
    if _defer_decode:
        return state
    return _decode_request(params, state, input_ids, temperature, top_p,
                           seed, top_k, repetition_penalty, attn_impl)


class QwenVLEngine:
    """Batch-1 generation engine (one image or text only); many requests
    share one decode through ``continuous.ContinuousBatcher``.

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
    """

    def __init__(self, cfg: VLConfig, params: QwenVLParams,
                 use_selector: bool = True, budget: float = 0.2,
                 vision_buckets=VISION_BUCKETS, text_buckets=TEXT_BUCKETS,
                 strategy=None, *, device, attn_impl: Optional[str] = None,
                 attn_variant: Optional[str] = None):
        if strategy is not None:
            raise NotImplementedError(
                "training-free strategies (and FastV/DART two-stage "
                "prefill) are not ported yet (ROADMAP §1 item 4)")
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
        self.cfg = cfg
        self.params = params
        self.use_selector = use_selector and params.scorer is not None
        self.budget = budget
        self.vision_buckets = vision_buckets
        self.text_buckets = text_buckets
        self.device = torch.device(device)
        self.attn_impl = attn_impl
        self.attn_variant = attn_variant

    def _prep_vision(self, input_ids, pixel_values, grid_thw):
        """Host-side prep, as the reference engine's: bucket choice,
        vision-batch index arrays, k/k_max, padded position maps and M-RoPE
        ids."""
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
        else:
            k = n
            k_max = l_pad

        is_img = input_ids == cfg.image_token_id
        image_pos = np.where(is_img)[0].astype(np.int64)
        assert len(image_pos) == n, (len(image_pos), n)
        text_pos = np.where(~is_img)[0]
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
            image_grid_thw=grid_thw,
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
        """Score a continuation given a context with one image or none:
        (sum log P(continuation | context), is_greedy), the lmms model
        ABC's ``loglikelihood``.

        The whole prompt, context + continuation, is prefilled once; the
        selector (or no compression, for ``orig``) applies to the vision
        tokens as in generation, and the continuation, a text suffix that
        compaction always keeps, is scored from the prefill's hidden
        states. Video and several images are not ported yet (ROADMAP §1
        item 6) and raise NotImplementedError."""
        if pixel_values_videos is not None or video_grid_thw is not None:
            raise NotImplementedError(
                "video input is not ported yet (ROADMAP §1 item 6)")
        input_ids = np.asarray(input_ids).reshape(-1)
        if len(input_ids) == 0:
            raise ValueError(
                "loglikelihood needs a non-empty context: token 0 has no "
                "position before it to be predicted from")
        cont_padded, c, c_max = ll_continuation_arrays(continuation_ids)
        full_ids = np.concatenate([input_ids, cont_padded[:c]])
        dev = self.device
        if pixel_values is None:
            return text_only_loglikelihood(
                self.params, full_ids, cont_padded, c, c_max,
                self.text_buckets, device=dev, attn_impl=self.attn_impl,
                attn_variant=self.attn_variant)
        if grid_thw is None or len(np.asarray(grid_thw)) != 1:
            raise NotImplementedError(
                "one image per request (several images: ROADMAP §1 item 6)")
        p = self._prep_vision(full_ids, pixel_values, grid_thw)
        ll, greedy = _prefill_ll(
            self.params, p.k_max, self.use_selector, c_max,
            self._vision_tensors(p.vb), p.n, p.k,
            torch.as_tensor(full_ids, device=dev),
            torch.as_tensor(p.image_pos_padded, device=dev),
            torch.as_tensor(p.text_pos_padded, device=dev), p.num_text,
            torch.as_tensor(p.position_ids, device=dev),
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
        """Generation for one image or a text-only request (no
        ``pixel_values``): greedy, or sampled with ``temperature`` /
        ``top_k`` / ``top_p`` from ``seed``, with an optional
        ``repetition_penalty``.

        input_ids: [T_orig] with the ``<|image_pad|>`` run already
        expanded. ``_defer_decode=True`` returns the ``PrefillState``
        instead of decoding (how a slot pool admits the request). Streaming,
        video and several images are not ported yet and raise
        NotImplementedError.
        """
        if pixel_values_videos is not None or video_grid_thw is not None:
            raise NotImplementedError(
                "video input is not ported yet (ROADMAP §1 item 6)")
        if on_token_chunk is not None:
            raise NotImplementedError(
                "streaming is not ported yet (ROADMAP §1 item 7)")
        cfg = self.cfg
        dev = self.device
        if eos_token_ids is None:
            eos_token_ids = (cfg.eos_token_id,)
        input_ids = np.asarray(input_ids).reshape(-1)
        sampling = (temperature, top_p, seed, top_k, repetition_penalty)
        if pixel_values is None:
            return generate_text_only(
                self.params, cfg, input_ids, max_new_tokens, eos_token_ids,
                temperature, top_p, seed, self.text_buckets, _defer_decode,
                top_k, repetition_penalty, device=dev,
                attn_impl=self.attn_impl, attn_variant=self.attn_variant)
        if grid_thw is None or len(np.asarray(grid_thw)) != 1:
            raise NotImplementedError(
                "one image per request (several images: ROADMAP §1 item 6)")
        t_start = time.perf_counter()

        p = self._prep_vision(input_ids, pixel_values, grid_thw)
        (next_token, sel_idx, sel_valid, sel_scores, valid_len,
         (k_l, v_l), logits) = _prefill(
            self.params, p.k_max, self.use_selector,
            self._vision_tensors(p.vb), p.n, p.k,
            torch.as_tensor(input_ids, device=dev),
            torch.as_tensor(p.image_pos_padded, device=dev),
            torch.as_tensor(p.text_pos_padded, device=dev), p.num_text,
            torch.as_tensor(p.position_ids, device=dev),
            attn_impl=self.attn_impl, attn_variant=self.attn_variant,
        )
        first = int(next_token)  # waits for the prefill
        t_prefill = time.perf_counter() - t_start
        valid_len = int(valid_len)

        sel_valid_np = sel_valid.cpu().numpy()
        result = GenerationResult(
            tokens=[],
            selected_indices=(sel_idx.cpu().numpy()[sel_valid_np]
                              if self.use_selector else None),
            num_vision_tokens=p.n,
            prefill_len=valid_len,
            prefill_seconds=t_prefill,
            scores=(sel_scores.cpu().numpy()[:p.n]
                    if self.use_selector else None),
            logits=logits,
            first_token_seconds=t_prefill,
        )
        state = _prefill_state(
            cfg, k_l, v_l, valid_len, first, valid_len + int(p.rope_delta),
            eos_token_ids, max_new_tokens, result, t_start, logits)
        if _defer_decode:
            return state
        return _decode_request(self.params, state, input_ids, *sampling,
                               attn_impl=self.attn_impl)


@torch.no_grad()
def _score_chunk(params: QwenVLParams, cache, cont_padded, cont_len: int,
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


def run_loglikelihood_choices(engine: QwenVLEngine, input_ids,
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
    not in value."""
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
