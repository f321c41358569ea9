"""LLaVA-OneVision-1.5 end to end: RICE tower -> (select) -> compaction ->
prefill -> decode.

Counterpart of ``visionselector_tpu.models.llava_ov15.model``. The RICE
tower (``rice.py``) and the LIS selection run first
(``_rice_encode_select``); everything after the merged vision tokens is
the Qwen engine's family-agnostic code (``qwen25vl.model``: the
from-vision prefill, the two-stage LLM-side prefill, the decode loop,
scoring, batched decode, sessions, the prefix cache,
``continuous.ContinuousBatcher`` and speculative decoding:
``generate_speculative`` and speculative slots need only ``generate``'s
deferred prefill and ``params.lm``), here over the Qwen3 text model. That
text model uses plain 1-D rope: the position ids are ``arange(T)`` on all
three axes, the rope delta is 0, and decode continues at the compacted
length (kept tokens keep their original positions, so decode positions
restart below the last kept one, as in the reference).

Images (one or several) and video frames go through one RICE call, image
rows first; every frame of a video is a segment of its own with its own
CLS row (temporal patch 1).
"""

from __future__ import annotations

import time
from types import SimpleNamespace
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from visionselector_tpu_torch.core.config import OVConfig
from visionselector_tpu_torch.core.params import init_random_
from visionselector_tpu_torch.kernels.attention import FLASH_BLOCK
from visionselector_tpu_torch.models.llava_ov15 import rice as rice_mod
from visionselector_tpu_torch.models.qwen25vl import lm as lm_mod
from visionselector_tpu_torch.models.qwen25vl.model import (
    _decode_request,
    _prefill_from_vision_ll,
    _vision_inputs,
    from_vision_state,
    generate_text_only,
    ll_continuation_arrays,
    llm_side_state,
    run_generate_batch,
    sequence_tensors,
    text_only_loglikelihood,
    vit_side_state,
)
from visionselector_tpu_torch.preprocess.indices import pick_bucket
from visionselector_tpu_torch.selector.scorer import Scorer
from visionselector_tpu_torch.selector.select import select_hard

# The reference OV engine's buckets (RICE patches; text tokens).
VISION_BUCKETS = (256, 512, 1024, 2048, 4096, 8192)
TEXT_BUCKETS = (64, 128, 256, 512, 1024)


class OVParams(nn.Module):
    """All weights: RICE tower, Qwen3 decoder, optional LIS scorer (fp32),
    and the config they were built for."""

    def __init__(self, visual: rice_mod.RiceTower, lm: lm_mod.LanguageModel,
                 scorer: Optional[Scorer] = None,
                 cfg: Optional[OVConfig] = None):
        super().__init__()
        self.visual = visual
        self.lm = lm
        self.scorer = scorer
        self.cfg = cfg


def init_ov_params(cfg: OVConfig, generator: torch.Generator, device,
                   dtype: torch.dtype | None = None,
                   with_selector: bool = True) -> OVParams:
    """Random weights drawn from ``generator`` (on ``device``) with the
    reference's scales; the scorer fp32 with std
    ``SelectorConfig.init_scale``."""
    dtype = dtype or cfg.torch_dtype
    visual = rice_mod.init_rice_params(cfg.vision, generator, device, dtype)
    lm = lm_mod.init_lm_params(cfg.text, generator, device, dtype)
    scorer = None
    if with_selector:
        sel = cfg.selector or cfg.with_selector().selector
        scorer = Scorer(sel, device)
        init_random_(scorer, generator, std=sel.init_scale)
    return OVParams(visual, lm, scorer, cfg)


@torch.no_grad()
def _rice_encode_select(params: OVParams, k_max: int, use_selector: bool,
                        rt: dict, num_merged: int, k: int, attn_impl=None):
    """RICE forward + (optional) LIS hard selection: (merged [L_pad, D],
    indices [k_max] ascending with sentinel L_pad, valid [k_max], LIS
    scores [L_pad] or None)."""
    merged = rice_mod.rice_forward(params.visual, attn_impl=attn_impl, **rt)
    if use_selector:
        sel = select_hard(params.scorer, merged, num_merged, k, k_max)
        return merged, sel.indices, sel.valid, sel.scores
    n_pad = merged.shape[0]
    idx = torch.arange(k_max, dtype=torch.int32, device=merged.device)
    valid = idx < num_merged
    return merged, torch.where(valid, idx, n_pad), valid, None


class OVEngine:
    """Batch-1 generation engine for LLaVA-OneVision-1.5 (images, video
    frames, both, or text only); many requests share one decode through
    ``continuous.ContinuousBatcher`` (one-shot admissions: the engine has
    no ``start_chunked_prefill``).

    ``strategy``: a training-free baseline in place of the LIS selector: a
    ViT-side one runs ``rice_forward_stats``, an LLM-side one (FastV, DART,
    Dynamic-Qwen) the two-stage prefill. ``attn_impl="plain"`` runs every
    attention through the plain PyTorch paths (to hold the whole model
    against the kernels on the card); the default runs the CUDA kernels on
    a CUDA device: RICE's blocks and the causal prefill through the flash
    kernel, decode through the decode kernel."""

    def __init__(self, cfg: OVConfig, params: OVParams,
                 use_selector: bool = True, budget: float = 0.2,
                 strategy=None, *, device, attn_impl: Optional[str] = None):
        self.cfg = cfg
        self.params = params
        self.strategy = strategy
        self.use_selector = (strategy is None and use_selector
                             and params.scorer is not None)
        self.budget = budget
        self.vision_buckets = VISION_BUCKETS
        self.text_buckets = TEXT_BUCKETS
        self.device = torch.device(device)
        self.attn_impl = attn_impl
        if getattr(strategy, "device", False) is None:
            strategy.device = self.device  # Dynamic-Qwen's predictor

    def _prep_vision(self, input_ids, pixel_values, grid_thw, has_img: bool,
                     is_video: bool):
        """Host-side prep, as the reference engine's: bucket, RICE batch
        (CLS maps, segments, bounds at the kernel's tile), k / k_max,
        padded position maps, 1-D rope ids."""
        cfg = self.cfg
        input_ids = np.asarray(input_ids).reshape(-1)
        t_orig = len(input_ids)
        s_bucket = pick_bucket(pixel_values.shape[0],
                               list(self.vision_buckets))
        grid = np.asarray(grid_thw)
        # One CLS slot per segment (image, or video frame), at least 8 as
        # the reference allots (it counts grid rows, which for a video of
        # more than 8 frames is too few).
        rb = rice_mod.build_rice_batch(
            pixel_values, grid,
            spatial_merge_size=cfg.vision.spatial_merge_size,
            pad_to=s_bucket, cls_slots=max(int(grid[:, 0].sum()), 8),
            tile=FLASH_BLOCK)
        n = rb.num_merged
        l_pad = s_bucket // cfg.vision.spatial_merge_unit
        if self.use_selector:
            k_max = max(1, int(l_pad * self.budget))
            k = min(max(1, int(n * self.budget)), k_max)
        elif self.strategy is not None:
            k = None  # the strategy decides
            k_max = min(l_pad, int(l_pad * self.budget) + 2)
        else:
            k, k_max = n, l_pad
        # merged tokens come image grids first, then video grids
        is_img = input_ids == cfg.image_token_id
        is_vid = input_ids == cfg.video_token_id
        is_vision = ((is_img if has_img else False)
                     | (is_vid if is_video else False))
        image_pos = np.concatenate([
            np.where(is_img)[0] if has_img else [],
            np.where(is_vid)[0] if is_video else [],
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
        # round the compacted length (k_max + text bucket) to a multiple of
        # 128, as the reference does
        t_text_bucket += (-(k_max + t_text_bucket)) % 128
        text_pos_padded = np.full(t_text_bucket, t_orig, np.int64)
        text_pos_padded[:num_text] = text_pos
        return SimpleNamespace(
            rb=rb, n=n, k=k, k_max=k_max, l_pad=l_pad, s_bucket=s_bucket,
            image_pos=image_pos, text_pos=text_pos, num_text=num_text,
            image_pos_padded=image_pos_padded,
            text_pos_padded=text_pos_padded, t_text_bucket=t_text_bucket,
            # 1-D rope: all three axes arange(T)
            position_ids=np.tile(np.arange(t_orig), (3, 1)), rope_delta=0,
            t_orig=t_orig, grid_thw=rb.grid_thw)

    def _rice_tensors(self, rb) -> dict:
        """The ``rice_forward`` inputs of a RiceBatch, on the device."""
        dev = self.device

        def t(x):
            return torch.as_tensor(np.asarray(x), device=dev)

        return dict(pixel_values=t(rb.pixel_values),
                    rot_pos_ids=t(rb.rot_pos_ids),
                    insert_map=t(rb.insert_map), strip_map=t(rb.strip_map),
                    seg_ids=t(rb.seg_ids), kv_bounds=t(rb.kv_bounds))

    def _prepared(self, input_ids, pixel_values, grid_thw,
                  pixel_values_videos, video_grid_thw):
        """(pixel rows, ``_prep_vision`` namespace), or (None, None) for a
        text-only request."""
        pixels, grid, img_grid, vid_grid = _vision_inputs(
            pixel_values, grid_thw, pixel_values_videos, video_grid_thw)
        if pixels is None:
            return None, None
        return pixels, self._prep_vision(input_ids, pixels, grid,
                                         img_grid is not None,
                                         vid_grid is not None)

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
        """(sum log P(continuation | context), is_greedy), the lmms model
        ABC's ``loglikelihood``: the RICE tower and the selection, then one
        compacted prefill of context + continuation, scored from its hidden
        states. A strategy engine raises NotImplementedError.
        ``second_per_grid_ts`` is taken for the adapter's sake (1-D rope
        has no temporal scaling)."""
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
        _, p = self._prepared(full_ids, pixel_values, grid_thw,
                              pixel_values_videos, video_grid_thw)
        if p is None:
            return text_only_loglikelihood(
                self.params, full_ids, cont_padded, c, c_max,
                self.text_buckets, device=dev, attn_impl=self.attn_impl)
        merged, idx, valid, _ = _rice_encode_select(
            self.params, p.k_max, self.use_selector,
            self._rice_tensors(p.rb), p.n, p.k, self.attn_impl)
        ll, greedy = _prefill_from_vision_ll(
            self.params, c_max, merged, idx, valid, p.k,
            *sequence_tensors(p, full_ids, dev),
            torch.as_tensor(cont_padded, device=dev), c,
            attn_impl=self.attn_impl)
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
        """Generation with the keywords of ``QwenVLEngine.generate``:
        images, video frames, both or text only; greedy or sampled; a
        repetition penalty; streamed through ``on_token_chunk``;
        ``_defer_decode=True`` returns the ``PrefillState`` (a slot pool's
        admission). ``second_per_grid_ts`` is taken for the adapter's sake
        (1-D rope has no temporal scaling)."""
        cfg = self.cfg
        if eos_token_ids is None:
            eos_token_ids = (cfg.eos_token_id,)
        input_ids = np.asarray(input_ids).reshape(-1)
        t_start = time.perf_counter()
        _, p = self._prepared(input_ids, pixel_values, grid_thw,
                              pixel_values_videos, video_grid_thw)
        if p is None:
            return generate_text_only(
                self.params, cfg, input_ids, max_new_tokens, eos_token_ids,
                temperature, top_p, seed, self.text_buckets, _defer_decode,
                top_k, repetition_penalty, device=self.device,
                attn_impl=self.attn_impl, on_token_chunk=on_token_chunk)
        rt = self._rice_tensors(p.rb)
        if getattr(self.strategy, "llm_side", False):
            merged = rice_mod.rice_forward(self.params.visual,
                                           attn_impl=self.attn_impl, **rt)
            state = llm_side_state(self, p, input_ids, merged, eos_token_ids,
                                   max_new_tokens, t_start)
        elif self.strategy is not None:
            merged, recv, keys = rice_mod.rice_forward_stats(
                self.params.visual, attn_impl=self.attn_impl, **rt)
            state = vit_side_state(self, p, input_ids, merged, recv, keys,
                                   eos_token_ids, max_new_tokens, t_start)
        else:
            merged, idx, valid, scores = _rice_encode_select(
                self.params, p.k_max, self.use_selector, rt, p.n, p.k,
                self.attn_impl)
            selected = None
            if self.use_selector:
                selected = idx.cpu().numpy()[valid.cpu().numpy()]
                scores = scores.cpu().numpy()[:p.n]
            state = from_vision_state(
                self, p, input_ids, merged, idx, valid, p.k, selected,
                scores, eos_token_ids, max_new_tokens, t_start)
        if _defer_decode:
            return state
        return _decode_request(self.params, state, input_ids, temperature,
                               top_p, seed, top_k, repetition_penalty,
                               attn_impl=self.attn_impl,
                               on_chunk=on_token_chunk)

    def generate_batch(self, requests: List[dict], max_new_tokens: int = 64,
                       eos_token_ids=None, temperature: float = 0.0,
                       top_p: float = 1.0, seed: int = 0, top_k: int = 0,
                       repetition_penalty: float = 1.0):
        """Decode-batched generation (``run_generate_batch``): each request
        prefills on its own, then one batched decode serves them all."""
        return run_generate_batch(
            self, requests, max_new_tokens=max_new_tokens,
            eos_token_ids=eos_token_ids, temperature=temperature,
            top_p=top_p, seed=seed, top_k=top_k,
            repetition_penalty=repetition_penalty)
