"""LLaVA-OneVision-1.5 selector training: forward, loss and samples.

Counterpart of ``visionselector_tpu.train.ov_loss`` (the reference's OV
soft-mask training path: the RICE tower, the soft top-k mask multiply,
the Qwen3 decoder, CE + reg_weight * BCE; the OV curriculum anneals
reg_weight 0.1 -> 3.0). Only the vision tower differs from the Qwen
path (``train.loss``): RICE with its CLS rows inserted and stripped, and
plain 1-D rope (all three position axes equal). The rest, the soft
selection, the scatter into the text row, one [B, T] decoder call
(``lm_prefill``, differentiable through the flash kernel's autograd
Function) and the fp32 head on the supervised rows, is
``loss.composite_batch_forward``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from visionselector_tpu_torch.core.config import OVConfig
from visionselector_tpu_torch.kernels.attention import FLASH_BLOCK
from visionselector_tpu_torch.models.llava_ov15 import rice as rice_mod
from visionselector_tpu_torch.models.qwen25vl import lm as lm_mod
from visionselector_tpu_torch.preprocess.image import preprocess_image
from visionselector_tpu_torch.preprocess.rope import expand_vision_tokens
from visionselector_tpu_torch.train.loss import (
    IGNORE_INDEX,
    batch_of_one,
    composite_batch_forward,
    scatter_vision,
)

# Per-sample scalars the host reads: they stay numpy in ``to_device``.
HOST_FIELDS = ("num_merged", "k")


class OVTrainSample(NamedTuple):
    """One statically shaped OV training sample (numpy on the host), or a
    batch of them stacked along a leading dim (``data.stack_samples``).
    The reference's fields, then RICE's kernel hint: S'_pad is the vision
    bucket + CLS slots rounded up to the flash kernel's 64-row tile with
    rows of segment 0, and ``kv_bounds`` are its kv-tile bounds."""

    pixel_values: np.ndarray  # [S_pad, patch_dim]
    rot_pos_ids: np.ndarray  # [S_pad, 2]
    insert_map: np.ndarray  # [S'_pad]
    strip_map: np.ndarray  # [S_pad]
    vit_seg_ids: np.ndarray  # [S'_pad]
    num_merged: np.ndarray  # scalar
    k: np.ndarray  # scalar: max(1, int(N * budget))
    input_ids: np.ndarray  # [T_pad]
    labels: np.ndarray  # [T_pad], IGNORE_INDEX where not supervised
    position_ids: np.ndarray  # [3, T_pad] (1-D rope: all axes equal)
    seg_ids: np.ndarray  # [T_pad] int32, 0 = padding
    image_positions: np.ndarray  # [L_pad] positions, sentinel T_pad
    kv_bounds: np.ndarray  # [S'_pad / 64, 2] kv-tile ranges

    host_fields = HOST_FIELDS  # a class attribute, not a field


def rice_tokens(params, batch: OVTrainSample, b: int, attn_impl):
    """Sample b's merged vision tokens [L_pad, D]; a graph only when the
    tower's weights require grad (SFT's ``--tune-mm-vision``)."""
    return rice_mod.rice_forward(
        params.visual, batch.pixel_values[b], batch.rot_pos_ids[b],
        batch.insert_map[b], batch.strip_map[b], batch.vit_seg_ids[b],
        kv_bounds=batch.kv_bounds[b], attn_impl=attn_impl)


def _rice(params, batch: OVTrainSample, b: int, attn_impl):
    """Sample b's merged vision tokens [L_pad, D] (frozen: no graph)."""
    with torch.no_grad():
        return rice_tokens(params, batch, b, attn_impl)


def ov_selector_batch_forward(params, batch: OVTrainSample, cfg: OVConfig,
                              reg_weight, k_max: int, remat: bool = False,
                              attn_impl=None):
    """Per-sample composite losses of a stacked OV batch (``to_device``).
    Returns (losses [B], {"ce", "bce", "soft_mass": [B]})."""
    return composite_batch_forward(
        params, batch, lambda b: _rice(params, batch, b, attn_impl),
        reg_weight, k_max, remat, attn_impl)


def ov_selector_train_forward(params, sample: OVTrainSample, cfg: OVConfig,
                              reg_weight, k_max: int, remat: bool = False,
                              attn_impl=None):
    """One sample's composite loss (a batch of one). Returns (loss,
    {"ce", "bce", "soft_mass"})."""
    losses, metrics = ov_selector_batch_forward(
        params, batch_of_one(sample), cfg, reg_weight, k_max, remat,
        attn_impl)
    return losses[0], {k: v[0] for k, v in metrics.items()}


def ov_forward_logits(params, sample: OVTrainSample, cfg: OVConfig,
                      remat: bool = False, attn_impl=None) -> torch.Tensor:
    """Uncompressed OV forward to fp32 logits [T_pad, V]: the RICE tower
    (with grad when its weights train), every merged token scattered (no
    selector mask), the decoder, the head. The counterpart of
    ``sft.sft_forward_logits`` for ``--family llava_ov15``
    (``sft.forward_logits`` dispatches on the sample type)."""
    one = batch_of_one(sample)
    embeds = scatter_vision(params.lm, sample.input_ids,
                            sample.image_positions,
                            rice_tokens(params, one, 0, attn_impl))
    hidden, _ = lm_mod.lm_prefill(
        params.lm, embeds[None], sample.position_ids[:, None, :],
        sample.seg_ids[None], attn_impl=attn_impl, remat=remat)
    return lm_mod.lm_head(params.lm, hidden[0])


def _sample(cfg: OVConfig, pixels, grid, full_ids, full_labels,
            budget: float, s_bucket: int, t_bucket: int) -> OVTrainSample:
    """The padded sample of one image's pixels and its token row."""
    rb = rice_mod.build_rice_batch(
        pixels, grid, spatial_merge_size=cfg.vision.spatial_merge_size,
        pad_to=s_bucket, cls_slots=max(len(grid), 4), tile=FLASH_BLOCK)
    n = rb.num_merged
    l_pad = s_bucket // cfg.vision.spatial_merge_unit
    t_real = len(full_ids)
    if t_real > t_bucket:
        raise ValueError(f"sample of {t_real} tokens exceeds the text "
                         f"bucket {t_bucket}")
    ids_p = np.zeros(t_bucket, np.int64)
    ids_p[:t_real] = full_ids
    lab_p = np.full(t_bucket, IGNORE_INDEX, np.int64)
    lab_p[:t_real] = full_labels
    pos_p = np.zeros((3, t_bucket), np.int64)
    pos_p[:, :t_real] = np.tile(np.arange(t_real), (3, 1))  # 1-D rope
    seg = np.zeros(t_bucket, np.int32)
    seg[:t_real] = 1
    image_pos = np.where(ids_p == cfg.image_token_id)[0][:n]
    image_pos_p = np.full(l_pad, t_bucket, np.int64)
    image_pos_p[:n] = image_pos
    return OVTrainSample(
        pixel_values=rb.pixel_values,
        rot_pos_ids=rb.rot_pos_ids,
        insert_map=rb.insert_map,
        strip_map=rb.strip_map,
        vit_seg_ids=rb.seg_ids,
        num_merged=np.asarray(n, np.int32),
        k=np.asarray(max(1, int(n * budget)), np.int32),
        input_ids=ids_p,
        labels=lab_p,
        position_ids=pos_p,
        seg_ids=seg,
        image_positions=image_pos_p,
        kv_bounds=rb.kv_bounds,
    )


def _pixels(cfg: OVConfig, image, min_pixels: int, max_pixels: int):
    return preprocess_image(
        image, min_pixels=min_pixels, max_pixels=max_pixels,
        patch_size=cfg.vision.patch_size,
        temporal_patch_size=cfg.vision.temporal_patch_size,
        merge_size=cfg.vision.spatial_merge_size)


def build_ov_sample_from_record(cfg: OVConfig, record: dict, budget: float,
                                s_bucket: int, t_bucket: int,
                                min_pixels: int = 56 * 56,
                                max_pixels: int = 28 * 28 * 1280
                                ) -> OVTrainSample:
    """Dataset record (``train.dataset.ConversationDataset``) ->
    OVTrainSample: the chat-templated ids / labels of the Qwen path with
    ``record["image"]``'s vision tokens at its slot, 1-D rope, the RICE
    vision batch. A text-only record raises ValueError."""
    ids = list(record["ids"])
    labels = list(record["labels"])
    slot = record["image_slot"]
    if record["image"] is None or slot < 0:
        raise ValueError("text-only records are not built into samples")
    pixels, grid = _pixels(cfg, record["image"], min_pixels, max_pixels)
    n = int(pixels.shape[0]) // cfg.vision.spatial_merge_unit
    vision_ids = ([cfg.vision_start_token_id] + [cfg.image_token_id] * n
                  + [cfg.vision_end_token_id])
    full_ids = np.asarray(ids[:slot] + vision_ids + ids[slot:], np.int64)
    full_labels = np.asarray(
        labels[:slot] + [IGNORE_INDEX] * len(vision_ids) + labels[slot:],
        np.int64)
    return _sample(cfg, pixels, grid, full_ids, full_labels, budget,
                   s_bucket, t_bucket)


def build_ov_train_sample(cfg: OVConfig, image, prompt_before, prompt_after,
                          answer_ids, budget: float, s_bucket: int,
                          t_bucket: int, min_pixels: int = 1,
                          max_pixels: int = 10**9) -> OVTrainSample:
    """One sample: [before][vision][after][answer]; loss on the answer
    only."""
    pixels, grid = _pixels(cfg, image, min_pixels, max_pixels)
    prompt_ids = expand_vision_tokens(
        list(prompt_before), list(prompt_after), grid,
        spatial_merge_size=cfg.vision.spatial_merge_size,
        image_token_id=cfg.image_token_id,
        vision_start_token_id=cfg.vision_start_token_id,
        vision_end_token_id=cfg.vision_end_token_id)
    answer = np.asarray(answer_ids, np.int64)
    full_ids = np.concatenate([prompt_ids, answer])
    full_labels = np.concatenate(
        [np.full(len(prompt_ids), IGNORE_INDEX, np.int64), answer])
    return _sample(cfg, pixels, grid, full_ids, full_labels, budget,
                   s_bucket, t_bucket)
