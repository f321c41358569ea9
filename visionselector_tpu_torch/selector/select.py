"""Token selection: hard top-k and sequence compaction (inference), soft
masking (training).

Counterpart of ``visionselector_tpu.selector.select``: scores ->
topk(k).indices -> ascending sort -> gather kept vision tokens; the LLM
sequence is compacted to text + kept-vision positions, and M-RoPE position
ids are computed on the ORIGINAL sequence then gathered. Unselected slots
hold a beyond-range sentinel that sorts last, so the compacted sequence is
a valid prefix of static length k_max + T_text_max. Training multiplies
the merged tokens by the soft top-k mask instead (no dropping), with the
hard top-k mask of the detached scores as the BCE target.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from visionselector_tpu_torch.kernels.topk import (
    hard_topk_indices,
    hard_topk_mask,
    soft_topk,
)
from visionselector_tpu_torch.selector.scorer import Scorer, score_tokens


class Selection(NamedTuple):
    """Result of hard top-k selection over merged vision tokens."""

    indices: torch.Tensor  # [k_max] int32 ascending; invalid = N_pad sentinel
    valid: torch.Tensor  # [k_max] bool
    scores: torch.Tensor  # [N_pad] fp32 raw scores
    k: int  # number of kept tokens


@torch.no_grad()
def select_hard(scorer: Scorer, merged_tokens: torch.Tensor, num_valid: int,
                k: int, k_max: int) -> Selection:
    """Score merged tokens [N_pad, D] (padding rows at the end) and keep the
    top k of the first ``num_valid``."""
    scores = score_tokens(scorer, merged_tokens, valid_len=num_valid)
    idx, valid = hard_topk_indices(scores, k, k_max, valid_len=num_valid)
    return Selection(indices=idx, valid=valid, scores=scores, k=k)


class SoftSelection(NamedTuple):
    masked_tokens: torch.Tensor  # [N_pad, D] tokens * soft mask
    soft_mask: torch.Tensor  # [N_pad] fp32, sums to k over valid rows
    hard_mask: torch.Tensor  # [N_pad] fp32 0/1 constraint target (no grad)


def select_soft(scorer: Scorer, merged_tokens: torch.Tensor, num_valid: int,
                k: int, k_max: int) -> SoftSelection:
    """Differentiable selection for training: the tokens times the soft
    top-k mask. Padding rows take part in the bisection with a score floor
    of -1e4 (finite, so the bracket stays sane; their sigmoid mass is ~0)
    and the mask is zeroed there."""
    scores = score_tokens(scorer, merged_tokens, valid_len=num_valid)
    n = scores.shape[0]
    row_ok = torch.arange(n, device=scores.device) < num_valid
    masked_scores = torch.where(row_ok, scores, -1e4)
    soft = soft_topk(masked_scores[None], k)[0] * row_ok
    hard = hard_topk_mask(scores.detach(), k, k_max, valid_len=num_valid)
    masked_tokens = (merged_tokens * soft[:, None]).to(merged_tokens.dtype)
    return SoftSelection(masked_tokens=masked_tokens, soft_mask=soft,
                         hard_mask=hard)


class CompactedSequence(NamedTuple):
    """Physically compacted LLM input (valid-prefix layout)."""

    embeds: torch.Tensor  # [T_comp, D]
    position_ids: torch.Tensor  # [3, T_comp]
    seg_ids: torch.Tensor  # [T_comp] int32: 1 on the valid prefix, 0 after
    valid_len: int
    selected_positions: torch.Tensor  # [T_comp] original-sequence positions


def compact_sequence(text_embeds, vision_embeds, selection: Selection,
                     image_positions, text_positions, num_text: int,
                     position_ids_orig) -> CompactedSequence:
    """Build the compressed LLM input sequence.

    text_embeds: [T_orig, D] embeddings of the original sequence;
    vision_embeds: [N_pad, D] merged ViT outputs (original order);
    image_positions: [N_pad] position of the j-th vision token in the
    original sequence (sentinel T_orig for padding rows); text_positions:
    [T_text_max] non-image positions (sentinel T_orig past num_text);
    position_ids_orig: [3, T_orig] M-RoPE ids of the original sequence.
    """
    t_orig, d = text_embeds.shape
    sentinel = t_orig
    dev = text_embeds.device

    img_pos_padded = torch.cat([
        image_positions, torch.tensor([sentinel], device=dev,
                                      dtype=image_positions.dtype)])
    retain_img_pos = torch.where(
        selection.valid, img_pos_padded[selection.indices.long()], sentinel)
    combined = torch.cat([retain_img_pos, text_positions.to(
        retain_img_pos.dtype)])
    selected_positions = torch.sort(combined).values  # sentinels last
    t_comp = selected_positions.shape[0]
    valid_len = num_text + selection.k

    # Text embeds with vision embeds scattered into the image slots, then
    # gathered. Padding rows of image_positions all carry the sentinel, so
    # their duplicate writes race only for row t_orig, which is gathered
    # solely by the padding rows past valid_len: which write wins is
    # irrelevant.
    full = torch.zeros(t_orig + 1, d, dtype=text_embeds.dtype, device=dev)
    full[:t_orig] = text_embeds
    full[image_positions] = vision_embeds.to(text_embeds.dtype)
    embeds = full[selected_positions.clamp(max=sentinel)]

    pos = F.pad(position_ids_orig, (0, 1))  # sentinel -> position 0
    position_ids = pos[:, selected_positions]
    seg_ids = (torch.arange(t_comp, device=dev) < valid_len).to(torch.int32)
    return CompactedSequence(
        embeds=embeds, position_ids=position_ids, seg_ids=seg_ids,
        valid_len=valid_len, selected_positions=selected_positions,
    )
