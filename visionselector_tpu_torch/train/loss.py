"""Training forward and composite loss of the LIS selector.

Counterpart of ``visionselector_tpu.train.loss`` (the reference's
``selector_model.py`` training path):

- the frozen vision tower runs under ``no_grad`` (nothing before the
  scorer trains), then the soft sigmoid top-k mask MULTIPLIES the merged
  tokens (no dropping),
- the masked tokens are scattered into the text sequence at the image
  positions (sentinel positions land in a dropped last row),
- loss = CE(shifted logits, labels) + reg_weight * BCE(soft mask, hard
  mask); labels == IGNORE_INDEX are ignored, and reg_weight is annealed
  linearly by the trainer.

The decoder runs a batch's samples as one [B, T] call; the ViT, the
selection and the loss run per sample, and a batch's loss is the mean of
its samples' losses (each CE normalised by its own supervised count), as
the reference's ``vmap`` computes it. The fp32 lm head runs on the
supervised rows only: the other rows add exactly zero to the CE and its
gradient.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from visionselector_tpu_torch.core.config import VLConfig
from visionselector_tpu_torch.models.qwen25vl import lm as lm_mod
from visionselector_tpu_torch.models.qwen25vl import vit as vit_mod
from visionselector_tpu_torch.selector.select import select_soft

IGNORE_INDEX = -100

# Per-sample scalars the host reads: they stay numpy in ``to_device``.
HOST_FIELDS = ("num_merged", "k", "window_diag", "window_kv_iters",
               "full_kv_iters")


class TrainBatchSample(NamedTuple):
    """One statically shaped training sample (numpy on the host), or a
    batch of them stacked along a leading dim (``data.stack_samples``).
    Vision arrays are bucket-padded, text arrays padded to T_pad with
    segment 0. The fields after ``full_kv_bounds`` are the vision batch's
    kernel hints (the reference's ``build_vision_batch`` has them too; its
    training sample drops them)."""

    pixel_values: np.ndarray  # [S_pad, patch_dim]
    rot_pos_ids: np.ndarray  # [S_pad, 2]
    window_seg_ids: np.ndarray  # [S_pad]
    full_seg_ids: np.ndarray  # [S_pad]
    reverse_index: np.ndarray  # [L_pad]
    num_merged: np.ndarray  # scalar
    k: np.ndarray  # scalar: max(1, int(N * budget))
    input_ids: np.ndarray  # [T_pad]
    labels: np.ndarray  # [T_pad], IGNORE_INDEX where not supervised
    position_ids: np.ndarray  # [3, T_pad]
    seg_ids: np.ndarray  # [T_pad] int32, 0 = padding
    image_positions: np.ndarray  # [L_pad] positions, sentinel T_pad
    window_kv_bounds: np.ndarray  # [S_pad / 64, 2] kv-tile ranges
    full_kv_bounds: np.ndarray  # [S_pad / 64, 2]
    window_diag: np.ndarray  # scalar bool: window layers block-diagonal
    window_kv_iters: np.ndarray  # scalar: kv-tile cap (0 = none)
    full_kv_iters: np.ndarray  # scalar

    host_fields = HOST_FIELDS  # a class attribute, not a field


def to_device(batch, device):
    """A stacked batch (``TrainBatchSample`` or ``ov_loss.OVTrainSample``)
    with its arrays on ``device``; the sample type's ``host_fields`` stay
    numpy."""
    cls = type(batch)
    return cls(**{
        f: (np.asarray(x) if f in cls.host_fields
            else torch.as_tensor(np.asarray(x), device=device))
        for f, x in batch._asdict().items()})


def batch_of_one(sample):
    """A sample (on the device) as a batch of one: a leading dim of 1."""
    cls = type(sample)
    return cls(**{f: np.asarray(x)[None] if f in cls.host_fields
                  else x[None] for f, x in sample._asdict().items()})


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over non-ignored positions. logits [T, V] fp32, labels [T]."""
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, 0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, safe[:, None])[:, 0]
    nll = (logz - gold) * valid
    return nll.sum() / valid.sum().clamp(min=1)


def bce(p: torch.Tensor, y: torch.Tensor, valid: torch.Tensor,
        eps: float = 1e-7) -> torch.Tensor:
    """Masked-mean binary cross entropy (torch F.binary_cross_entropy)."""
    p = p.clamp(eps, 1.0 - eps)
    per = -(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p))
    return (per * valid).sum() / valid.sum().clamp(min=1)


def vit_tokens(params, batch: TrainBatchSample, b: int, attn_impl):
    """Sample b's merged vision tokens [L_pad, D]; a graph only when the
    tower's weights require grad (SFT's ``--tune-mm-vision``)."""
    return vit_mod.vit_forward(
        params.visual, batch.pixel_values[b], batch.rot_pos_ids[b],
        batch.window_seg_ids[b], batch.full_seg_ids[b],
        batch.reverse_index[b],
        window_kv_bounds=batch.window_kv_bounds[b],
        full_kv_bounds=batch.full_kv_bounds[b],
        window_diag=bool(batch.window_diag[b]),
        window_kv_iters=int(batch.window_kv_iters[b]),
        full_kv_iters=int(batch.full_kv_iters[b]),
        attn_impl=attn_impl)


def _vision(params, batch: TrainBatchSample, b: int, attn_impl):
    """Sample b's merged vision tokens [L_pad, D] (frozen: no graph)."""
    with torch.no_grad():
        return vit_tokens(params, batch, b, attn_impl)


def scatter_vision(lm, input_ids, image_positions, tokens):
    """Text embeddings [T_pad, D] with ``tokens`` written at
    ``image_positions`` (sentinel positions T_pad land in a dropped row)."""
    text = lm_mod.embed_tokens(lm, input_ids)
    t_pad, d = text.shape
    full = torch.zeros(t_pad + 1, d, dtype=text.dtype, device=text.device)
    full[:t_pad] = text
    full[image_positions] = tokens.to(text.dtype)
    return full[:t_pad]


def supervised_ce(lm, hidden, labels):
    """One sample's CE from its final hidden states [T, D] (post-norm) and
    labels [T]: position t predicts label t + 1, and the fp32 head runs on
    the supervised rows only (the others add exactly zero to the CE and
    its gradient)."""
    labels = labels[1:]
    rows = (labels != IGNORE_INDEX).nonzero()[:, 0]
    logits = lm_mod.lm_head(lm, hidden[:-1][rows])  # fp32
    return cross_entropy(logits, labels[rows])


def composite_batch_forward(params, batch, vision, reg_weight, k_max: int,
                            remat: bool = False, attn_impl=None):
    """The composite loss of either family's stacked batch: ``vision(b)``
    gives sample b's merged tokens [L_pad, D] (frozen, no graph); then the
    soft selection, the scatter, one [B, T] decoder call and per-sample CE
    + reg_weight * BCE. Returns (losses [B], {"ce", "bce", "soft_mass":
    [B]})."""
    nb = batch.input_ids.shape[0]
    embeds, softs = [], []
    for b in range(nb):
        soft = select_soft(params.scorer, vision(b), int(batch.num_merged[b]),
                           int(batch.k[b]), k_max)
        embeds.append(scatter_vision(params.lm, batch.input_ids[b],
                                     batch.image_positions[b],
                                     soft.masked_tokens))
        softs.append(soft)
    hidden, _ = lm_mod.lm_prefill(
        params.lm, torch.stack(embeds), batch.position_ids.transpose(0, 1),
        batch.seg_ids, attn_impl=attn_impl, remat=remat)
    losses, ce_l, bce_l, mass_l = [], [], [], []
    for b, soft in enumerate(softs):
        ce = supervised_ce(params.lm, hidden[b], batch.labels[b])
        n = soft.soft_mask.shape[0]
        row_ok = (torch.arange(n, device=ce.device)
                  < int(batch.num_merged[b])).float()
        constraint = bce(soft.soft_mask, soft.hard_mask, row_ok)
        losses.append(ce + reg_weight * constraint)
        ce_l.append(ce)
        bce_l.append(constraint)
        mass_l.append((soft.soft_mask * row_ok).sum())
    return torch.stack(losses), {"ce": torch.stack(ce_l),
                                 "bce": torch.stack(bce_l),
                                 "soft_mass": torch.stack(mass_l)}


def selector_batch_forward(params, batch: TrainBatchSample, cfg: VLConfig,
                           reg_weight, k_max: int, remat: bool = False,
                           attn_impl=None):
    """Per-sample composite losses of a stacked batch (``to_device``).
    Returns (losses [B], {"ce", "bce", "soft_mass": [B]})."""
    return composite_batch_forward(
        params, batch, lambda b: _vision(params, batch, b, attn_impl),
        reg_weight, k_max, remat, attn_impl)


def selector_train_forward(params, sample: TrainBatchSample, cfg: VLConfig,
                           reg_weight, k_max: int, remat: bool = False,
                           attn_impl=None):
    """One sample's composite loss (a batch of one). Returns (loss,
    {"ce", "bce", "soft_mass"})."""
    losses, metrics = selector_batch_forward(params, batch_of_one(sample),
                                             cfg, reg_weight, k_max, remat,
                                             attn_impl)
    return losses[0], {k: v[0] for k, v in metrics.items()}


def reg_weight_schedule(step: int, total_steps: int, start: float = 0.1,
                        end: float = 2.0) -> float:
    """Linear curriculum annealing, in the reference's fp32 arithmetic."""
    frac = np.clip(np.float32(step) / np.float32(max(total_steps, 1)),
                   np.float32(0.0), np.float32(1.0))
    return float(np.float32(start) + np.float32(end - start) * frac)
