"""Baseline SFT (``--method sft``): plain CE training of the model under
the ``--tune-mm-*`` freeze policy, or of LoRA adapters.

Counterpart of ``visionselector_tpu.train.sft`` (the reference's
``train_qwen.py``, ``set_model`` :70-93; for the OV family
``llava-ov-15/src/train/train_sft.py``). The freeze policy is
``requires_grad``: ``trainable_mask`` marks the parameters that train,
and AdamW and the global-norm clip see only those (optax's ``masked``
there). The vision tower runs with grad only when its weights train
(``--tune-mm-vision`` / ``--tune-mm-mlp``); through the window layers that
is the diag kernel through ``attention.FlashAttentionFn``.

The CE is computed on the supervised rows only (``loss.supervised_ce``),
which is the reference's full-row head's value without its [T, V] fp32
logits; a batch's loss is the mean of its samples' CEs. The logged
``grad_norm`` is the trainable parameters' norm (the one clipped); the
reference logs the norm of every leaf's gradient, frozen ones included.
bf16 gradients accumulate in bf16 over micro-batches (the reference sums
them in fp32).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Tuple

import torch

from visionselector_tpu_torch.models.qwen25vl import lm as lm_mod
from visionselector_tpu_torch.train.lora import lora_leaf
from visionselector_tpu_torch.train.loss import (
    batch_of_one,
    scatter_vision,
    supervised_ce,
    vit_tokens,
)
from visionselector_tpu_torch.train.ov_loss import (
    OVTrainSample,
    ov_forward_logits,
    rice_tokens,
)
from visionselector_tpu_torch.train.train_step import (
    accumulate,
    make_optimizer,
)


class SFTScheduleConfig(NamedTuple):
    total_steps: int = 1000
    lr: float = 1e-5
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03
    max_grad_norm: float = 1.0  # reference TrainingArguments default
    remat: bool = False  # gradient checkpointing of the decoder layers
    tune_mm_vision: bool = False
    tune_mm_mlp: bool = False
    tune_mm_llm: bool = True
    # LoRA: rank > 0 trains ONLY the adapters (the reference requires a
    # frozen LLM with LoRA, train_sft_visionselector.py:160-161)
    lora_rank: int = 0


@dataclasses.dataclass
class SFTState:
    trainables: dict  # {name: parameter} of the model's trained subset
    optimizer: torch.optim.AdamW
    step: int = 0  # updates taken
    mesh: object = None  # data parallelism (train_step.accumulate)

    def trainable(self) -> dict:
        """{name: parameter} of what trains (and what a checkpoint holds)."""
        return self.trainables


def trainable_mask(params, sched: SFTScheduleConfig) -> dict:
    """{parameter name: trains?}, the reference's ``set_model`` policy:
    ``visual.merger*`` under ``tune_mm_mlp`` (which overrides the vision
    flag for the merger, as the reference applies it after), the rest of
    ``visual.*`` under ``tune_mm_vision``, ``lm.*`` under ``tune_mm_llm``;
    the scorer never trains here. With ``lora_rank > 0`` only the adapters
    train."""

    def mark(name: str) -> bool:
        if sched.lora_rank > 0:
            return lora_leaf(name)
        if name.startswith("visual.merger"):
            return sched.tune_mm_mlp
        if name.startswith("visual."):
            return sched.tune_mm_vision
        if name.startswith("lm."):
            return sched.tune_mm_llm
        return False  # the scorer

    return {name: mark(name) for name, _ in params.named_parameters()}


def init_sft_state(params, sched: SFTScheduleConfig) -> SFTState:
    """Set ``requires_grad`` by ``trainable_mask`` and make AdamW over the
    trainable parameters (optimizer state in their dtype, as optax keeps
    it). Raises ValueError when nothing would train."""
    mask = trainable_mask(params, sched)
    trainables = {}
    for name, p in params.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            trainables[name] = p
    if not trainables:
        raise ValueError("SFT with every parameter frozen trains nothing "
                         "(--tune-mm-llm, --tune-mm-vision, --tune-mm-mlp "
                         "or --lora-rank)")
    return SFTState(trainables, make_optimizer(trainables.values(), sched))


def _tower_tokens(params, batch, b: int, attn_impl):
    tokens = rice_tokens if isinstance(batch, OVTrainSample) else vit_tokens
    return tokens(params, batch, b, attn_impl)


def sft_forward_logits(params, sample, cfg, remat: bool = False,
                       attn_impl=None) -> torch.Tensor:
    """Uncompressed Qwen2.5-VL forward of one sample to fp32 logits
    [T_pad, V]: the full ViT (with grad when its weights train), every
    merged token scattered, the decoder, the head (JAX
    ``sft.sft_forward_logits``; the DPO / GRPO log-prob scorers read it)."""
    one = batch_of_one(sample)
    embeds = scatter_vision(params.lm, sample.input_ids,
                            sample.image_positions,
                            vit_tokens(params, one, 0, attn_impl))
    hidden, _ = lm_mod.lm_prefill(
        params.lm, embeds[None], sample.position_ids[:, None, :],
        sample.seg_ids[None], attn_impl=attn_impl, remat=remat)
    return lm_mod.lm_head(params.lm, hidden[0])


def forward_logits(params, sample, cfg, remat: bool = False,
                   attn_impl=None) -> torch.Tensor:
    """Family dispatch on the sample type: an ``OVTrainSample`` goes to
    ``ov_loss.ov_forward_logits``, a ``TrainBatchSample`` to
    ``sft_forward_logits``."""
    fwd = (ov_forward_logits if isinstance(sample, OVTrainSample)
           else sft_forward_logits)
    return fwd(params, sample, cfg, remat=remat, attn_impl=attn_impl)


def batch_hidden(params, batch, remat: bool = False,
                 attn_impl=None) -> torch.Tensor:
    """The uncompressed forward of a stacked batch of either family
    (``loss.to_device``) up to the decoder's final norm: each sample's
    vision tower, every merged token scattered, one [B, T] decoder call.
    Returns hidden [B, T, D]."""
    nb = batch.input_ids.shape[0]
    embeds = torch.stack([
        scatter_vision(params.lm, batch.input_ids[b],
                       batch.image_positions[b],
                       _tower_tokens(params, batch, b, attn_impl))
        for b in range(nb)])
    hidden, _ = lm_mod.lm_prefill(
        params.lm, embeds, batch.position_ids.transpose(0, 1),
        batch.seg_ids, attn_impl=attn_impl, remat=remat)
    return hidden


def sft_batch_forward(params, batch, cfg, remat: bool = False,
                      attn_impl=None):
    """Per-sample CEs of a stacked batch of either family: ``batch_hidden``,
    then the head on the supervised rows. Returns (losses [B], {"ce":
    [B]})."""
    hidden = batch_hidden(params, batch, remat, attn_impl)
    ce = torch.stack([supervised_ce(params.lm, hidden[b], batch.labels[b])
                      for b in range(hidden.shape[0])])
    return ce, {"ce": ce}


def sft_train_forward(params, sample, cfg, remat: bool = False,
                      attn_impl=None):
    """One sample's CE (a batch of one). Returns (loss, {"ce"})."""
    losses, metrics = sft_batch_forward(params, batch_of_one(sample), cfg,
                                        remat, attn_impl)
    return losses[0], {k: v[0] for k, v in metrics.items()}


def sft_train_step(state: SFTState, params, batch, cfg,
                   sched: SFTScheduleConfig,
                   attn_impl=None) -> Tuple[SFTState, dict]:
    """One update on ``batch``. Returns (state, metrics: loss, ce,
    grad_norm (the trainables', before clipping), lr)."""
    return sft_train_step_accum(state, params, [batch], cfg, sched,
                                attn_impl)


def sft_train_step_accum(state: SFTState, params, batches: List, cfg,
                         sched: SFTScheduleConfig,
                         attn_impl=None) -> Tuple[SFTState, dict]:
    """One update from equal-sized micro-batches (gradients summed and
    divided by their count)."""

    def loss_fn(mb):
        losses, metrics = sft_batch_forward(params, mb, cfg, sched.remat,
                                            attn_impl)
        return losses.mean(), {k: v.mean() for k, v in metrics.items()}

    return accumulate(state, sched, batches, loss_fn)
