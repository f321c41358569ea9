"""Direct Preference Optimization (``--method dpo``).

Counterpart of ``visionselector_tpu.train.dpo`` (the reference's
``train_dpo.py`` + ``dpo_trainer.py``, trl's ``DPOTrainer`` for the VLM
inputs):
- chosen and rejected share the prompt and the image; a sequence's
  log-prob is the SUM of its label log-probs over the completion rows
  (the prompt is masked);
- ``sigmoid`` loss ``-logsigmoid(beta * ((pi_c - ref_c) - (pi_r -
  ref_r)))`` with trl's label smoothing, or ``ipo`` on length-normalised
  log-probs, ``(margin - 1 / (2 beta))^2``; ``rpo_alpha > 0`` adds
  ``alpha * CE(chosen)``;
- the policy trains under the SFT freeze policy (``--tune-mm-*``) or as
  LoRA adapters; AdamW, clipping and the schedule are SFT's.

The frozen reference policy (``ReferencePolicy``) is the policy's
starting weights, taken before a resume restores the trained ones, as the
reference takes its ``frozen`` tree before it adds LoRA. The port trains
its modules in place, so the reference is held without a second model:
- full model: a detached copy of the TRAINABLE tensors only, swapped into
  the same modules for the reference forward; frozen tensors are shared;
- LoRA: the same modules with the adapters off (``lora.adapters_off``),
  no copy at all.
The reference log-probs are computed under ``no_grad``, on the same batch
shapes and the same kernels as the policy's, and the head takes the same
route (``lm_head(..., upcast=True)``), so at step 0 the two are bit-equal:
the margin is 0 and the sigmoid loss ln 2.

Log-probs come from the supervised rows only: the fp32 head runs on the
label rows (one call per batch), not on the reference's [T, V] logits; the
values are the same. Policy and reference each take one [B, T] decoder
call for the chosen batch and one for the rejected batch.
"""

from __future__ import annotations

import contextlib
import os
from typing import List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from visionselector_tpu_torch.models.qwen25vl import lm as lm_mod
from visionselector_tpu_torch.train.lora import adapters_off, lora_leaf
from visionselector_tpu_torch.train.loss import IGNORE_INDEX, batch_of_one
from visionselector_tpu_torch.train.sft import (
    SFTScheduleConfig,
    SFTState,
    batch_hidden,
    init_sft_state,
)
from visionselector_tpu_torch.train.train_step import accumulate


class DPOScheduleConfig(NamedTuple):
    total_steps: int = 1000
    lr: float = 5e-7  # trl's DPO scale
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03
    max_grad_norm: float = 1.0
    remat: bool = False
    beta: float = 0.1
    loss_type: str = "sigmoid"  # "sigmoid" | "ipo"
    rpo_alpha: float = 0.0  # > 0 adds alpha * CE(chosen)
    label_smoothing: float = 0.0  # cDPO (trl semantics)
    tune_mm_vision: bool = False
    tune_mm_mlp: bool = False
    tune_mm_llm: bool = True
    lora_rank: int = 0

    def sft_view(self) -> SFTScheduleConfig:
        return sft_view(self)


def sft_view(sched) -> SFTScheduleConfig:
    """The freeze-policy / optimizer subset of a DPO or GRPO schedule: its
    fields that ``SFTScheduleConfig`` has."""
    return SFTScheduleConfig(**{f: getattr(sched, f)
                                for f in SFTScheduleConfig._fields})


def init_dpo_state(params, sched) -> SFTState:
    """The policy's state (``sft.init_sft_state`` under ``sft_view()``:
    what trains, AdamW, the step); DPO and GRPO states are SFT's."""
    return init_sft_state(params, sched.sft_view())


class ReferencePolicy:
    """The frozen reference policy of ``params``: the starting values of
    the state's trained base tensors (a detached copy; none under LoRA),
    with any adapter off. Build it before ``maybe_resume``: a resumed run
    still scores against the starting weights."""

    def __init__(self, params, state: SFTState):
        self.params = params
        with torch.no_grad():
            self.weights = {n: p.detach().clone()
                            for n, p in state.trainable().items()
                            if not lora_leaf(n)}
        self._named = {n: p for n, p in params.named_parameters()
                       if n in self.weights}

    @contextlib.contextmanager
    def active(self):
        """Inside the block, under ``no_grad``, ``params`` computes the
        reference policy; the trained values are back in place after."""
        saved = {}
        with torch.no_grad(), adapters_off(self.params.lm):
            try:
                for name, w in self.weights.items():
                    p = self._named[name]
                    saved[name] = p.data
                    p.data = w
                yield self.params
            finally:
                for name, d in saved.items():
                    self._named[name].data = d


def token_logps(params, batch, remat: bool = False, attn_impl=None,
                temperature: float = 1.0):
    """(log P(label | prefix) per position [B, T - 1], zero off the
    supervised rows, and the supervised-row mask [B, T - 1]) of a stacked
    batch of either family (``loss.to_device``): ``sft.batch_hidden``,
    then the fp32 head on the label rows only (one call for the batch),
    the logits divided by ``temperature``. Row t scores label t + 1, as
    the reference's ``logits[:-1]`` against ``labels[1:]``."""
    hidden = batch_hidden(params, batch, remat, attn_impl)
    labels = batch.labels[:, 1:]
    mask = labels != IGNORE_INDEX
    b_idx, t_idx = mask.nonzero(as_tuple=True)
    logits = lm_mod.lm_head(params.lm, hidden[:, :-1][b_idx, t_idx],
                            upcast=True) / temperature
    gold = logits.gather(-1, labels[b_idx, t_idx][:, None])[:, 0]
    lp = gold - torch.logsumexp(logits, dim=-1)
    out = lp.new_zeros(mask.shape).index_put((b_idx, t_idx), lp)
    return out, mask


def batch_sequence_logps(params, batch, remat: bool = False,
                         attn_impl=None):
    """(sum of label log-probs over the completion rows [B], completion
    length [B], CE [B]) of a stacked batch."""
    lp, mask = token_logps(params, batch, remat, attn_impl)
    total, n = lp.sum(-1), mask.sum(-1)
    return total, n, -total / n.clamp(min=1)


def sequence_logps(params, sample, cfg, remat: bool = False,
                   attn_impl=None) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """(sum log P(label | prefix) over the completion rows, completion
    length, CE) of one sample (``dpo.sequence_logps``): labels are
    IGNORE_INDEX outside the completion, the reference's ``loss_mask``."""
    total, n, ce = batch_sequence_logps(params, batch_of_one(sample), remat,
                                        attn_impl)
    return total[0], n[0], ce[0]


def dpo_losses(policy_c, policy_r, ref_c, ref_r, len_c, len_r,
               sched: DPOScheduleConfig) -> Tuple[torch.Tensor, dict]:
    """The mean DPO loss of [B] policy / reference sequence log-probs, and
    the reward metrics (chosen, rejected, margin, accuracy)."""
    beta = sched.beta
    if sched.loss_type == "ipo":
        nc, nr = len_c.clamp(min=1), len_r.clamp(min=1)
        margin = (policy_c / nc - ref_c / nc) - (policy_r / nr - ref_r / nr)
        losses = (margin - 1.0 / (2.0 * beta)) ** 2
    else:
        margin = (policy_c - ref_c) - (policy_r - ref_r)
        ls = sched.label_smoothing
        losses = (-F.logsigmoid(beta * margin) * (1.0 - ls)
                  - F.logsigmoid(-beta * margin) * ls)
    reward_c = beta * (policy_c - ref_c)
    reward_r = beta * (policy_r - ref_r)
    metrics = {
        "rewards_chosen": reward_c.mean(),
        "rewards_rejected": reward_r.mean(),
        "reward_margin": (reward_c - reward_r).mean(),
        "reward_accuracy": (reward_c > reward_r).float().mean(),
    }
    return losses.mean(), metrics


def dpo_pair_loss(params, ref: ReferencePolicy, chosen, rejected,
                  sched: DPOScheduleConfig, attn_impl=None):
    """The DPO loss of a pair batch and its metrics (with
    ``nll_chosen``): the reference's log-probs first (no graph), then the
    policy's."""
    with ref.active():
        ref_c, len_c, _ = batch_sequence_logps(params, chosen, sched.remat,
                                               attn_impl)
        ref_r, len_r, _ = batch_sequence_logps(params, rejected, sched.remat,
                                               attn_impl)
    pol_c, _, ce_c = batch_sequence_logps(params, chosen, sched.remat,
                                          attn_impl)
    pol_r, _, _ = batch_sequence_logps(params, rejected, sched.remat,
                                       attn_impl)
    loss, metrics = dpo_losses(pol_c, pol_r, ref_c, ref_r, len_c, len_r,
                               sched)
    nll = ce_c.mean()
    if sched.rpo_alpha > 0:
        loss = loss + sched.rpo_alpha * nll
    metrics["nll_chosen"] = nll
    return loss, metrics


def dpo_train_step(state: SFTState, ref: ReferencePolicy, params, chosen,
                   rejected, cfg, sched: DPOScheduleConfig,
                   attn_impl=None) -> Tuple[SFTState, dict]:
    """One DPO update on a (chosen, rejected) pair batch (a leading batch
    axis on both). Returns (state, metrics: loss, the rewards,
    nll_chosen, grad_norm (the trainables', before clipping), lr)."""
    return dpo_train_step_accum(state, ref, params, [chosen], [rejected],
                                cfg, sched, attn_impl)


def dpo_train_step_accum(state: SFTState, ref: ReferencePolicy, params,
                         chosen: List, rejected: List, cfg,
                         sched: DPOScheduleConfig,
                         attn_impl=None) -> Tuple[SFTState, dict]:
    """One update from equal-sized micro pair batches (gradients summed
    and divided by their count): ``dpo_train_step`` on the concatenated
    pairs, one micro-batch's activations live at a time."""
    return accumulate(state, sched, list(zip(chosen, rejected)),
                      lambda mb: dpo_pair_loss(params, ref, *mb, sched,
                                               attn_impl))


def build_dpo_pair_from_record(cfg, record: dict, tokenizer, budget: float,
                               s_bucket: int, t_bucket: int,
                               image_root: str = "",
                               min_pixels: int = 56 * 56,
                               max_pixels: int = 28 * 28 * 1280,
                               family: str = "qwen25vl",
                               align_windows: bool = True):
    """One preference record -> (chosen, rejected) samples
    (``OVTrainSample``s for ``family="llava_ov15"``): ``{"image", "prompt",
    "chosen", "rejected"}``, or a ``conversations`` list whose final
    assistant turn is replaced. Both share the prompt and the images; the
    prompt is everything before the final completion (earlier assistant
    turns included) and is fully masked. Several images work for the Qwen
    family (``align_windows``: its layout, as ``build_sample_from_record``);
    OV records take one (ValueError otherwise)."""
    from PIL import Image

    from visionselector_tpu_torch.train.dataset import (
        build_sample_from_record,
        render_conversation,
    )
    from visionselector_tpu_torch.train.ov_loss import (
        build_ov_sample_from_record,
    )

    img_path = record.get("image")
    paths = ([] if not img_path
             else img_path if isinstance(img_path, list) else [img_path])
    if "conversations" in record:
        base = list(record["conversations"])
        if base and base[-1].get("from", base[-1].get("role")) in (
                "gpt", "assistant"):
            base = base[:-1]
    else:
        prompt = record["prompt"]
        if "<image>" not in prompt and paths:
            prompt = "<image>" * len(paths) + prompt
        base = [{"from": "human", "value": prompt}]
    images = []
    for p in paths:
        with Image.open(os.path.join(image_root, p)) as im:
            images.append(im.convert("RGB").copy())
    if family == "llava_ov15":
        if len(images) > 1:
            raise ValueError("OV DPO records take a single image")
        builder, kw = build_ov_sample_from_record, {}
    else:
        builder, kw = build_sample_from_record, dict(
            align_windows=align_windows)
    prompt_len = len(render_conversation(base, tokenizer)[0])

    def build(answer_text):
        ids, labels, slots = render_conversation(
            base + [{"from": "gpt", "value": answer_text}], tokenizer)
        labels = [IGNORE_INDEX] * prompt_len + labels[prompt_len:]
        rec = {"ids": ids, "labels": labels,
               "image_slot": slots[0] if slots else -1,
               "image_slots": slots, "image": images[0] if images else None,
               "images": images, "video": None}
        return builder(cfg, rec, budget, s_bucket, t_bucket,
                       min_pixels=min_pixels, max_pixels=max_pixels, **kw)

    return build(record["chosen"]), build(record["rejected"])
