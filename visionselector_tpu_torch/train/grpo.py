"""Group Relative Policy Optimization (``--method grpo``).

Counterpart of ``visionselector_tpu.train.grpo`` (the reference's
``train_grpo.py`` + ``grpo_trainer.py``, trl's ``GRPOTrainer`` for the
Qwen-VL inputs, and ``reward_funcs.py``):
- rollouts: ``num_generations`` sampled completions per prompt through
  the serving engine (``rollout_group``; seed ``seed * 1000003 + g``),
  each ending at its first EOS;
- group-relative advantages ``r - mean``, divided by the unbiased std +
  1e-4 under ``scale_rewards`` (``group_advantages``);
- the clipped token-level surrogate with ``coef1 = exp(pi - detach(pi))``
  (one iteration per batch, as the reference runs), ``coef2 = clip(coef1,
  1 - eps_low, 1 + eps_high)``, plus ``beta * KL`` with ``KL = exp(ref -
  pi) - (ref - pi) - 1`` when beta > 0; reductions ``grpo`` (per-sequence
  mean, then the batch mean), ``bnpo`` (over all completion tokens) and
  ``dr_grpo`` (over rows x ``max_completion_length``);
- the rewards ``accuracy`` and ``format``.

The policy state and the frozen reference are DPO's (``dpo.py`` says how
the reference is held); with ``beta == 0`` there is no reference forward
and no reference at all. The scored log-probs divide the logits by the
sampling temperature (the distribution the rollouts were drawn from) and
come from the completion rows only (``dpo.token_logps``).
"""

from __future__ import annotations

import re
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from visionselector_tpu_torch.core import collectives
from visionselector_tpu_torch.train.dpo import (
    ReferencePolicy,
    init_dpo_state,
    sft_view,
    token_logps,
)
from visionselector_tpu_torch.train.loss import IGNORE_INDEX, batch_of_one
from visionselector_tpu_torch.train.sft import SFTScheduleConfig, SFTState
from visionselector_tpu_torch.train.train_step import (
    accumulate,
    data_parallel,
)

LOSS_TYPES = ("grpo", "bnpo", "dr_grpo")


class GRPOScheduleConfig(NamedTuple):
    total_steps: int = 1000
    lr: float = 1e-6  # trl's GRPO scale
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03
    max_grad_norm: float = 1.0
    remat: bool = False
    beta: float = 0.04  # KL weight (0: no reference forward)
    epsilon_low: float = 0.2
    epsilon_high: float = 0.2
    loss_type: str = "grpo"  # "grpo" | "bnpo" | "dr_grpo"
    num_generations: int = 4
    scale_rewards: bool = True
    temperature: float = 1.0
    top_p: float = 1.0
    max_completion_length: int = 64
    tune_mm_vision: bool = False
    tune_mm_mlp: bool = False
    tune_mm_llm: bool = True
    lora_rank: int = 0

    def sft_view(self) -> SFTScheduleConfig:
        return sft_view(self)


init_grpo_state = init_dpo_state


def group_advantages(rewards: np.ndarray, num_generations: int,
                     scale_rewards: bool = True) -> np.ndarray:
    """[B * G] rewards -> group-relative advantages (std with ddof 1, as
    torch's). Raises ValueError for fewer than 2 generations."""
    if num_generations < 2:
        raise ValueError(
            "GRPO needs num_generations >= 2 (a 1-member group has no "
            "relative advantage)")
    r = np.asarray(rewards, np.float32).reshape(-1, num_generations)
    adv = r - r.mean(axis=1, keepdims=True)
    if scale_rewards:
        adv = adv / (r.std(axis=1, keepdims=True, ddof=1) + 1e-4)
    return adv.reshape(-1)


def per_token_logps(params, sample, cfg, remat: bool = False,
                    temperature: float = 1.0,
                    attn_impl=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log P(label | prefix) per position [T - 1], zero outside the
    completion, and the completion mask [T - 1]) of one sample of either
    family, the logits divided by ``temperature`` (the rollouts' sampling
    distribution)."""
    lp, mask = token_logps(params, batch_of_one(sample), remat, attn_impl,
                           temperature)
    return lp[0], mask[0]


def grpo_loss(params, ref: Optional[ReferencePolicy], batch, advantages,
              sched: GRPOScheduleConfig, attn_impl=None, mesh=None):
    """The GRPO loss of a [B * G] completion batch with its advantages
    [B * G], under ``sched.loss_type``, and its metrics (``kl`` when beta
    > 0, ``clip_ratio``, ``completion_tokens``, ``advantage_mean``).

    Under data parallelism (``mesh``: this rank holds its part of the
    global batch) the token count of ``bnpo``, ``kl`` and ``clip_ratio``
    is the global batch's (summed over the "data" ranks) and ``dr_grpo``
    divides by the global row count, each rank's sum scaled by the rank
    count: the mean over the ranks, which ``train_step.accumulate`` takes,
    is the global batch's value. ``grpo``'s per-sequence mean needs no
    scaling."""
    if sched.loss_type not in LOSS_TYPES:
        raise ValueError(f"unknown GRPO loss type {sched.loss_type!r}")
    if sched.beta > 0.0:
        if ref is None:
            raise ValueError("GRPO with beta > 0 needs the reference policy")
        with ref.active():
            ref_lp, _ = token_logps(params, batch, sched.remat, attn_impl,
                                    sched.temperature)
    pol_lp, mask = token_logps(params, batch, sched.remat, attn_impl,
                               sched.temperature)
    maskf = mask.float()
    adv = torch.as_tensor(advantages, device=pol_lp.device).float()[:, None]
    coef1 = torch.exp(pol_lp - pol_lp.detach())
    coef2 = coef1.clamp(1.0 - sched.epsilon_low, 1.0 + sched.epsilon_high)
    pt_loss = -torch.minimum(coef1 * adv, coef2 * adv)
    n_tok, rows, scale = maskf.sum(), pt_loss.shape[0], 1.0
    if data_parallel(mesh):
        scale = mesh.size("data")
        n_tok = collectives.all_reduce(n_tok.detach().clone(),
                                       mesh.groups["data"])
        rows *= scale
    n_tok = n_tok.clamp(min=1.0)
    metrics = {}
    if sched.beta > 0.0:
        delta = ref_lp - pol_lp
        kl = torch.exp(delta) - delta - 1.0
        pt_loss = pt_loss + sched.beta * kl
        metrics["kl"] = scale * (kl * maskf).sum() / n_tok
    if sched.loss_type == "bnpo":
        loss = scale * (pt_loss * maskf).sum() / n_tok
    elif sched.loss_type == "dr_grpo":
        loss = scale * (pt_loss * maskf).sum() / (
            rows * sched.max_completion_length)
    else:
        loss = ((pt_loss * maskf).sum(-1)
                / maskf.sum(-1).clamp(min=1.0)).mean()
    clipped = (((coef1 < 1.0 - sched.epsilon_low) & (adv < 0))
               | ((coef1 > 1.0 + sched.epsilon_high) & (adv > 0)))
    metrics["clip_ratio"] = scale * (clipped * maskf).sum() / n_tok
    metrics["completion_tokens"] = maskf.sum(-1).mean()
    metrics["advantage_mean"] = adv.mean()
    return loss, metrics


def grpo_train_step(state: SFTState, ref: Optional[ReferencePolicy], params,
                    batch, advantages, cfg, sched: GRPOScheduleConfig,
                    attn_impl=None) -> Tuple[SFTState, dict]:
    """One GRPO update on a stacked [B * G] completion batch with its
    advantages [B * G] (host rewards, group-normalised). Returns (state,
    metrics: loss, kl, clip_ratio, completion_tokens, grad_norm, lr,
    advantage_mean)."""
    return accumulate(state, sched, [(batch, advantages)],
                      lambda mb: grpo_loss(params, ref, *mb, sched,
                                           attn_impl, state.mesh))


def grpo_train_step_accum(state: SFTState, ref: Optional[ReferencePolicy],
                          params, batches: List, advantages: List, cfg,
                          sched: GRPOScheduleConfig,
                          attn_impl=None) -> Tuple[SFTState, dict]:
    """One update from equal-sized micro-batches of completions and their
    advantages: ``grpo_train_step`` on the concatenated batch, one
    micro-batch's activations live at a time. Only the ``grpo`` reduction
    (a per-sequence mean) splits into equal-weight micro means; the others
    raise ValueError."""
    if sched.loss_type != "grpo":
        raise ValueError(
            "grpo_train_step_accum supports loss_type='grpo' only "
            "(bnpo / dr_grpo weight by the whole batch's token counts); "
            f"got {sched.loss_type!r}")
    return accumulate(state, sched, list(zip(batches, advantages)),
                      lambda mb: grpo_loss(params, ref, *mb, sched,
                                           attn_impl, state.mesh))


# ---------------------------------------------------------------------------
# Rewards (the reference's reward_funcs.py): f(completions, solution, **kw)
# -> [float].

_ANSWER_RE = re.compile(r"<answer>(.*?)</answer>", re.DOTALL)
_FORMAT_RE = re.compile(r"<think>.*?</think>\s*<answer>.*?</answer>",
                        re.DOTALL)


def _extract_answer(text: str) -> str:
    m = _ANSWER_RE.search(text)
    return (m.group(1) if m else text).strip()


def accuracy_reward(completions: Sequence[str], solution: Sequence[str],
                    **kwargs) -> List[float]:
    """1.0 when the extracted answers match: the same string, else equal
    numbers (the JAX package's stand-in for the reference's math_verify
    check, copied as it is)."""
    out = []
    for content, sol in zip(completions, solution):
        student, truth = _extract_answer(content), _extract_answer(sol)
        reward = 0.0
        if student == truth:
            reward = 1.0
        else:
            try:
                if abs(float(student) - float(truth)) < 1e-6:
                    reward = 1.0
            except ValueError:
                pass
        out.append(reward)
    return out


def format_reward(completions: Sequence[str], **kwargs) -> List[float]:
    """1.0 when the completion opens with the <think>/<answer> scaffold
    (``re.match``: anchored at the start)."""
    return [1.0 if _FORMAT_RE.match(c) else 0.0 for c in completions]


REWARD_FUNCS = {"accuracy": accuracy_reward, "format": format_reward}


# ---------------------------------------------------------------------------
# Rollouts and their training samples.


def rollout_group(engine, input_ids: np.ndarray,
                  pixel_values: Optional[np.ndarray],
                  grid_thw: Optional[np.ndarray], sched: GRPOScheduleConfig,
                  seed: int = 0,
                  eos_token_ids: Optional[Tuple[int, ...]] = None
                  ) -> List[np.ndarray]:
    """``num_generations`` sampled completions of one prompt: one engine
    ``generate`` each, member g with seed ``seed * 1000003 + g``."""
    outs = []
    for g in range(sched.num_generations):
        res = engine.generate(
            input_ids, pixel_values, grid_thw,
            max_new_tokens=sched.max_completion_length,
            temperature=sched.temperature, top_p=sched.top_p,
            seed=seed * 1000003 + g, eos_token_ids=eos_token_ids)
        outs.append(np.asarray(res.tokens, np.int32))
    return outs


def build_grpo_batch(cfg, image, prompt_before: Sequence[int],
                     prompt_after: Sequence[int],
                     completions: Sequence[Sequence[int]], budget: float,
                     s_bucket: int, t_bucket: int,
                     min_pixels: int = 56 * 56,
                     max_pixels: int = 28 * 28 * 1280,
                     family: str = "qwen25vl", align_windows: bool = True):
    """One prompt's G completions stacked into a [G] sample batch
    (``OVTrainSample`` for ``family="llava_ov15"``) whose labels supervise
    exactly the completion tokens."""
    from visionselector_tpu_torch.train.data import (
        build_train_sample,
        stack_samples,
    )
    from visionselector_tpu_torch.train.ov_loss import build_ov_train_sample

    if family == "llava_ov15":
        builder, kw = build_ov_train_sample, {}
    else:
        builder, kw = build_train_sample, dict(align_windows=align_windows)
    return stack_samples([
        builder(cfg, image, prompt_before, prompt_after,
                [int(t) for t in c], budget=budget, s_bucket=s_bucket,
                t_bucket=t_bucket, min_pixels=min_pixels,
                max_pixels=max_pixels, **kw)
        for c in completions])


def build_grpo_sample(cfg, images: Sequence, prompt_ids: Sequence[int],
                      slots: Sequence[int], completion: Sequence[int],
                      budget: float, s_bucket: int, t_bucket: int,
                      min_pixels: int = 56 * 56,
                      max_pixels: int = 28 * 28 * 1280,
                      family: str = "qwen25vl", align_windows: bool = True):
    """One rollout -> the training sample that supervises EXACTLY the
    sampled completion tokens (no decode / encode round trip, which BPE
    does not keep). ``prompt_ids`` are the raw (unexpanded) prompt tokens
    and ``slots[i]`` the offset of image i's vision run. Several images
    work for the Qwen family; the OV family takes one. ValueError without
    an image, or with several under OV (the reference asserts both)."""
    comp = [int(t) for t in completion]
    prompt_ids, slots = list(prompt_ids), list(slots)
    if not slots:
        raise ValueError("GRPO training samples need at least one image")
    if family == "llava_ov15":
        if len(slots) != 1:
            raise ValueError("OV GRPO samples take a single image")
        from visionselector_tpu_torch.train.ov_loss import (
            build_ov_train_sample,
        )

        return build_ov_train_sample(
            cfg, images[0], prompt_ids[:slots[0]], prompt_ids[slots[0]:],
            comp, budget=budget, s_bucket=s_bucket, t_bucket=t_bucket,
            min_pixels=min_pixels, max_pixels=max_pixels)
    from visionselector_tpu_torch.train.dataset import (
        build_sample_from_record,
    )

    rec = {"ids": prompt_ids + comp,
           "labels": [IGNORE_INDEX] * len(prompt_ids) + comp,
           "image": images[0], "images": list(images),
           "image_slot": slots[0], "image_slots": slots}
    return build_sample_from_record(
        cfg, rec, budget=budget, s_bucket=s_bucket, t_bucket=t_bucket,
        min_pixels=min_pixels, max_pixels=max_pixels,
        align_windows=align_windows)
