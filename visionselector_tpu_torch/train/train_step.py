"""Training step of the LIS selector against a frozen backbone.

Counterpart of ``visionselector_tpu.train.train_step`` (the reference's
``train_qwen_selector.py``: only ``importance_scorer`` trains, AdamW,
warmup-cosine learning rate, reg_weight annealed 0.1 -> 2.0; the OV
recipe anneals it 0.1 -> 3.0). Either family: ``batch_loss`` runs the
forward of the config's family. Every other
parameter has ``requires_grad`` off: only the 12.85M-parameter scorer has
a gradient or optimizer state.

The optimizer is ``torch.optim.AdamW`` set up to take the reference's
optax steps:
- the learning rate of update n (n = 0, 1, ...) is optax's
  ``warmup_cosine_decay_schedule(init 0, peak lr, warmup, decay = max(total,
  warmup + 1), end 0)`` at n, in its fp32 arithmetic: the first update
  has lr 0 and moves nothing;
- gradients are clipped as ``optax.clip_by_global_norm``: scaled by
  max / norm only when norm >= max (not ``clip_grad_norm_``'s
  max / (norm + 1e-6));
- weight decay is the schedule's (default 0.0, where torch's default is
  0.01), betas (0.9, 0.999), eps 1e-8 outside the square root, bias
  correction counted from 1, as optax's ``adamw``.
``reg_weight`` follows ``TrainState.step``, the count of updates taken.

``accumulate`` and ``_update`` serve every method of ``api.train`` (the
selector here, ``dynamic_train`` and ``sft``): a state's ``trainable()``
names the parameters that train, and only they have gradients, optimizer
state and a place in the clipping norm (optax's ``masked``).

Data parallelism (the reference's ``(n_data, 1)`` mesh, where GSPMD
computes the loss of the global batch): a state whose ``mesh`` is set
holds this rank's part of each batch. Each rank's loss is a mean over its
equal part, or scaled so that the mean over the ranks is the global
batch's loss (GRPO's token-count reductions, ``grpo.grpo_loss``); after
the micro-batch loop ``accumulate`` averages the trainables' gradients
and the metrics over the mesh's "data" ranks (``data_mean``: one flat
all-reduce per gradient dtype, outside the autograd graph), so the norm
is the global one and every rank takes the same AdamW step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Tuple

import numpy as np
import torch

from visionselector_tpu_torch.core import collectives
from visionselector_tpu_torch.core.config import OVConfig
from visionselector_tpu_torch.train.loss import (
    reg_weight_schedule,
    selector_batch_forward,
)
from visionselector_tpu_torch.train.ov_loss import ov_selector_batch_forward


class ScheduleConfig(NamedTuple):
    total_steps: int = 1000
    lr: float = 5e-5
    reg_weight_start: float = 0.1
    reg_weight_end: float = 2.0
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03
    # reference TrainingArguments default: clip at global norm 1.0
    max_grad_norm: float = 1.0
    # gradient checkpointing of the decoder layers: exact, trades one extra
    # forward for activation memory
    remat: bool = False


@dataclasses.dataclass
class TrainState:
    scorer: torch.nn.Module  # the trained parameters (fp32)
    optimizer: torch.optim.AdamW
    step: int = 0  # updates taken
    mesh: object = None  # data parallelism: a core.mesh.Mesh, else None

    def trainable(self) -> dict:
        """{name: parameter} of what trains (and what a checkpoint holds)."""
        return dict(self.scorer.named_parameters())


def lr_schedule(sched: ScheduleConfig) -> Callable[[int], float]:
    """Learning rate of update n: optax's warmup-cosine schedule in fp32."""
    warmup = max(1, int(sched.total_steps * sched.warmup_ratio))
    decay = max(sched.total_steps, warmup + 1) - warmup
    peak, f32 = np.float32(sched.lr), np.float32

    def lr_at(n: int) -> float:
        if n < warmup:  # linear from 0 to peak
            frac = f32(1) - f32(min(max(n, 0), warmup)) / f32(warmup)
            return float((f32(0) - peak) * frac + peak)
        c = f32(min(n - warmup, decay))
        cos = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(decay)))
        return float(peak * cos)

    return lr_at


def make_optimizer(params, sched) -> torch.optim.AdamW:
    """AdamW over the parameters ``params`` with optax's settings; the lr
    is set per update by ``_update``."""
    return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=sched.weight_decay)


def init_train_state(params, sched: ScheduleConfig) -> TrainState:
    """Freeze every parameter but the scorer's and make its optimizer."""
    for p in params.parameters():
        p.requires_grad_(False)
    for p in params.scorer.parameters():
        p.requires_grad_(True)
    return TrainState(params.scorer,
                      make_optimizer(params.scorer.parameters(), sched))


def batch_loss(params, batch, cfg, reg_weight, k_max: int,
               remat: bool = False, attn_impl=None):
    """Mean of the batch's per-sample losses, and the metrics' means: the
    Qwen2.5-VL forward for a ``VLConfig`` (a ``TrainBatchSample``), the
    LLaVA-OneVision-1.5 one for an ``OVConfig`` (an ``OVTrainSample``)."""
    forward = (ov_selector_batch_forward if isinstance(cfg, OVConfig)
               else selector_batch_forward)
    losses, metrics = forward(params, batch, cfg, reg_weight, k_max, remat,
                              attn_impl)
    return losses.mean(), {k: v.mean() for k, v in metrics.items()}


def data_parallel(mesh) -> bool:
    """Whether ``mesh`` (a state's) splits batches over more than one
    rank."""
    return mesh is not None and mesh.size("data") > 1


def data_mean(mesh, grads: List[torch.Tensor], metrics: dict) -> dict:
    """Average ``grads`` (in place) and the scalar ``metrics`` over the
    mesh's "data" ranks: one flat all-reduce per gradient dtype, the
    metrics riding with the fp32 one. Returns the averaged metrics."""
    n, group = mesh.size("data"), mesh.groups["data"]
    names = list(metrics)
    vals = torch.stack([torch.as_tensor(metrics[k]).float().to(mesh.device)
                        for k in names])
    buckets = {torch.float32: []}
    for g in grads:
        buckets.setdefault(g.dtype, []).append(g)
    for dtype, part in buckets.items():
        fp32 = dtype == torch.float32
        flat = [g.reshape(-1) for g in part] + ([vals] if fp32 else [])
        total = collectives.all_reduce(torch.cat(flat), group).div_(n)
        at = 0
        for g in part:
            g.copy_(total[at:at + g.numel()].view_as(g))
            at += g.numel()
        if fp32:
            vals = total[at:]
    return {k: vals[i] for i, k in enumerate(names)}


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))


def _update(state, sched) -> dict:
    """Clip the trainable parameters' gradients (optax's rule) and take
    one AdamW step at the schedule's lr; returns {"grad_norm", "lr"}."""
    params = list(state.trainable().values())
    norm = global_norm([p.grad for p in params])
    if sched.max_grad_norm > 0:
        keep = norm < sched.max_grad_norm
        for p in params:
            p.grad.copy_(torch.where(
                keep, p.grad, p.grad / norm * sched.max_grad_norm))
    lr = lr_schedule(sched)(state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    state.step += 1
    return {"grad_norm": norm, "lr": lr}


def train_step(state: TrainState, params, batch, cfg, k_max: int,
               sched: ScheduleConfig,
               attn_impl=None) -> Tuple[TrainState, dict]:
    """One update on ``batch`` (``loss.to_device``). Returns (state, metrics:
    loss, ce, bce, soft_mass, reg_weight, grad_norm (before clipping),
    lr); tensors stay on the device."""
    return train_step_accum(state, params, [batch], cfg, k_max, sched,
                            attn_impl)


def train_step_accum(state: TrainState, params, batches: List, cfg,
                     k_max: int, sched: ScheduleConfig,
                     attn_impl=None) -> Tuple[TrainState, dict]:
    """One update from equal-sized micro-batches: the gradients of their
    mean losses summed in fp32 and divided by their count (equal to
    ``train_step`` on the concatenated batch), with one micro-batch's
    activations live at a time."""
    reg_weight = reg_weight_schedule(state.step, sched.total_steps,
                                     sched.reg_weight_start,
                                     sched.reg_weight_end)
    state, metrics = accumulate(
        state, sched, batches, lambda mb: batch_loss(
            params, mb, cfg, reg_weight, k_max, sched.remat, attn_impl))
    metrics["reg_weight"] = reg_weight
    return state, metrics


def accumulate(state, sched, batches: List,
               loss_fn: Callable) -> Tuple[object, dict]:
    """One update of ``state`` (any method's: see ``_update``) from
    equal-sized micro-batches: ``loss_fn(mb) -> (mean loss, {metric:
    scalar})``; the gradients of the micro-batches' losses summed in
    ``.grad`` and divided by their count (the gradient of the mean over
    the concatenated batch), one micro-batch's activations live at a time.
    Under data parallelism (``state.mesh``) the gradients and metrics are
    then averaged over the ranks (``data_mean``). Returns (state, metrics
    averaged over micro-batches, with "loss", "grad_norm" and "lr")."""
    state.optimizer.zero_grad(set_to_none=True)
    losses, metric_list = [], []
    for mb in batches:
        loss, metrics = loss_fn(mb)
        loss.backward()  # .grad accumulates the sum
        losses.append(loss.detach())
        metric_list.append(metrics)
    params = list(state.trainable().values())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        p.grad.div_(len(batches))
    metrics = {k: torch.stack([torch.as_tensor(m[k]).detach()
                               for m in metric_list]).mean()
               for k in metric_list[0]}
    metrics["loss"] = torch.stack(losses).mean()
    if data_parallel(state.mesh):
        metrics = data_mean(state.mesh, [p.grad for p in params], metrics)
    metrics.update(_update(state, sched))
    return state, metrics
