"""Dynamic-Qwen training: the Gumbel straight-through predictor
(``--method dynamic``).

Counterpart of ``visionselector_tpu.train.dynamic_train`` (the
reference's ``train_qwen_dynamic.py:57-92`` and
``dynamic_model.py:427-467, 735-743``): only the VisionPredictor trains.
Per sample, the frozen ViT runs under ``no_grad``, its tokens are
scattered into the text row, decoder layers [0, target) run without grad,
the predictor scores the image rows' hidden states, a straight-through
Gumbel keep mask at temperature ``tau = start * (end / start) ^ (step /
total)`` MULTIPLIES those rows, layers [target, n) run with grad (the
predictor's gradient crosses them), and the loss is CE +
``mask_loss_weight * (keep_ratio - budget) ^ 2`` (weight 100,
``dynamic_model.py:559``).

The multiplication is the reference's documented deviation from Dynamic-
LLaVA, which hides dropped tokens through a 4-D attention mask
(``visionselector_tpu/train/dynamic_train.py:13-18``); the port copies it.
A batch's samples share one [B, T] decoder call for each layer range; the
loss is the mean of the samples' losses, as the reference's ``vmap``
computes it. The Gumbel noise comes from the state's ``torch.Generator``
(saved and restored with the checkpoint); it is not the reference's
``jax.random`` stream, so the tests hand both sides the same uniforms.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from visionselector_tpu_torch.core.mesh import batch_sharding
from visionselector_tpu_torch.core.safetensors import (
    open_checkpoint,
    save_file,
)
from visionselector_tpu_torch.models.qwen25vl import lm as lm_mod
from visionselector_tpu_torch.models.qwen25vl.vit import rms_norm
from visionselector_tpu_torch.selector.baselines.dynamic import (
    Predictor,
    gumbel_keep_mask,
    predictor_forward,
    tau_schedule,
)
from visionselector_tpu_torch.train.loss import (
    _vision,
    batch_of_one,
    scatter_vision,
    supervised_ce,
)
from visionselector_tpu_torch.train.train_step import (
    accumulate,
    make_optimizer,
)

PREDICTOR_PREFIX = "model.image_score_predictor."


class DynamicScheduleConfig(NamedTuple):
    total_steps: int = 1000
    lr: float = 5e-5
    tau_start: float = 1.0
    tau_end: float = 0.1
    budget: float = 0.2
    mask_loss_weight: float = 100.0  # dynamic_model.py:559
    target_layer: int = 2
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03
    max_grad_norm: float = 1.0  # reference TrainingArguments default
    remat: bool = False  # gradient checkpointing of layers [target, n)


@dataclasses.dataclass
class DynamicTrainState:
    predictor: Predictor  # the trained parameters (fp32)
    optimizer: torch.optim.AdamW
    generator: torch.Generator  # the Gumbel draws
    step: int = 0  # updates taken
    mesh: object = None  # data parallelism (train_step.accumulate)

    def trainable(self) -> dict:
        """{name: parameter} of what trains (and what a checkpoint holds)."""
        return dict(self.predictor.named_parameters())


def init_dynamic_train_state(params, predictor: Predictor,
                             sched: DynamicScheduleConfig,
                             seed: int = 0) -> DynamicTrainState:
    """Freeze every model parameter, make the predictor trainable, and
    seed the Gumbel generator on the predictor's device."""
    for p in params.parameters():
        p.requires_grad_(False)
    predictor.requires_grad_(True)
    dev = predictor.down_kernel.device
    return DynamicTrainState(
        predictor, make_optimizer(predictor.parameters(), sched),
        torch.Generator(device=dev).manual_seed(seed))


def dynamic_batch_forward(predictor: Predictor, params, batch, cfg, tau,
                          sched: DynamicScheduleConfig, uniforms=None,
                          generator: torch.Generator | None = None,
                          attn_impl=None):
    """Per-sample losses of a stacked batch (``loss.to_device``): (losses
    [B], {"ce", "mask_loss", "keep_ratio": [B]}). ``uniforms`` [B, L_pad,
    2]: the U(0, 1) draws behind the Gumbel noise, else drawn from
    ``generator``."""
    lm = params.lm
    nb = batch.input_ids.shape[0]
    target, n_layers = sched.target_layer, len(lm.layers)
    position_ids = batch.position_ids.transpose(0, 1)
    with torch.no_grad():
        embeds = torch.stack([
            scatter_vision(lm, batch.input_ids[b], batch.image_positions[b],
                           _vision(params, batch, b, attn_impl))
            for b in range(nb)])
        hidden, _ = lm_mod.lm_prefill_layers(
            lm, range(target), embeds, position_ids, batch.seg_ids,
            attn_impl)
    _, t_pad, d = hidden.shape
    dev = hidden.device
    # the image rows' hidden states; sentinel positions read a zero row
    pos = batch.image_positions.clamp(max=t_pad)
    h_pad = torch.cat([hidden, hidden.new_zeros(nb, 1, d)], 1)
    x_img = h_pad.gather(1, pos[..., None].expand(-1, -1, d))
    l_pad = pos.shape[1]
    num_merged = torch.as_tensor(np.asarray(batch.num_merged), device=dev)
    row_ok = (torch.arange(l_pad, device=dev)[None]
              < num_merged.reshape(nb, 1)).float()
    logits = predictor_forward(predictor, x_img.float(), row_ok[..., None])
    keep = gumbel_keep_mask(logits, tau, uniforms, generator) * row_ok
    # multiply the image rows by the keep decision (see the docstring)
    scale = torch.ones(nb, t_pad + 1, dtype=hidden.dtype, device=dev)
    scale = scale.scatter(1, batch.image_positions, keep.to(hidden.dtype))
    hidden = hidden * scale[:, :t_pad, None]
    x, _ = lm_mod.lm_prefill_layers(
        lm, range(target, n_layers), hidden, position_ids, batch.seg_ids,
        attn_impl, remat=sched.remat)
    x = rms_norm(x, lm.final_ln_scale, lm.cfg.rms_norm_eps)
    ce = torch.stack([supervised_ce(lm, x[b], batch.labels[b])
                      for b in range(nb)])
    keep_ratio = keep.sum(1) / row_ok.sum(1).clamp(min=1)
    mask_loss = (keep_ratio - sched.budget) ** 2
    losses = ce + sched.mask_loss_weight * mask_loss
    return losses, {"ce": ce, "mask_loss": mask_loss,
                    "keep_ratio": keep_ratio}


def dynamic_train_forward(predictor: Predictor, params, sample, cfg, tau,
                          sched: DynamicScheduleConfig, uniform=None,
                          generator: torch.Generator | None = None,
                          attn_impl=None):
    """One sample's composite loss (a batch of one); ``uniform`` [L_pad,
    2]. Returns (loss, {"ce", "mask_loss", "keep_ratio"})."""
    losses, metrics = dynamic_batch_forward(
        predictor, params, batch_of_one(sample), cfg, tau, sched,
        None if uniform is None else uniform[None], generator, attn_impl)
    return losses[0], {k: v[0] for k, v in metrics.items()}


def dynamic_train_step(state: DynamicTrainState, params, batch, cfg,
                       sched: DynamicScheduleConfig,
                       attn_impl=None) -> Tuple[DynamicTrainState, dict]:
    """One predictor update on ``batch``. Returns (state, metrics: loss,
    ce, mask_loss, keep_ratio, tau, grad_norm (before clipping), lr)."""
    return dynamic_train_step_accum(state, params, [batch], cfg, sched,
                                    attn_impl)


def dynamic_train_step_accum(state: DynamicTrainState, params,
                             batches: List, cfg,
                             sched: DynamicScheduleConfig,
                             attn_impl=None) -> Tuple[DynamicTrainState,
                                                      dict]:
    """One predictor update from equal-sized micro-batches (gradients
    summed and divided by their count; every sample draws its own noise).
    The temperature follows the updates taken."""
    tau = tau_schedule(state.step, sched.total_steps, sched.tau_start,
                       sched.tau_end)

    mesh = state.mesh
    n_data = 1 if mesh is None else mesh.size("data")

    def loss_fn(mb):
        # the global batch's U(0, 1) draws behind the Gumbel noise, from
        # the same generator on every rank, and this rank's part of them:
        # the noise of one process over the whole batch
        b, l_pad = mb.image_positions.shape
        uniforms = torch.rand((b * n_data, l_pad, 2),
                              generator=state.generator,
                              device=state.generator.device)
        if mesh is not None:
            uniforms = batch_sharding(mesh)(uniforms)
        losses, metrics = dynamic_batch_forward(
            state.predictor, params, mb, cfg, tau, sched, uniforms,
            generator=state.generator, attn_impl=attn_impl)
        return losses.mean(), {k: v.mean() for k, v in metrics.items()}

    state, metrics = accumulate(state, sched, batches, loss_fn)
    metrics["tau"] = tau
    return state, metrics


def predictor_tensors(predictor: Predictor,
                      prefix: str = PREDICTOR_PREFIX) -> dict:
    """The predictor's tensors under the reference's flat names:
    ``<prefix><leaf>`` and ``<prefix>blocks.<leaf>`` stacked over the
    blocks (the JAX tree's layout)."""
    flat = {prefix + n: p.detach()
            for n, p in predictor.named_parameters(recurse=False)}
    for leaf, _ in predictor.blocks[0].named_parameters():
        flat[f"{prefix}blocks.{leaf}"] = torch.stack(
            [getattr(blk, leaf).detach() for blk in predictor.blocks])
    return flat


def export_predictor_to_safetensors(predictor: Predictor, path: str,
                                    prefix: str = PREDICTOR_PREFIX) -> None:
    """Flat safetensors export of the trained VisionPredictor under the
    reference module path (``dynamic_model.py:302``), written by the
    port's own ``core/safetensors.py``."""
    save_file(predictor_tensors(predictor, prefix), path)


def load_predictor(path: str, device, num_heads: int,
                   prefix: str = PREDICTOR_PREFIX) -> Predictor:
    """An exported predictor (``export_predictor_to_safetensors``, or the
    reference's) as a ``Predictor`` on ``device``; the head count is not
    in the file."""
    from visionselector_tpu_torch.models.qwen25vl.weights import (
        predictor_from_jax,
    )

    get = open_checkpoint(path)
    tree: dict = {"blocks": {}}
    for name in get.names:
        if not name.startswith(prefix):
            continue
        leaf = name[len(prefix):]
        arr = get(name).numpy()
        if leaf.startswith("blocks."):
            tree["blocks"][leaf[len("blocks."):]] = arr
        else:
            tree[leaf] = arr
    return predictor_from_jax(tree, device, num_heads)
