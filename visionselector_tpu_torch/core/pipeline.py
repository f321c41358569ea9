"""Pipeline parallelism: stage-sharded decoder layers, GPipe schedule (the
reference's ``visionselector_tpu.core.pipeline``).

- Each rank of the mesh's "stage" axis keeps only its contiguous ``L / S``
  decoder layers (``stage_layers``, in place: the memory win pipeline
  parallelism exists for).
- The batch splits into M microbatches and the GPipe schedule runs
  ``M + S - 1`` ticks: on tick ``step`` stage s runs its layers on
  microbatch ``step - s`` and hands the result to stage s + 1
  (``collectives.ppermute``). Fill and drain bubbles run nothing: their
  results never reach the output. The last stage's outputs go to every
  rank (a sum of the last stage's outputs and zeros, the reference's
  ``psum``).
- The schedule is ONE ``torch.autograd.Function`` (``_GPipe``). Its
  forward keeps each stage's microbatch inputs; its backward runs the
  reverse schedule, recomputing each microbatch's stage with grad and
  sending the input's gradient to stage s - 1. Every rank makes the same
  ``ppermute`` on every tick in both directions, so no send waits on a
  receive that autograd skipped. Under grad mode every rank takes the
  Function, whatever it trains (a stage with nothing trainable runs the
  reverse schedule for the stages before it and returns no parameter
  gradients). The output's gradient is the last
  stage's own cotangent (every rank computes the same loss from the same
  output, so summing theirs would count it S times); the input's
  gradient is stage 0's, summed over the ranks so every rank holds it, as
  the transpose of the reference's replicated input.

Scope: the full-sequence (prefill / training-forward) path, as the
reference's; decode belongs to tensor parallelism.
"""

from __future__ import annotations

import torch
from torch import nn

from visionselector_tpu_torch.core import collectives

def stage_layers(lm, mesh, axis: str = "stage"):
    """Keep only this rank's contiguous ``L / S`` decoder layers of ``lm``
    (``lm.layers``), IN PLACE; the others are dropped. ``lm.stage_layers``
    records (first layer, L). ValueError when S does not divide L."""
    n, i = mesh.size(axis), mesh.index(axis)
    total = len(lm.layers)
    if total % n:
        raise ValueError(f"{total} decoder layers do not split into {n} "
                         f"stages")
    per = total // n
    lm.layers = nn.ModuleList(list(lm.layers)[i * per:(i + 1) * per])
    lm.stage_layers = (i * per, total)
    return lm


class _Pipe:
    """What the schedule needs besides tensors: the stage function and
    layers, the microbatched side inputs and the mesh axis."""

    def __init__(self, stage_fn, layers, extras, mesh, axis):
        self.stage_fn, self.layers, self.extras = stage_fn, layers, extras
        self.group, self.backend = mesh.groups[axis], mesh.backend
        self.n, self.s = mesh.size(axis), mesh.index(axis)
        self.params = [p for p in layers.parameters() if p.requires_grad]
        self.inputs = None

    def run(self, x, mb):
        return self.stage_fn(self.layers, x,
                             tuple(e[mb] for e in self.extras))

    def shift(self, t, step: int):
        """``ppermute`` by ``step`` stages (+1 forward, -1 backward), with
        no wrap-around."""
        perm = [(i, i + step) for i in range(self.n) if 0 <= i + step
                < self.n]
        return collectives.ppermute(t, perm, self.group, self.backend)

    def forward(self, x_mb):
        """The forward schedule (no grad): the last stage's outputs [M, ...]
        on every rank; keeps each microbatch's stage input."""
        n, s, m = self.n, self.s, x_mb.shape[0]
        self.inputs = [None] * m
        out = torch.zeros_like(x_mb)
        state = zeros = torch.zeros_like(x_mb[0])
        for step in range(m + n - 1):
            mb, y = step - s, zeros
            if 0 <= mb < m:
                x = x_mb[mb] if s == 0 else state
                self.inputs[mb] = x
                y = self.run(x, mb)
                if s == n - 1:
                    out[mb] = y
            state = self.shift(y, 1)
        return collectives.all_reduce(out, self.group)

    def backward(self, grad_out, params, want_x: bool):
        """The reverse schedule: (the input's gradient [M, ...] or None,
        each local parameter's gradient)."""
        n, s, m = self.n, self.s, grad_out.shape[0]
        grad_x = torch.zeros_like(grad_out)
        grads = [None] * len(params)
        state = zeros = torch.zeros_like(grad_out[0])
        for step in range(m + n - 1):
            mb, send = step - (n - 1 - s), zeros
            if 0 <= mb < m:
                gy = grad_out[mb] if s == n - 1 else state
                x = self.inputs[mb].detach().requires_grad_(True)
                with torch.enable_grad():
                    y = self.run(x, mb)
                gs = torch.autograd.grad(y, [x] + params, gy,
                                         allow_unused=True)
                for j, g in enumerate(gs[1:]):  # summed over microbatches
                    if g is not None:  # in fp32, rounded once at the end
                        g = g.float()
                        grads[j] = g if grads[j] is None else grads[j] + g
                if s == 0:
                    grad_x[mb] = gs[0]
                else:
                    send = gs[0]
            state = self.shift(send, -1)
        self.inputs = None
        if want_x:  # stage 0's, on every rank
            grad_x = collectives.all_reduce(grad_x, self.group)
        return (grad_x if want_x else None), [
            None if g is None else g.to(p.dtype)
            for g, p in zip(grads, params)]


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pipe, x_mb, anchor, *params):
        ctx.pipe = pipe
        return pipe.forward(x_mb)

    @staticmethod
    def backward(ctx, grad_out):
        pipe = ctx.pipe
        grad_x, grads = pipe.backward(grad_out, pipe.params,
                                      ctx.needs_input_grad[1])
        return (None, grad_x, None, *grads)


def gpipe(stage_fn, local_layers: nn.Module, first_input_mb: torch.Tensor,
          extras_mb, mesh, axis: str = "stage") -> torch.Tensor:
    """Run ``stage_fn`` over each rank's ``local_layers`` with a GPipe
    schedule over the mesh's ``axis``.

    stage_fn(local_layers, x, extras) -> y runs this rank's layer stack on
    one microbatch ``x`` (same shape in and out) with that microbatch's
    side inputs ``extras`` (a tuple). ``first_input_mb``: [M, ...]
    microbatch-major inputs, the same on every rank (stage 0 reads them;
    later stages receive activations). ``extras_mb``: a tuple of [M, ...]
    tensors, the same on every rank. Returns the last stage's [M, ...]
    outputs on every rank, differentiable with respect to the local
    layers' parameters that require grad and to ``first_input_mb``: under
    grad mode, every rank calls backward through it (the same loss from
    the same output), since every rank's backward takes part in the
    reverse schedule's ``ppermute``."""
    pipe = _Pipe(stage_fn, local_layers, tuple(extras_mb), mesh, axis)
    if torch.is_grad_enabled():
        # the choice may not depend on what this rank trains; the anchor
        # gives the output a gradient where neither the input nor the
        # local layers have one
        anchor = torch.zeros((), device=first_input_mb.device,
                             requires_grad=True)
        return _GPipe.apply(pipe, first_input_mb, anchor, *pipe.params)
    with torch.no_grad():
        out = pipe.forward(first_input_mb)
    pipe.inputs = None
    return out


def lm_prefill_layers_pp(lm, inputs_embeds: torch.Tensor,
                         position_ids: torch.Tensor, seg_ids: torch.Tensor,
                         mesh, n_microbatches: int, axis: str = "stage",
                         attn_impl=None) -> torch.Tensor:
    """Pipeline-parallel twin of ``lm.lm_prefill_layers`` over the whole
    stack (hidden states only, no final norm): ``lm`` holds this rank's
    stage (``stage_layers``); the batch splits into ``n_microbatches``
    (B % M == 0); rope cos / sin are computed once for the batch and
    split per microbatch; each stage runs ``lm._prefill_layer`` on its
    layers (causal K1 on the card, through ``FlashAttentionFn`` when the
    inputs carry a gradient). Returns [B, T, D] on every rank."""
    from visionselector_tpu_torch.models.qwen25vl.lm import (
        _prefill_layer,
        mrope_cos_sin,
    )

    if getattr(lm, "stage_layers", None) is None:
        raise ValueError("lm_prefill_layers_pp runs a staged decoder: call "
                         "pipeline.stage_layers(lm, mesh) first")
    cfg = lm.cfg
    b, t = inputs_embeds.shape[:2]
    m = n_microbatches
    if b % m:
        raise ValueError(f"batch {b} does not split into {m} microbatches")
    cos, sin = mrope_cos_sin(position_ids, cfg)

    def mb(x):  # batch-major -> microbatch-major
        return x.reshape(m, b // m, *x.shape[1:])

    def stage_fn(layers, x, ex):
        cos_mb, sin_mb, seg_mb = ex
        for p in layers:
            x = _prefill_layer(x, p, cos_mb, sin_mb, seg_mb, cfg, False,
                               attn_impl)[0]
        return x

    out = gpipe(stage_fn, lm.layers, mb(inputs_embeds),
                (mb(cos), mb(sin), mb(seg_ids)), mesh, axis)
    return out.reshape(b, t, *out.shape[3:])
