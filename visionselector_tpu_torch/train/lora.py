"""LoRA adapters for the decoder, and their merge.

Counterpart of ``visionselector_tpu.train.lora`` (the reference's peft
LoRA of ``train_sft_visionselector.py:300-310``: rank 64, alpha 16, the
LM's linear kernels as targets, the base frozen; the merge tool
``merge_lora_weights.py``). Each target kernel ``[in, out]`` of every
``DecoderLayer`` gets ``<kernel>_lora_a`` ``[in, rank]`` and
``<kernel>_lora_b`` ``[rank, out]`` as parameters, and the layer a
``lora_scale`` of alpha / rank; ``lm._dense`` adds ``(x @ A) @ B * scale``
wherever the layer runs (prefill, decode, the engines). A starts as
normal / rank in the model's dtype and B at zeros, so the adapters start
as a no-op (peft's convention). The base may be quantized (int8 or int4
buffers, ``lm.quantize_lm_params``): the adapters then take the
embedding's dtype, and the merge dequantizes an int8 base.
"""

from __future__ import annotations

import contextlib
from typing import Sequence, Tuple

import torch
from torch import nn

from visionselector_tpu_torch.models.qwen25vl.lm import kernel_shape

DEFAULT_TARGETS: Tuple[str, ...] = (
    "q_kernel", "k_kernel", "v_kernel", "o_kernel",
    "gate_kernel", "up_kernel", "down_kernel",
)


@torch.no_grad()
def add_lora_params(lm, generator: torch.Generator, rank: int = 64,
                    alpha: int = 16, targets: Sequence[str] = DEFAULT_TARGETS,
                    dtype: torch.dtype | None = None):
    """Add adapters to every decoder layer of ``lm`` for each target
    kernel (in place; frozen like the weights they join, until
    ``sft.init_sft_state`` marks them trainable). A is drawn from
    ``generator`` (target by target, layer by layer), in ``dtype`` (default
    the embedding's). Returns ``lm``."""
    if rank <= 0:
        raise ValueError(f"LoRA rank must be > 0, got {rank}")
    dtype = dtype or lm.embed_tokens.dtype
    for name in targets:
        for layer in lm.layers:
            din, dout = kernel_shape(layer, name)
            dev = layer.input_ln_scale.device
            a = torch.randn(din, rank, generator=generator, device=dev)
            layer.register_parameter(name + "_lora_a", nn.Parameter(
                (a * (1.0 / rank)).to(dtype), requires_grad=False))
            layer.register_parameter(name + "_lora_b", nn.Parameter(
                torch.zeros(rank, dout, device=dev, dtype=dtype),
                requires_grad=False))
    for layer in lm.layers:
        layer.lora_scale = alpha / rank
    return lm


def _adapted(layer) -> list:
    return [n[:-len("_lora_a")] for n in list(layer._parameters)
            if n.endswith("_lora_a")]


@torch.no_grad()
def merge_lora_params(lm):
    """Fold each adapter into its kernel, ``W + (A @ B) * scale`` computed
    in fp32 and rounded to W's dtype (``merge_lora_weights.py``), and drop
    the adapters. An int8 base kernel is dequantized (``q * s``) and the
    merged kernel takes the adapters' dtype, with no requantization (the
    reference's rule). An int4 base raises ValueError before anything
    changes: the reference's merge reads a packed int4 kernel as unscaled
    integers (ROADMAP section 3). In place (the merged model replaces the
    adapter model); returns ``lm``."""
    for layer in lm.layers:
        for name in _adapted(layer):
            if getattr(layer, name).dtype == torch.uint8:
                raise ValueError(f"merge_lora_params: {name} is int4; merging "
                                 f"adapters into an int4 base is not "
                                 f"supported")
    for layer in lm.layers:
        names = _adapted(layer)
        for name in names:
            a = layer._parameters.pop(name + "_lora_a")
            b = layer._parameters.pop(name + "_lora_b")
            w = getattr(layer, name)
            delta = (a.float() @ b.float()) * layer.lora_scale
            if w.dtype == torch.int8:
                s = layer._buffers.pop(name + "_scale")
                merged = w.float() * s[None, :] + delta
                del layer._buffers[name]
                layer.register_parameter(name, nn.Parameter(
                    merged.to(a.dtype), requires_grad=False))
            else:
                w.copy_((w.float() + delta).to(w.dtype))
        if names:
            del layer.lora_scale
    return lm


@contextlib.contextmanager
def adapters_off(lm):
    """Inside the block ``lm`` runs without its adapters (``lm._dense``
    finds none): the base model, the reference policy of LoRA DPO and
    GRPO. The adapter parameters are the same objects afterwards, in
    their places (the optimizer and the checkpoints hold them)."""
    saved = [dict(layer._parameters) for layer in lm.layers]
    try:
        for layer in lm.layers:
            for name in [n for n in layer._parameters if lora_leaf(n)]:
                del layer._parameters[name]
        yield lm
    finally:
        for layer, params in zip(lm.layers, saved):
            layer._parameters.clear()
            layer._parameters.update(params)


def lora_leaf(name: str) -> bool:
    """Whether a parameter name is an adapter's (A or B)."""
    return "_lora_a" in name or "_lora_b" in name
