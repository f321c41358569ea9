"""Weights for the port: random full-width init on the device, and the
reference package's parameter tree (as numpy) mapped onto the port.

Loading Hugging Face checkpoints waits for a checkpoint in the repository
(see ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from visionselector_tpu_torch.core.config import VisionConfig, VLConfig
from visionselector_tpu_torch.models.qwen25vl.lm import LanguageModel
from visionselector_tpu_torch.models.qwen25vl.model import (  # noqa: F401
    QwenVLParams,
    init_params,  # random full-width weights on the device
)
from visionselector_tpu_torch.models.qwen25vl.vit import (
    VisionTower,
    head_width,
)
from visionselector_tpu_torch.selector.scorer import Scorer


def _tensor(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind not in "fiub":  # ml_dtypes bfloat16 and friends
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


@torch.no_grad()
def _load(module: nn.Module, tree: dict, device, dtype, layer=None):
    """Copy ``tree[name]`` (sliced at ``layer`` for stacked arrays) into
    each parameter registered directly on ``module``."""
    for name, p in module.named_parameters(recurse=False):
        a = tree[name] if layer is None else np.asarray(tree[name])[layer]
        if tuple(np.shape(a)) != tuple(p.shape):
            raise ValueError(
                f"{name}: shape {np.shape(a)} != {tuple(p.shape)}")
        p.copy_(_tensor(a, device, dtype))


def from_jax_params(tree: dict, cfg: VLConfig, device,
                    dtype: torch.dtype | None = None) -> QwenVLParams:
    """The reference package's parameter tree (``init_params`` layout,
    leaves as numpy arrays, e.g. ``jax.tree.map(np.asarray, params)``) as
    the port's parameters. Stacked per-layer arrays ``[n_layers, ...]`` are
    split over the port's per-layer modules; the scorer stays fp32. A
    tree whose ViT heads the JAX ``pad_vit_head_dim`` has zero-padded gives
    a tower with heads of the same width."""
    dtype = dtype or cfg.torch_dtype
    qkv_width = np.shape(tree["visual"]["blocks"]["qkv_kernel"])[-1]
    visual = VisionTower(cfg.vision, device, dtype,
                         dp=qkv_width // (3 * cfg.vision.num_heads))
    _load(visual, tree["visual"], device, dtype)
    for i, blk in enumerate(visual.blocks):
        _load(blk, tree["visual"]["blocks"], device, dtype, layer=i)
    lm = LanguageModel(cfg.text, device, dtype)
    _load(lm, tree["lm"], device, dtype)
    for i, layer in enumerate(lm.layers):
        _load(layer, tree["lm"]["layers"], device, dtype, layer=i)
    scorer = None
    if "scorer" in tree:
        scorer = Scorer(cfg.selector or cfg.with_selector().selector, device)
        _load(scorer, tree["scorer"], device, torch.float32)
    return QwenVLParams(visual, lm, scorer)


@torch.no_grad()
def pad_vit_head_dim(tower: VisionTower, cfg: VisionConfig,
                     dp: int = 128) -> VisionTower:
    """A new tower whose attention heads are zero-padded from the head dim
    d to ``dp`` columns in the weights (the port of the reference's
    ``pad_vit_head_dim``): qkv kernel columns and qkv bias entries of every
    head padded with zeros, proj kernel rows likewise. The pad channels
    carry exact zeros end to end, so the tower computes the same function;
    its full-attention layers then run the packed entry point at head dim
    dp. ``tower`` is not changed; the new one shares no storage with it.
    Raises ValueError if ``tower`` is already padded."""
    d, h = cfg.head_dim, cfg.num_heads
    if head_width(tower) != d:
        raise ValueError(f"pad_vit_head_dim: the tower's heads are already "
                         f"{head_width(tower)} wide (head dim {d})")
    ref = tower.patch_embed_kernel
    out = VisionTower(cfg, ref.device, ref.dtype, dp=dp)
    for name, p in tower.named_parameters(recurse=False):
        getattr(out, name).copy_(p)
    # (view with the head dim split out, F.pad spec padding that dim)
    pads = {"qkv_kernel": ((-1, 3, h, d), (0, dp - d)),
            "qkv_bias": ((3, h, d), (0, dp - d)),
            "proj_kernel": ((h, d, -1), (0, 0, 0, dp - d))}
    for src, dst in zip(tower.blocks, out.blocks):
        for name, p in src.named_parameters():
            target = getattr(dst, name)
            if name in pads:
                shape, pad = pads[name]
                p = torch.nn.functional.pad(p.view(shape), pad)
            target.copy_(p.reshape(target.shape))
    return out
