"""Weights for LLaVA-OneVision-1.5 (RICE ViT + Qwen3 text): the reference
package's parameter tree (as numpy) mapped onto the port, and Hugging Face
safetensors checkpoints, read through the port's own
``core.safetensors``.

Checkpoint layout (the reference loader's): ``model.visual.*`` (RICE),
``model.language_model.*`` (text), ``lm_head.weight``; older exports use
``visual.*`` / ``model.*``, so both prefixes are probed. A trained scorer
rides in ``<vision prefix>importance_scorer.*`` and stays fp32. Matmul
weights are transposed on load (``nn.Linear`` stores [out, in], the port's
kernels are [in, out]); the conv2d patch embed [E, C, P, P] flattens to a
[C*P*P, E] kernel. The Qwen3 text model loads through
``qwen25vl.weights.load_lm_params`` (the reference's
``load_qwen3_lm_params``): its layer table follows ``TextConfig``'s flags
(q/k norms, no biases; with ``num_experts > 0``, the MoE variant, the
router ``mlp.gate`` and the experts ``mlp.experts.{j}.*`` stacked into
[E, ...] kernels).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from visionselector_tpu_torch.core.config import (
    OVConfig,
    RiceVisionConfig,
    TextConfig,
)
from visionselector_tpu_torch.core.safetensors import (
    open_checkpoint,
    save_sharded,
)
from visionselector_tpu_torch.models.llava_ov15.model import OVParams
from visionselector_tpu_torch.models.llava_ov15.rice import RiceTower
from visionselector_tpu_torch.models.qwen25vl.weights import (
    _SCORER,
    _load,
    _load_table,
    _put,
    _table_tensors,
    lm_from_jax,
    lm_hf_tensors,
    load_lm_params,
    load_scorer_params,
    resolve_qwen_prefixes,
    scorer_from_jax,
)

# (HF suffix, the port's parameter, transposed)
_RICE_BLOCK = (
    ("norm1.weight", "norm1_scale", False),
    ("norm1.bias", "norm1_bias", False),
    ("norm2.weight", "norm2_scale", False),
    ("norm2.bias", "norm2_bias", False),
    ("attn.qkv.weight", "qkv_kernel", True),
    ("attn.qkv.bias", "qkv_bias", False),
    ("attn.proj.weight", "proj_kernel", True),
    ("attn.proj.bias", "proj_bias", False),
    ("mlp.fc1.weight", "fc1_kernel", True),
    ("mlp.fc1.bias", "fc1_bias", False),
    ("mlp.fc2.weight", "fc2_kernel", True),
    ("mlp.fc2.bias", "fc2_bias", False),
)
_RICE_TOP = (
    ("class_embedding", "class_embedding", False),
    ("pre_layernorm.weight", "pre_ln_scale", False),
    ("pre_layernorm.bias", "pre_ln_bias", False),
    ("merger.ln_q.weight", "merger_ln_scale", False),
    ("merger.ln_q.bias", "merger_ln_bias", False),
    ("merger.mlp.0.weight", "merger_fc1_kernel", True),
    ("merger.mlp.0.bias", "merger_fc1_bias", False),
    ("merger.mlp.2.weight", "merger_fc2_kernel", True),
    ("merger.mlp.2.bias", "merger_fc2_bias", False),
)


def ov_from_jax_params(tree: dict, cfg: OVConfig, device,
                       dtype: torch.dtype | None = None) -> OVParams:
    """The reference's ``init_ov_params`` tree (leaves as numpy arrays) as
    the port's ``OVParams``: per-layer slices of the stacked arrays, the
    CLS rotary row and the scorer fp32."""
    dtype = dtype or cfg.torch_dtype
    visual = RiceTower(cfg.vision, device, dtype)
    _load(visual, tree["visual"], device, dtype)
    with torch.no_grad():  # fp32 whatever the model's dtype
        visual.class_pos_emb.copy_(torch.from_numpy(np.array(
            tree["visual"]["class_pos_emb"], np.float32)).to(device))
    for i, blk in enumerate(visual.blocks):
        _load(blk, tree["visual"]["blocks"], device, dtype, layer=i)
    return OVParams(visual, lm_from_jax(tree["lm"], cfg.text, device, dtype),
                    scorer_from_jax(tree, cfg, device), cfg)


def load_rice_params(get, cfg: RiceVisionConfig, device, dtype,
                     prefix: str = "model.visual.") -> RiceTower:
    """The RICE tower from HF names under ``prefix``."""
    tower = RiceTower(cfg, device, dtype)
    name = f"{prefix}patch_embed.proj.weight"
    patch = get(name)  # [E, C, P, P]
    _put(tower.patch_embed_kernel, patch.reshape(patch.shape[0], -1), True,
         name)
    name = f"{prefix}class_pos_emb"
    _put(tower.class_pos_emb, get(name).reshape(-1), False, name)
    for i, blk in enumerate(tower.blocks):
        _load_table(blk, get, f"{prefix}blocks.{i}.", _RICE_BLOCK)
    _load_table(tower, get, prefix, _RICE_TOP)
    return tower


def load_ov_checkpoint(path: str, cfg: OVConfig, device,
                       dtype: torch.dtype | None = None) -> OVParams:
    """An LLaVA-OV-1.5 HF checkpoint directory (one file or several
    shards, optionally with a trained scorer) as ``OVParams`` on
    ``device``, in ``dtype`` (default the config's)."""
    get = open_checkpoint(path)
    vis, lm_prefix = resolve_qwen_prefixes(get.names)
    dtype = dtype or cfg.torch_dtype
    return OVParams(
        load_rice_params(get, cfg.vision, device, dtype, prefix=vis),
        load_lm_params(get, cfg.text, device, dtype, prefix=lm_prefix),
        load_scorer_params(get, cfg, device,
                           prefix=f"{vis}importance_scorer."), cfg)


def ov_hf_tensors(params: OVParams, vis_prefix: str = "model.visual.",
                  lm_prefix: str = "model.language_model.") -> dict:
    """The inverse of ``load_ov_checkpoint``: HF name -> tensor in the HF
    layout (the patch embed back to [E, C, P, P])."""
    cfg = params.visual.cfg
    out = {f"{vis_prefix}patch_embed.proj.weight":
           params.visual.patch_embed_kernel.detach().T.reshape(
               cfg.hidden_size, cfg.in_channels, cfg.patch_size,
               cfg.patch_size),
           f"{vis_prefix}class_pos_emb":
           params.visual.class_pos_emb.detach()[None]}
    for i, blk in enumerate(params.visual.blocks):
        out.update(_table_tensors(blk, f"{vis_prefix}blocks.{i}.",
                                  _RICE_BLOCK))
    out.update(_table_tensors(params.visual, vis_prefix, _RICE_TOP))
    out.update(lm_hf_tensors(params.lm, lm_prefix))
    if params.scorer is not None:
        out.update(_table_tensors(params.scorer,
                                  f"{vis_prefix}importance_scorer.", _SCORER))
    return out


def ov_hf_config(cfg: OVConfig) -> dict:
    """An HF ``config.json`` dict for ``cfg`` (what ``ov_config_from_hf``
    reads back; the MoE fields when ``num_experts > 0``)."""
    v, t = cfg.vision, cfg.text
    text = {
        "vocab_size": t.vocab_size, "hidden_size": t.hidden_size,
        "intermediate_size": t.intermediate_size,
        "num_hidden_layers": t.num_hidden_layers,
        "num_attention_heads": t.num_attention_heads,
        "num_key_value_heads": t.num_key_value_heads,
        "head_dim": t.head_dim, "rms_norm_eps": t.rms_norm_eps,
        "rope_theta": t.rope_theta,
        "attention_bias": t.attention_bias}
    if t.num_experts:
        text.update(num_experts=t.num_experts,
                    num_experts_per_tok=t.num_experts_per_tok,
                    moe_intermediate_size=t.moe_intermediate_size,
                    norm_topk_prob=t.norm_topk_prob)
    return {
        "model_type": "llavaonevision1_5",
        "vision_config": {
            "depth": v.depth, "hidden_size": v.hidden_size,
            "intermediate_size": v.intermediate_size,
            "num_heads": v.num_heads, "patch_size": v.patch_size,
            "spatial_merge_size": v.spatial_merge_size,
            "temporal_patch_size": v.temporal_patch_size,
            "layer_norm_eps": v.layer_norm_eps,
            "text_hidden_size": v.text_hidden_size},
        "text_config": text,
        "tie_word_embeddings": t.tie_word_embeddings,
        "image_token_id": cfg.image_token_id,
        "video_token_id": cfg.video_token_id,
    }


def save_ov_checkpoint(params: OVParams, cfg: OVConfig, directory: str,
                       shards: int = 1, vis_prefix: str = "model.visual.",
                       lm_prefix: str = "model.language_model.") -> None:
    """An HF checkpoint directory of ``params``: ``config.json`` and
    ``shards`` safetensors files, in the tensors' own dtypes (what
    ``load_ov_checkpoint`` reads back bit for bit)."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(ov_hf_config(cfg), f, indent=1)
    save_sharded(ov_hf_tensors(params, vis_prefix, lm_prefix), directory,
                 shards)


def ov_config_from_hf(path: str) -> OVConfig:
    """An OVConfig from an HF ``config.json`` (nested ``vision_config`` /
    ``text_config``), with the reference loader's defaults, the MoE
    variant's fields included."""
    with open(os.path.join(path, "config.json")) as f:
        raw = json.load(f)
    v = raw.get("vision_config", {})
    t = raw.get("text_config", raw)
    vision = RiceVisionConfig(
        depth=v.get("depth", 24),
        hidden_size=v.get("hidden_size", 1024),
        intermediate_size=v.get("intermediate_size", 4096),
        num_heads=v.get("num_heads", 16),
        patch_size=v.get("patch_size", 14),
        spatial_merge_size=v.get("spatial_merge_size", 2),
        temporal_patch_size=v.get("temporal_patch_size", 1),
        layer_norm_eps=v.get("layer_norm_eps", 1e-5),
        text_hidden_size=v.get("text_hidden_size",
                               t.get("hidden_size", 4096)),
    )
    text = TextConfig(
        vocab_size=t.get("vocab_size", 151936),
        hidden_size=t.get("hidden_size", 4096),
        intermediate_size=t.get("intermediate_size", 12288),
        num_hidden_layers=t.get("num_hidden_layers", 36),
        num_attention_heads=t.get("num_attention_heads", 32),
        num_key_value_heads=t.get("num_key_value_heads", 8),
        head_dim_override=t.get("head_dim", 128),
        rms_norm_eps=t.get("rms_norm_eps", 1e-6),
        rope_theta=t.get("rope_theta", 1000000.0),
        qk_norm=True,
        attention_bias=t.get("attention_bias", False),
        mrope=False,
        tie_word_embeddings=raw.get("tie_word_embeddings", False),
        num_experts=t.get("num_experts", 0),
        num_experts_per_tok=t.get("num_experts_per_tok", 8),
        moe_intermediate_size=t.get("moe_intermediate_size", 768),
        norm_topk_prob=t.get("norm_topk_prob", True),
    )
    return OVConfig(
        vision=vision, text=text,
        image_token_id=raw.get("image_token_id", 151655),
        video_token_id=raw.get("video_token_id", 151656),
    )
