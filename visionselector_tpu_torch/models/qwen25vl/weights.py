"""Weights for the port: random full-width init on the device, the
reference package's parameter tree (as numpy) mapped onto the port, and
Hugging Face safetensors checkpoints (loading and the trained scorer's
export).

HF names map onto the port's modules as in the reference loader
(``visionselector_tpu.models.qwen25vl.weights``):

- ``nn.Linear`` stores [out, in]; the port's kernels are [in, out], so
  matmul weights are transposed on load,
- the conv3d patch embed [E, C, T, P, P] flattens to a [C*T*P*P, E]
  kernel (host patchify emits rows in (C, T, P, P) order),
- a trained selector's scorer rides along as
  ``<vision prefix>importance_scorer.*`` and stays fp32.

Tensors are read through ``core.safetensors`` (memory-mapped, bf16 kept
as its 16 bits) and copied into modules built on the requested device, one
tensor at a time: no fp32 copy of the checkpoint on the host.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
from torch import nn

from visionselector_tpu_torch.core.config import (
    TextConfig,
    VisionConfig,
    VLConfig,
)
from visionselector_tpu_torch.core.safetensors import open_checkpoint, save_file
from visionselector_tpu_torch.models.qwen25vl.lm import (
    LanguageModel,
    is_quantized,
    pack_int4,
    quant_kernel_names,
)
from visionselector_tpu_torch.models.qwen25vl.model import (  # noqa: F401
    QwenVLParams,
    init_params,  # random full-width weights on the device
)
from visionselector_tpu_torch.models.qwen25vl.vit import (
    VIT_QUANT_KERNELS,
    VisionTower,
    head_width,
    is_vit_quantized,
    register_vit_quantized,
    vit_quantized_kernel,
)
from visionselector_tpu_torch.selector.baselines.dynamic import Predictor
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
    a tower with heads of the same width; a W8A8 visual tree (the
    reference's ``quantize_vit_params``: int8 block kernels with fp32
    ``<name>_scale`` leaves) a W8A8 tower with the same integers and
    scales."""
    dtype = dtype or cfg.torch_dtype
    blocks = tree["visual"]["blocks"]
    qkv_width = np.shape(blocks["qkv_kernel"])[-1]
    visual = VisionTower(cfg.vision, device, dtype,
                         dp=qkv_width // (3 * cfg.vision.num_heads))
    _load(visual, tree["visual"], device, dtype)
    w8a8 = "qkv_kernel_scale" in blocks
    for i, blk in enumerate(visual.blocks):
        if w8a8:
            for name in VIT_QUANT_KERNELS:
                register_vit_quantized(
                    blk, name,
                    _tensor(np.asarray(blocks[name])[i], device, torch.int8),
                    _tensor(np.asarray(blocks[name + "_scale"])[i], device,
                            torch.float32))
        _load(blk, blocks, device, dtype, layer=i)
    return QwenVLParams(visual, lm_from_jax(tree["lm"], cfg.text, device,
                                            dtype),
                        scorer_from_jax(tree, cfg, device))


def lm_from_jax(tree: dict, cfg: TextConfig, device,
                dtype: torch.dtype) -> LanguageModel:
    """The reference's decoder tree (``init_lm_params`` layout) as the
    port's ``LanguageModel``: the Qwen2.5 tree, or the Qwen3 one (no
    biases, ``q_norm_scale`` / ``k_norm_scale``, an untied
    ``lm_head_kernel``; with ``num_experts > 0`` the router and the
    stacked expert kernels), whichever ``cfg`` describes. A quantized tree
    (``apply_weight_quantization``'s: int8 or int4 kernels with fp32
    ``<name>_scale`` leaves) gives a quantized LM with the same integers
    and scales (``_load_quantized``)."""
    layers = tree["layers"]
    quant = _tree_quant(layers)
    lm = LanguageModel(cfg, device, dtype, quant=quant)
    _load(lm, tree, device, dtype)
    for i, layer in enumerate(lm.layers):
        _load(layer, layers, device, dtype, layer=i)
        if quant:
            _load_quantized(layer, layers, i, quant[0])
    return lm


def _tree_quant(layers: dict):
    """(bits, group size) of a reference layer tree's quantized kernels,
    or None when they are not quantized. int4 leaves are ``ml_dtypes``
    int4 arrays."""
    if "q_kernel_scale" not in layers:
        return None
    w = np.asarray(layers["q_kernel"])
    bits = 8 if w.dtype == np.int8 else 4
    if bits == 4 and w.dtype.name != "int4":
        raise ValueError(f"quantized q_kernel of dtype {w.dtype}: expected "
                         f"int8 or int4")
    s = np.shape(layers["q_kernel_scale"])
    return bits, (w.shape[1] // s[1] if len(s) == 3 else 0)


@torch.no_grad()
def _load_quantized(layer: nn.Module, layers: dict, i: int,
                    bits: int) -> None:
    """Copy layer ``i``'s quantized kernels (int4 read as int8 values,
    then packed two a byte along the output axis) and fp32 scales into
    the buffers of ``layer``."""
    for name in quant_kernel_names(layer):
        q = torch.from_numpy(
            np.asarray(layers[name])[i].astype(np.int8).copy())
        if bits == 4:
            q = pack_int4(q)
        s = torch.from_numpy(
            np.asarray(layers[name + "_scale"])[i].astype(np.float32).copy())
        for dst, src in ((getattr(layer, name), q),
                         (getattr(layer, name + "_scale"), s)):
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: quantized shape "
                                 f"{tuple(src.shape)} != {tuple(dst.shape)}")
            dst.copy_(src)


def scorer_from_jax(tree: dict, cfg, device):
    """The fp32 scorer of a reference tree, or None when it has none."""
    if "scorer" not in tree:
        return None
    scorer = Scorer(cfg.selector or cfg.with_selector().selector, device)
    _load(scorer, tree["scorer"], device, torch.float32)
    return scorer


def predictor_from_jax(tree: dict, device, num_heads: int = 8) -> Predictor:
    """The reference's Dynamic-Qwen predictor tree
    (``baselines.dynamic.init_predictor_params`` layout, leaves as numpy
    arrays) as the port's fp32 ``Predictor``; its widths and depth are read
    from the tree, the head count (not in the tree) is ``num_heads``."""
    blocks = tree["blocks"]
    input_dim, d_model = np.shape(tree["down_kernel"])
    layers, _, hidden = np.shape(blocks["fc1_kernel"])
    pred = Predictor(input_dim, d_model, num_heads, hidden / d_model, layers,
                     device)
    _load(pred, tree, device, torch.float32)
    for i, blk in enumerate(pred.blocks):
        _load(blk, blocks, device, torch.float32, layer=i)
    return pred


@torch.no_grad()
def pad_vit_head_dim(tower: VisionTower, cfg: VisionConfig,
                     dp: int = 128) -> VisionTower:
    """A new tower whose attention heads are zero-padded from the head dim
    d to ``dp`` columns in the weights (the port of the reference's
    ``pad_vit_head_dim``): qkv kernel columns and qkv bias entries of every
    head padded with zeros, proj kernel rows likewise. The pad channels
    carry exact zeros end to end, so the tower computes the same function;
    its full-attention layers then run the packed entry point at head dim
    dp. A W8A8 tower's int8 qkv / proj kernels are padded the same way
    (zero values; the qkv scales of pad columns 1), so the padded W8A8
    tower computes the same function too. ``tower`` is not changed; the
    new one shares no storage with it. Raises ValueError if ``tower`` is
    already padded."""
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
    w8a8 = is_vit_quantized(tower)
    for src, dst in zip(tower.blocks, out.blocks):
        for name, p in src.named_parameters():
            target = getattr(dst, name)
            if name in pads:
                shape, pad = pads[name]
                p = torch.nn.functional.pad(p.view(shape), pad)
            target.copy_(p.reshape(target.shape))
        for name in VIT_QUANT_KERNELS if w8a8 else ():
            q = vit_quantized_kernel(src, name)
            s = getattr(src, name + "_scale")
            if name in pads:
                shape, pad = pads[name]
                q = torch.nn.functional.pad(q.view(shape), pad)
                q = q.reshape(-1 if name == "proj_kernel" else q.shape[0],
                              s.shape[0] if name == "proj_kernel" else -1)
            if name == "qkv_kernel":
                s = torch.nn.functional.pad(s.view(3, h, d), (0, dp - d),
                                            value=1.0).reshape(-1)
            register_vit_quantized(dst, name, q.clone(), s.clone())
    return out


# Hugging Face names: (HF suffix, the port's parameter, transposed). A
# transposed entry is an nn.Linear weight [out, in] against the port's
# [in, out] kernel.
_VIT_BLOCK = (
    ("norm1.weight", "norm1_scale", False),
    ("norm2.weight", "norm2_scale", False),
    ("attn.qkv.weight", "qkv_kernel", True),
    ("attn.qkv.bias", "qkv_bias", False),
    ("attn.proj.weight", "proj_kernel", True),
    ("attn.proj.bias", "proj_bias", False),
    ("mlp.gate_proj.weight", "gate_kernel", True),
    ("mlp.gate_proj.bias", "gate_bias", False),
    ("mlp.up_proj.weight", "up_kernel", True),
    ("mlp.up_proj.bias", "up_bias", False),
    ("mlp.down_proj.weight", "down_kernel", True),
    ("mlp.down_proj.bias", "down_bias", False),
)
_VIT_TOP = (
    ("merger.ln_q.weight", "merger_ln_scale", False),
    ("merger.mlp.0.weight", "merger_fc1_kernel", True),
    ("merger.mlp.0.bias", "merger_fc1_bias", False),
    ("merger.mlp.2.weight", "merger_fc2_kernel", True),
    ("merger.mlp.2.bias", "merger_fc2_bias", False),
)
_LM_LAYER = (
    ("input_layernorm.weight", "input_ln_scale", False),
    ("post_attention_layernorm.weight", "post_ln_scale", False),
    ("self_attn.q_proj.weight", "q_kernel", True),
    ("self_attn.k_proj.weight", "k_kernel", True),
    ("self_attn.v_proj.weight", "v_kernel", True),
    ("self_attn.o_proj.weight", "o_kernel", True),
)
_LM_MLP = (
    ("mlp.gate_proj.weight", "gate_kernel", True),
    ("mlp.up_proj.weight", "up_kernel", True),
    ("mlp.down_proj.weight", "down_kernel", True),
)
_LM_ROUTER = (("mlp.gate.weight", "router_kernel", True),)  # Qwen3-MoE
# Expert j's nn.Linear weights (``mlp.experts.{j}.<suffix>``), stacked
# along the first axis of the port's [E, in, out] kernels.
_LM_EXPERTS = (
    ("gate_proj.weight", "expert_gate_kernel"),
    ("up_proj.weight", "expert_up_kernel"),
    ("down_proj.weight", "expert_down_kernel"),
)
_LM_BIAS = (
    ("self_attn.q_proj.bias", "q_bias", False),
    ("self_attn.k_proj.bias", "k_bias", False),
    ("self_attn.v_proj.bias", "v_bias", False),
)
_LM_QK_NORM = (  # Qwen3
    ("self_attn.q_norm.weight", "q_norm_scale", False),
    ("self_attn.k_norm.weight", "k_norm_scale", False),
)


def lm_layer_table(cfg: TextConfig) -> tuple:
    """A decoder layer's HF names but its experts' (``_LM_EXPERTS``): the
    q/k/v biases under ``attention_bias`` (Qwen2.5), the q/k norms under
    ``qk_norm`` (Qwen3), the dense MLP or, with ``num_experts > 0``, the
    MoE router."""
    return (_LM_LAYER + (_LM_ROUTER if cfg.num_experts else _LM_MLP)
            + (_LM_BIAS if cfg.attention_bias else ())
            + (_LM_QK_NORM if cfg.qk_norm else ()))


def _expert_names(prefix: str, n_experts: int):
    """(HF name, the port's kernel, expert index) of every expert weight
    of the layer under ``prefix``."""
    return [(f"{prefix}mlp.experts.{j}.{suffix}", attr, j)
            for suffix, attr in _LM_EXPERTS for j in range(n_experts)]
_LM_TOP = (
    ("embed_tokens.weight", "embed_tokens", False),
    ("norm.weight", "final_ln_scale", False),
)
_SCORER = (
    ("k_proj.weight", "k_kernel", True),
    ("k_proj.bias", "k_bias", False),
    ("q_proj.weight", "q_kernel", True),
    ("q_proj.bias", "q_bias", False),
)
SCORER_PREFIX = "visual.importance_scorer."


@torch.no_grad()
def _put(param: torch.Tensor, t: torch.Tensor, transpose: bool,
         name: str) -> None:
    """Copy the checkpoint tensor ``t`` (CPU, its file dtype) into
    ``param``: moved to the parameter's device as stored, transposed
    there if asked, and cast by ``copy_`` (round to nearest even, as the
    reference's cast)."""
    t = t.to(param.device)
    if transpose:
        t = t.T
    if tuple(t.shape) != tuple(param.shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} does not fit "
                         f"{tuple(param.shape)}")
    param.copy_(t)


def _load_table(module: nn.Module, get, prefix: str, table) -> None:
    for suffix, attr, transpose in table:
        _put(getattr(module, attr), get(prefix + suffix), transpose,
             prefix + suffix)


def load_vit_params(get, cfg: VisionConfig, device, dtype,
                    prefix: str = "visual.") -> VisionTower:
    """The vision tower from HF names under ``prefix``."""
    tower = VisionTower(cfg, device, dtype)
    name = f"{prefix}patch_embed.proj.weight"
    patch = get(name)  # [E, C, T, P, P]
    _put(tower.patch_embed_kernel, patch.reshape(patch.shape[0], -1), True,
         name)
    for i, blk in enumerate(tower.blocks):
        _load_table(blk, get, f"{prefix}blocks.{i}.", _VIT_BLOCK)
    _load_table(tower, get, prefix, _VIT_TOP)
    return tower


def load_lm_params(get, cfg: TextConfig, device, dtype,
                   prefix: str = "model.") -> LanguageModel:
    """The decoder from HF names under ``prefix`` (an untied lm head is the
    top-level ``lm_head.weight``): Qwen2.5 or Qwen3 layers, as ``cfg``
    says; a Qwen3-MoE layer's ``mlp.gate`` is its router and
    ``mlp.experts.{j}.*_proj`` fill row j of its stacked expert kernels
    (the reference's ``load_qwen3_lm_params``)."""
    lm = LanguageModel(cfg, device, dtype)
    table = lm_layer_table(cfg)
    for i, layer in enumerate(lm.layers):
        _load_table(layer, get, f"{prefix}layers.{i}.", table)
        for name, attr, j in _expert_names(f"{prefix}layers.{i}.",
                                           cfg.num_experts):
            _put(getattr(layer, attr)[j], get(name), True, name)
    _load_table(lm, get, prefix, _LM_TOP)
    if not cfg.tie_word_embeddings:
        _put(lm.lm_head_kernel, get("lm_head.weight"), True,
             "lm_head.weight")
    return lm


def load_scorer_params(get, cfg: VLConfig, device,
                       prefix: str = SCORER_PREFIX):
    """The trained scorer (fp32) under ``prefix``, or None when the
    checkpoint has none."""
    if f"{prefix}k_proj.weight" not in getattr(get, "names", ()):
        return None
    scorer = Scorer(cfg.selector or cfg.with_selector().selector, device)
    _load_table(scorer, get, prefix, _SCORER)
    return scorer


def resolve_qwen_prefixes(names) -> tuple:
    """(vision prefix, decoder prefix): ``visual.`` / ``model.`` in the
    original releases, ``model.visual.`` / ``model.language_model.`` in
    transformers >= 4.52 exports (the class's
    ``_checkpoint_conversion_mapping``)."""
    if any(n.startswith("model.visual.") for n in names):
        return "model.visual.", "model.language_model."
    return "visual.", "model."


def load_hf_checkpoint(path: str, cfg: VLConfig, device,
                       dtype: torch.dtype | None = None) -> QwenVLParams:
    """A Qwen2.5-VL HF checkpoint directory (one file or several shards,
    optionally with a trained ``importance_scorer``) as the port's
    parameters on ``device``, in ``dtype`` (default the config's)."""
    get = open_checkpoint(path)
    vis, lm_prefix = resolve_qwen_prefixes(get.names)
    dtype = dtype or cfg.torch_dtype
    return QwenVLParams(
        load_vit_params(get, cfg.vision, device, dtype, prefix=vis),
        load_lm_params(get, cfg.text, device, dtype, prefix=lm_prefix),
        load_scorer_params(get, cfg, device, prefix=f"{vis}importance_scorer."))


def _table_tensors(module: nn.Module, prefix: str, table) -> dict:
    """HF name -> view of ``module``'s parameter in the HF layout, for the
    names of ``table`` under ``prefix`` (the inverse of ``_load_table``)."""
    out = {}
    for suffix, attr, transpose in table:
        t = getattr(module, attr).detach()
        out[prefix + suffix] = t.T if transpose else t
    return out


def to_hf_tensors(params: QwenVLParams, vis_prefix: str = "visual.",
                  lm_prefix: str = "model.") -> dict:
    """The inverse of ``load_hf_checkpoint``: HF name -> tensor in the HF
    layout (views of the parameters, transposed where the loader
    transposes; the patch embed back to [E, C, T, P, P])."""
    cfg = params.visual.cfg
    out = {f"{vis_prefix}patch_embed.proj.weight":
           params.visual.patch_embed_kernel.detach().T.reshape(
               cfg.hidden_size, cfg.in_channels, cfg.temporal_patch_size,
               cfg.patch_size, cfg.patch_size)}
    for i, blk in enumerate(params.visual.blocks):
        out.update(_table_tensors(blk, f"{vis_prefix}blocks.{i}.",
                                  _VIT_BLOCK))
    out.update(_table_tensors(params.visual, vis_prefix, _VIT_TOP))
    out.update(lm_hf_tensors(params.lm, lm_prefix))
    if params.scorer is not None:
        out.update(_table_tensors(params.scorer,
                                  f"{vis_prefix}importance_scorer.", _SCORER))
    return out


def lm_hf_tensors(lm: LanguageModel, prefix: str = "model.") -> dict:
    """The decoder's HF names -> tensors in the HF layout (the inverse of
    ``load_lm_params``; an untied head as ``lm_head.weight``). Raises
    ValueError for a quantized LM: the HF layout holds float weights."""
    if is_quantized(lm):
        raise ValueError("lm_hf_tensors: the LM is quantized; HF "
                         "checkpoints hold float weights")
    out = {}
    table = lm_layer_table(lm.cfg)
    for i, layer in enumerate(lm.layers):
        out.update(_table_tensors(layer, f"{prefix}layers.{i}.", table))
        for name, attr, j in _expert_names(f"{prefix}layers.{i}.",
                                           lm.cfg.num_experts):
            out[name] = getattr(layer, attr).detach()[j].T
    out.update(_table_tensors(lm, prefix, _LM_TOP))
    if not lm.cfg.tie_word_embeddings:
        out["lm_head.weight"] = lm.lm_head_kernel.detach().T
    return out


def config_from_hf(path: str) -> VLConfig:
    """A VLConfig from an HF ``config.json``: the original flat layout or
    the transformers >= 4.52 nested ``text_config``."""
    with open(os.path.join(path, "config.json")) as f:
        top = json.load(f)
    v = top.get("vision_config", {})
    # text fields live at the top level (original releases) or nested
    raw = dict(top.get("text_config", {}) or {})
    for k, val in top.items():
        raw.setdefault(k, val)
    vision = VisionConfig(
        depth=v.get("depth", 32),
        hidden_size=v.get("hidden_size", 1280),
        intermediate_size=v.get("intermediate_size", 3420),
        num_heads=v.get("num_heads", 16),
        in_channels=v.get("in_channels", 3),
        patch_size=v.get("patch_size", 14),
        spatial_merge_size=v.get("spatial_merge_size", 2),
        temporal_patch_size=v.get("temporal_patch_size", 2),
        tokens_per_second=v.get("tokens_per_second", 2),
        window_size=v.get("window_size", 112),
        out_hidden_size=v.get("out_hidden_size", 2048),
        fullatt_block_indexes=tuple(
            v.get("fullatt_block_indexes", (7, 15, 23, 31))),
    )
    text = TextConfig(
        vocab_size=raw.get("vocab_size", 151936),
        hidden_size=raw.get("hidden_size", 2048),
        intermediate_size=raw.get("intermediate_size", 11008),
        num_hidden_layers=raw.get("num_hidden_layers", 36),
        num_attention_heads=raw.get("num_attention_heads", 16),
        num_key_value_heads=raw.get("num_key_value_heads", 2),
        rms_norm_eps=raw.get("rms_norm_eps", 1e-6),
        rope_theta=raw.get("rope_theta", 1000000.0),
        mrope_section=tuple(
            (raw.get("rope_scaling") or {}).get("mrope_section",
                                                (16, 24, 24))),
        tie_word_embeddings=raw.get("tie_word_embeddings", True),
        max_position_embeddings=raw.get("max_position_embeddings", 128000),
    )
    return VLConfig(
        vision=vision,
        text=text,
        image_token_id=raw.get("image_token_id", 151655),
        video_token_id=raw.get("video_token_id", 151656),
        vision_start_token_id=raw.get("vision_start_token_id", 151652),
        vision_end_token_id=raw.get("vision_end_token_id", 151653),
        eos_token_id=raw.get("eos_token_id", 151645),
    )


def export_scorer_to_safetensors(scorer: Scorer, path: str,
                                 prefix: str = SCORER_PREFIX) -> None:
    """Save a trained scorer in the reference checkpoint layout
    (``<prefix>{k,q}_proj.{weight,bias}``, weights [out, in]; by default
    ``visual.importance_scorer.``) so that it can be merged into an HF
    directory whose vision prefix it carries; fp32 as trained."""
    save_file(_table_tensors(scorer, prefix, _SCORER), path)
