"""Model configurations, seeded weights, and the program built from them.

A configuration is a JSON file under ``benchmark/configs/`` holding the
sizes as run (``vision_config`` and ``text_config`` in the port's field
names) and the selector's budget. The weights are made here, on the
device, from the run's seed: Hugging Face-named tensors in the Hugging
Face layout, drawn in a few large calls from one ``torch.Generator``. The
program gets them through its own checkpoint loaders (as it would read a
real checkpoint); the plain reference reads the same named tensors, made
again from the same seed once the program is gone.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
CHUNK = 1 << 28  # elements a generator call draws

# where each family keeps its towers' and decoder's weights
PREFIXES = {
    "qwen25vl": dict(vis="visual.", lm="model.",
                     scorer="visual.importance_scorer."),
    "llava_ov15": dict(vis="model.visual.", lm="model.language_model.",
                       scorer="model.visual.importance_scorer."),
}


def load_config(name: str) -> dict:
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        cfg = json.load(f)
    return resolve(cfg)


def resolve(cfg: dict) -> dict:
    """Fill the derived sizes (head dims) the reference reads."""
    t = cfg["text_config"]
    t.setdefault("head_dim", t["hidden_size"] // t["num_attention_heads"])
    return cfg


def port_config(cfg: dict):
    """The port's config object for ``cfg`` (the selector attached)."""
    from visionselector_tpu_torch.core import config as C

    v = dict(cfg["vision_config"])
    t = {k: (tuple(x) if isinstance(x, list) else x)
         for k, x in cfg["text_config"].items() if k != "head_dim"}
    if cfg["text_config"]["head_dim"] * t["num_attention_heads"] \
            != t["hidden_size"]:
        t["head_dim_override"] = cfg["text_config"]["head_dim"]
    budget = cfg["selector"]["budget"]
    if cfg["family"] == "qwen25vl":
        v["fullatt_block_indexes"] = tuple(v["fullatt_block_indexes"])
        out = C.VLConfig(vision=C.VisionConfig(**v),
                         text=C.TextConfig(**t), dtype=cfg["dtype"])
    else:
        out = C.OVConfig(vision=C.RiceVisionConfig(**v),
                         text=C.TextConfig(**t), dtype=cfg["dtype"])
    return out.with_selector(budget)


def weight_shapes(cfg: dict) -> list:
    """[(HF name, shape, kind)] of every tensor; kind: "w" (matrices and
    embeddings), "b" (biases), "n" (norm scales), "s" (the fp32 scorer),
    "cls" (the RICE CLS row), "clspos" (its fp32 rotary row)."""
    v, t = cfg["vision_config"], cfg["text_config"]
    pre = PREFIXES[cfg["family"]]
    vis, lm = pre["vis"], pre["lm"]
    d, i = v["hidden_size"], v["intermediate_size"]
    mu = v["spatial_merge_size"] ** 2
    out = []
    if cfg["family"] == "qwen25vl":
        out.append((vis + "patch_embed.proj.weight",
                    (d, v["in_channels"], v["temporal_patch_size"],
                     v["patch_size"], v["patch_size"]), "w"))
        for b in range(v["depth"]):
            p = f"{vis}blocks.{b}."
            out += [(p + "norm1.weight", (d,), "n"),
                    (p + "norm2.weight", (d,), "n"),
                    (p + "attn.qkv.weight", (3 * d, d), "w"),
                    (p + "attn.qkv.bias", (3 * d,), "b"),
                    (p + "attn.proj.weight", (d, d), "w"),
                    (p + "attn.proj.bias", (d,), "b")]
            for m in ("gate_proj", "up_proj"):
                out += [(p + f"mlp.{m}.weight", (i, d), "w"),
                        (p + f"mlp.{m}.bias", (i,), "b")]
            out += [(p + "mlp.down_proj.weight", (d, i), "w"),
                    (p + "mlp.down_proj.bias", (d,), "b")]
        out += [(vis + "merger.ln_q.weight", (d,), "n")]
        o = v["out_hidden_size"]
    else:
        out += [(vis + "patch_embed.proj.weight",
                 (d, v["in_channels"], v["patch_size"], v["patch_size"]),
                 "w"),
                (vis + "class_embedding", (d,), "cls"),
                (vis + "class_pos_emb", (1, d // v["num_heads"] // 2),
                 "clspos"),
                (vis + "pre_layernorm.weight", (d,), "n"),
                (vis + "pre_layernorm.bias", (d,), "b")]
        for b in range(v["depth"]):
            p = f"{vis}blocks.{b}."
            for n in ("norm1", "norm2"):
                out += [(p + n + ".weight", (d,), "n"),
                        (p + n + ".bias", (d,), "b")]
            out += [(p + "attn.qkv.weight", (3 * d, d), "w"),
                    (p + "attn.qkv.bias", (3 * d,), "b"),
                    (p + "attn.proj.weight", (d, d), "w"),
                    (p + "attn.proj.bias", (d,), "b"),
                    (p + "mlp.fc1.weight", (i, d), "w"),
                    (p + "mlp.fc1.bias", (i,), "b"),
                    (p + "mlp.fc2.weight", (d, i), "w"),
                    (p + "mlp.fc2.bias", (d,), "b")]
        out += [(vis + "merger.ln_q.weight", (d,), "n"),
                (vis + "merger.ln_q.bias", (d,), "b")]
        o = v["text_hidden_size"]
    out += [(vis + "merger.mlp.0.weight", (mu * d, mu * d), "w"),
            (vis + "merger.mlp.0.bias", (mu * d,), "b"),
            (vis + "merger.mlp.2.weight", (o, mu * d), "w"),
            (vis + "merger.mlp.2.bias", (o,), "b")]
    h, hq, hkv, dh = (t["hidden_size"], t["num_attention_heads"],
                      t["num_key_value_heads"], t["head_dim"])
    out.append((lm + "embed_tokens.weight", (t["vocab_size"], h), "w"))
    for b in range(t["num_hidden_layers"]):
        p = f"{lm}layers.{b}."
        out += [(p + "input_layernorm.weight", (h,), "n"),
                (p + "post_attention_layernorm.weight", (h,), "n"),
                (p + "self_attn.q_proj.weight", (hq * dh, h), "w"),
                (p + "self_attn.k_proj.weight", (hkv * dh, h), "w"),
                (p + "self_attn.v_proj.weight", (hkv * dh, h), "w"),
                (p + "self_attn.o_proj.weight", (h, hq * dh), "w"),
                (p + "mlp.gate_proj.weight", (t["intermediate_size"], h),
                 "w"),
                (p + "mlp.up_proj.weight", (t["intermediate_size"], h), "w"),
                (p + "mlp.down_proj.weight", (h, t["intermediate_size"]),
                 "w")]
        if t["attention_bias"]:
            out += [(p + f"self_attn.{x}_proj.bias", (n * dh,), "b")
                    for x, n in (("q", hq), ("k", hkv), ("v", hkv))]
        if t["qk_norm"]:
            out += [(p + "self_attn.q_norm.weight", (dh,), "n"),
                    (p + "self_attn.k_norm.weight", (dh,), "n")]
    out.append((lm + "norm.weight", (h,), "n"))
    if not t["tie_word_embeddings"]:
        out.append(("lm_head.weight", (t["vocab_size"], h), "w"))
    sd, sh = o, cfg["selector"]["hidden_dim"]
    for x in ("q", "k"):
        out += [(pre["scorer"] + f"{x}_proj.weight", (sh, sd), "s"),
                (pre["scorer"] + f"{x}_proj.bias", (sh,), "s")]
    return out


@torch.no_grad()
def make_weights(cfg: dict, seed: int, device) -> dict:
    """Every tensor of ``cfg`` drawn from ``seed`` on ``device``: standard
    normals from one generator in a few large calls, then scaled by kind
    (matrices and biases by ``init.std``, norm scales 1 + ``init.jitter``
    times a normal, the scorer by ``init.scorer_std`` in fp32, the CLS row
    by hidden ** -0.5, its rotary row by 1)."""
    dtype = getattr(torch, cfg["dtype"])
    init = cfg["init"]
    shapes = weight_shapes(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    sizes = [int(np.prod(s)) for _, s, _ in shapes]
    total = sum(sizes)
    flat = torch.empty(total, dtype=dtype, device=device)
    for a in range(0, total, CHUNK):
        n = min(CHUNK, total - a)
        flat[a:a + n] = torch.randn(n, generator=gen, device=device,
                                    dtype=dtype)
    out, at = {}, 0
    d_vis = cfg["vision_config"]["hidden_size"]
    for (name, shape, kind), n in zip(shapes, sizes):
        t = flat[at:at + n].view(shape)
        at += n
        if kind in ("w", "b"):
            t.mul_(init["std"])
        elif kind == "n":
            t.mul_(init["jitter"]).add_(1.0)
        elif kind == "cls":
            t.mul_(d_vis ** -0.5)
        elif kind == "s":
            t = t.float().mul_(init["scorer_std"])
        elif kind == "clspos":
            t = t.float()
        out[name] = t
    return out


class _Getter:
    """``get(name)`` over a dict of tensors, as the port's loaders read a
    checkpoint (``names`` lists what it holds)."""

    def __init__(self, tensors: dict):
        self.tensors = tensors
        self.names = list(tensors)

    def __call__(self, name):
        return self.tensors[name]


def build_program(cfg: dict, weights: dict, device):
    """(port config, the engine) over ``weights``, through the port's own
    checkpoint loaders."""
    pcfg = port_config(cfg)
    get = _Getter(weights)
    pre = PREFIXES[cfg["family"]]
    dtype = pcfg.torch_dtype
    budget = cfg["selector"]["budget"]
    if cfg["family"] == "qwen25vl":
        from visionselector_tpu_torch.models.qwen25vl import weights as W
        from visionselector_tpu_torch.models.qwen25vl.model import (
            QwenVLEngine,
            QwenVLParams,
        )

        params = QwenVLParams(
            W.load_vit_params(get, pcfg.vision, device, dtype, pre["vis"]),
            W.load_lm_params(get, pcfg.text, device, dtype, pre["lm"]),
            W.load_scorer_params(get, pcfg, device, pre["scorer"]))
        engine = QwenVLEngine(pcfg, params, use_selector=True, budget=budget,
                              device=device)
    else:
        from visionselector_tpu_torch.models.llava_ov15 import weights as OW
        from visionselector_tpu_torch.models.llava_ov15.model import (
            OVEngine,
            OVParams,
        )
        from visionselector_tpu_torch.models.qwen25vl import weights as W

        params = OVParams(
            OW.load_rice_params(get, pcfg.vision, device, dtype, pre["vis"]),
            W.load_lm_params(get, pcfg.text, device, dtype, pre["lm"]),
            W.load_scorer_params(get, pcfg, device, pre["scorer"]), pcfg)
        engine = OVEngine(pcfg, params, use_selector=True, budget=budget,
                          device=device)
    return pcfg, engine
