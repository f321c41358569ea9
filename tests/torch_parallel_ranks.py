"""The ranks of tests/test_torch_parallel.py's gloo world on the CPU. This
module imports no jax: each rank is a spawned process that re-imports it.

``start_world(n, tmp_dir, inputs)`` runs ``run_cases`` on every rank of a
world of n (``torch_world.World``: ``inputs`` pickled under ``tmp_dir``, a
``file://`` rendezvous there) and returns every rank's results (rank
order). Each rank makes a (2, 2) and a (1, 4) mesh and runs every case of
``CASES``; a case that raises reports its traceback instead of its
outputs."""

from __future__ import annotations

import traceback

import numpy as np
import torch

def _qwen(inputs, mesh=None):
    """The tiny Qwen engine from the JAX tree: whole, or its decoder
    sharded over ``mesh``'s "model" axis."""
    from visionselector_tpu_torch.core.config import qwen25vl_tiny
    from visionselector_tpu_torch.core.mesh import tensor_parallel
    from visionselector_tpu_torch.models.qwen25vl.model import QwenVLEngine
    from visionselector_tpu_torch.models.qwen25vl.weights import (
        from_jax_params,
    )

    cfg = qwen25vl_tiny()
    params = from_jax_params(inputs["qwen_tree"], cfg, "cpu")
    if mesh is not None:
        cfg, params = tensor_parallel(cfg, params, mesh)
    return QwenVLEngine(cfg, params, use_selector=True, budget=0.5,
                        device="cpu")


def _moe_lm(inputs):
    from visionselector_tpu_torch.core.config import llava_ov_moe_tiny
    from visionselector_tpu_torch.models.qwen25vl.weights import lm_from_jax

    cfg = llava_ov_moe_tiny().text
    return lm_from_jax(inputs["moe_lm_tree"], cfg, "cpu", torch.float32)


def case_tp_generate(inputs, meshes):
    """Tensor-parallel engine.generate at tp 2 and tp 4 (tp 4 > the 2 kv
    heads: each kv head on two ranks): first-token logits and tokens,
    greedy and sampled."""
    out = {}
    for tp, mesh in (("tp2", meshes["2x2"]), ("tp4", meshes["1x4"])):
        eng = _qwen(inputs, mesh)
        res = eng.generate(*inputs["request"], max_new_tokens=4)
        sampled = eng.generate(*inputs["request"], max_new_tokens=4,
                               temperature=1.5, top_p=0.95, seed=3)
        out[tp] = dict(tokens=res.tokens, logits=res.logits.numpy(),
                       heads=(eng.cfg.text.num_attention_heads,
                              eng.cfg.text.num_key_value_heads),
                       selected=res.selected_indices,
                       sampled=sampled.tokens)
    return out


def case_tp_moe_prefill(inputs, meshes):
    """``lm_prefill`` of the MoE decoder sharded over 2 ranks (inside each
    expert)."""
    from visionselector_tpu_torch.models.qwen25vl import lm as lm_mod

    lm = lm_mod.shard_lm(_moe_lm(inputs), meshes["2x2"])
    embeds, pos, seg = (torch.from_numpy(a) for a in inputs["moe_x"])
    with torch.no_grad():
        h, _ = lm_mod.lm_prefill(lm, embeds, pos, seg)
    return dict(hidden=h.numpy(), mi=lm.layers[0].expert_gate_kernel.shape)


def case_moe_ep(inputs, meshes):
    """``moe_mlp_ep`` of layer 0 over 2 ranks (2 experts each)."""
    from visionselector_tpu_torch.core.config import llava_ov_moe_tiny
    from visionselector_tpu_torch.models.qwen25vl import lm as lm_mod

    lm = _moe_lm(inputs)
    x = torch.from_numpy(inputs["ep_x"])
    with torch.no_grad():
        y = lm_mod.moe_mlp_ep(x, lm.layers[0], llava_ov_moe_tiny().text,
                              meshes["2x2"])
    return y.numpy()


def case_vit_sp(inputs, meshes):
    """``vit_forward_sp`` over 4 shards on each grid's aligned batch."""
    from visionselector_tpu_torch.core.config import qwen25vl_tiny
    from visionselector_tpu_torch.models.qwen25vl import vit as vit_mod
    from visionselector_tpu_torch.models.qwen25vl.weights import (
        from_jax_params,
    )

    tower = from_jax_params(inputs["qwen_tree"], qwen25vl_tiny(),
                            "cpu").visual
    out = []
    for vb in inputs["sp_batches"]:
        with torch.no_grad():
            out.append(vit_mod.vit_forward_sp(
                tower, *(torch.from_numpy(a) for a in vb),
                mesh=meshes["1x4"]).numpy())
    return out


CASES = (case_tp_generate, case_tp_moe_prefill, case_moe_ep, case_vit_sp)


def run_cases(rank: int, world: int, inputs) -> dict:
    from visionselector_tpu_torch.core.mesh import make_mesh

    meshes = {"2x2": make_mesh(2, 2, device="cpu"),
              "1x4": make_mesh(1, 4, device="cpu")}
    out = {}
    for case in CASES:
        try:
            out[case.__name__] = case(inputs, meshes)
        except Exception:  # noqa: BLE001 — the test reports it
            out[case.__name__] = {"error": traceback.format_exc()}
    return out


def start_world(n: int, tmp_dir: str, inputs: dict) -> list:
    from torch_world import World

    return World((n,), tmp_dir, run_cases, inputs).results()[n]


def as_numpy(tree):
    """A nested dict of arrays as numpy (JAX arrays included)."""
    if isinstance(tree, dict):
        return {k: as_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)
