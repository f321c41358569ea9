"""The ranks of tests/test_torch_pipeline.py's world (4 gloo ranks on the
CPU, ``torch_world.World``). This module imports no jax.

``pipeline_rank`` makes a 2-stage and a 4-stage mesh (ranks 2 and 3 idle
on the first), then runs every case of ``inputs["cases"]`` through
``lm_prefill_layers_pp`` on the tiny decoder (the JAX tree's layers,
tiled to 4) staged over its mesh, and ``gpipe`` on a toy stage function
against the same composition run whole on this rank. The planted faults
are patched into the schedule from outside (``planted``)."""

from __future__ import annotations

import contextlib
import dataclasses

import torch

TOY_WIDTH = 8


@contextlib.contextmanager
def planted(fault):
    """Plant ``fault`` into ``pipeline._Pipe`` while the block runs:
    "swap_microbatches" (the output's microbatches in reverse order) or
    "sum_cotangent" (the output's gradient summed over the stages, the
    backward of a broadcast written as an all-reduce); None plants
    nothing."""
    from visionselector_tpu_torch.core import collectives
    from visionselector_tpu_torch.core.pipeline import _Pipe

    forward, backward = _Pipe.forward, _Pipe.backward
    if fault == "swap_microbatches":
        _Pipe.forward = lambda self, x_mb: forward(self, x_mb).flip(0)
    elif fault == "sum_cotangent":
        _Pipe.backward = lambda self, grad_out, *rest: backward(
            self, collectives.all_reduce(grad_out.clone(), self.group),
            *rest)
    try:
        yield
    finally:
        _Pipe.forward, _Pipe.backward = forward, backward


def _lm(inputs, mesh):
    from visionselector_tpu_torch.core.config import qwen25vl_tiny
    from visionselector_tpu_torch.core.pipeline import stage_layers
    from visionselector_tpu_torch.models.qwen25vl.weights import lm_from_jax

    tree = inputs["lm_tree"]
    cfg = dataclasses.replace(qwen25vl_tiny().text, num_hidden_layers=4,
                              vocab_size=tree["embed_tokens"].shape[0])
    lm = lm_from_jax(tree, cfg, "cpu", torch.float32)
    return stage_layers(lm, mesh)


def lm_case(case, inputs, mesh) -> dict:
    """The staged decoder's output on every rank and, with ``grad``, the
    gradients of mean(h^2) with respect to the input and to this rank's
    layers ({(layer, leaf): array})."""
    from visionselector_tpu_torch.core.pipeline import lm_prefill_layers_pp

    lm = _lm(inputs, mesh)
    x, pos, seg = (torch.from_numpy(a) for a in case["inputs"])
    grad = case.get("grad", False)
    x.requires_grad_(grad)
    lm.layers.requires_grad_(grad)
    with planted(case.get("fault")), torch.set_grad_enabled(grad):
        h = lm_prefill_layers_pp(lm, x, pos, seg, mesh, case["m"])
        if grad:
            (h.float() ** 2).mean().backward()
    out = {"out": h.detach().numpy(), "first": lm.stage_layers[0]}
    if grad:
        out["x_grad"] = x.grad.numpy()
        out["layer_grads"] = {
            (lm.stage_layers[0] + i, name): p.grad.numpy()
            for i, layer in enumerate(lm.layers)
            for name, p in layer.named_parameters()}
    return out


def _toy(n_stages):
    gen = torch.Generator().manual_seed(7)
    lins = torch.nn.ModuleList(torch.nn.Linear(TOY_WIDTH, TOY_WIDTH)
                               for _ in range(n_stages))
    with torch.no_grad():
        for p in lins.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
    return lins


def toy_stage(layers, x, ex):
    (scale,) = ex
    return torch.tanh(layers[0](x)) * scale


def toy_case(mesh, m: int, fault=None, last_trains_only=False) -> dict:
    """``gpipe`` of ``toy_stage`` (stage s: Linear s, tanh, a per-
    microbatch scale) on [M, 3, 8] inputs, and the largest |difference|
    from the composition run whole here: the outputs, the input's
    gradient and this stage's parameters' gradients (of sum(y * w)).
    ``last_trains_only``: the input and every stage but the last frozen;
    the input's gradient is then None, as is ``param_grad`` on the frozen
    stages, and "trained" says whether this stage's parameters got one."""
    from visionselector_tpu_torch.core.pipeline import gpipe

    n, s = mesh.size("stage"), mesh.index("stage")
    gen = torch.Generator().manual_seed(8)
    x = torch.randn(m, 3, TOY_WIDTH, generator=gen)
    scale = torch.rand(m, 1, 1, generator=gen) + 0.5
    w = torch.randn(m, 3, TOY_WIDTH, generator=gen)
    ref_lins = _toy(n)
    xr = x.clone().requires_grad_(True)
    ys = []
    for mb in range(m):
        y = xr[mb]
        for st in range(n):
            y = toy_stage(ref_lins[st:st + 1], y, (scale[mb],))
        ys.append(y)
    ref = torch.stack(ys)
    (ref * w).sum().backward()
    local = _toy(n)[s:s + 1]
    local.requires_grad_(not last_trains_only or s == n - 1)
    xp = x.clone().requires_grad_(not last_trains_only)
    with planted(fault):
        y = gpipe(toy_stage, local, xp, (scale,), mesh)
        (y * w).sum().backward()
    pairs = list(zip(local.parameters(), ref_lins[s:s + 1].parameters()))
    trained = [p.grad is not None for p, _ in pairs]
    return {
        "out": (y - ref).abs().max().item(),
        "x_grad": None if xp.grad is None
        else (xp.grad - xr.grad).abs().max().item(),
        "param_grad": max((p.grad - q.grad).abs().max().item()
                          for p, q in pairs) if all(trained) else None,
        "trained": any(trained),
        "y": y.detach().numpy()}


def pipeline_rank(rank, world, inputs) -> dict:
    from visionselector_tpu_torch.core.mesh import stage_mesh

    meshes = {n: stage_mesh(n, device="cpu") for n in (2, 4)}
    out = {}
    for case in inputs["cases"]:
        mesh = meshes[case["stages"]]
        if mesh is not None:
            out[case["name"]] = lm_case(case, inputs, mesh)
    for name, fault in (("toy", None), ("toy_swap", "swap_microbatches"),
                        ("toy_sum", "sum_cotangent")):
        out[name] = toy_case(meshes[4], 3, fault)
    out["toy_last"] = toy_case(meshes[4], 3, last_trains_only=True)
    return out
