"""The port's pipeline parallelism (``core/pipeline.py``: ``stage_layers``,
``gpipe``, ``lm_prefill_layers_pp``) against the JAX package's
``core/pipeline.py`` on the CPU.

The port's side runs in ONE world of 4 spawned gloo ranks
(``torch_pipeline_ranks``, which imports no jax; a ``file://``
rendezvous under tmp_path), with a 2-stage mesh (ranks 2 and 3 idle) and
a 4-stage one; it runs every case once and each test below asserts its
own entry. The JAX side runs here, on the 8 virtual CPU devices conftest
gives it, while the world runs. Same numpy inputs from a seed (the tiny
decoder's layers tiled to 4, as tests/test_pipeline.py tiles them);
fp32.

Tolerances (tests/test_pipeline.py's): outputs rtol 2e-4 / atol 2e-4
against JAX's ``lm_prefill_layers_pp`` on the same stage count;
gradients of mean(h^2) with respect to every local layer leaf and to the
input rtol 5e-3 / atol 1e-5 against ``jax.grad`` through it. Every rank's
output is the same bits. The toy ``gpipe`` cases hold the schedule to
the same composition run whole within 1e-6 (fp32, 4 stages of 8 x 8,
M = 3);
the planted faults (the last stage's microbatches swapped; the output's
gradient summed over the stages, S times the cotangent) must fail.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from torch_pipeline_ranks import pipeline_rank
from torch_port_params import jax_param_tree
from torch_world import World

from visionselector_tpu.core.config import qwen25vl_tiny as jax_tiny
from visionselector_tpu.core.pipeline import lm_prefill_layers_pp as jax_pp
from visionselector_tpu_torch.core import mesh as tmesh
from visionselector_tpu_torch.core import pipeline as tpipe
from visionselector_tpu_torch.core.config import qwen25vl_tiny
from visionselector_tpu_torch.models.qwen25vl.weights import lm_from_jax

DEPTH, VOCAB = 4, 64
FORWARD = [("s2_m2", 2, 2), ("s4_m4", 4, 4), ("s2_m4", 2, 4)]


def _lm_tree():
    """The tiny decoder's tree with its layers tiled to DEPTH; the
    embedding, which the pipeline never reads, cut to VOCAB rows."""
    tree = jax_param_tree(jax_tiny(), seed=0)["lm"]
    tree["embed_tokens"] = tree["embed_tokens"][:VOCAB]
    n = jax.tree.leaves(tree["layers"])[0].shape[0]
    tree["layers"] = {k: np.concatenate([v] * (DEPTH // n))
                      for k, v in tree["layers"].items()}
    return tree


def _inputs(b, t, seed=0, ragged=False):
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, t, jax_tiny().text.hidden_size) * 0.1).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(t), (3, b, t)).astype(np.int64).copy()
    seg = np.ones((b, t), np.int32)
    if ragged:  # tests/test_pipeline.py's padding mix
        seg[1, 8:] = 0
        seg[3, 4:] = 0
    return x, pos, seg


def _cases():
    cases = [dict(name=n, stages=s, m=m, inputs=_inputs(4, 24))
             for n, s, m in FORWARD]
    cases.append(dict(name="ragged", stages=4, m=2,
                      inputs=_inputs(4, 16, ragged=True)))
    grad = _inputs(2, 12)
    cases.append(dict(name="grad", stages=2, m=2, inputs=grad, grad=True))
    cases.append(dict(name="grad_fault", stages=2, m=2, inputs=grad,
                      grad=True, fault="sum_cotangent"))
    return cases


@functools.partial(jax.jit, static_argnums=(4, 5))
def _jax(layers, x, pos, seg, stages, m):
    """JAX's pipeline over ``stages`` of the virtual CPU devices (jitted:
    an eager shard_map dispatches each op over the mesh, 15-26 s a call
    here)."""
    mesh = JMesh(np.array(jax.devices()[:stages]), ("stage",))
    return jax_pp(layers, x, pos.astype(jnp.int32), seg, jax_tiny().text,
                  mesh, n_microbatches=m)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tree = _lm_tree()
    cases = _cases()
    run = World((4,), str(tmp_path_factory.mktemp("pipe")), pipeline_rank,
                dict(lm_tree=tree, cases=cases))
    layers = jax.tree.map(jnp.asarray, tree["layers"])
    want = {c["name"]: np.asarray(_jax(layers, *c["inputs"], c["stages"],
                                       c["m"]))
            for c in cases if not c.get("grad")}
    grad = next(c for c in cases if c["name"] == "grad")
    _, pos, seg = grad["inputs"]

    def loss(layers, x):
        h = _jax(layers, x, pos, seg, 2, 2)
        return (h.astype(jnp.float32) ** 2).mean()

    g_layers, g_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        layers, jnp.asarray(grad["inputs"][0]))
    want["grad"] = (jax.tree.map(np.asarray, g_layers), np.asarray(g_x))
    ranks = run.results()[4]
    for r, res in enumerate(ranks):
        assert "error" not in res, f"rank {r}:\n{res['error']}"
    return dict(ranks=ranks, want=want, cases=cases)


def _ranks_of(world, name):
    return [res[name] for res in world["ranks"] if name in res]


@pytest.mark.parametrize("name", [n for n, _, _ in FORWARD] + ["ragged"])
def test_matches_jax_pipeline(world, name):
    """(S, M) = (2, 2), (4, 4), (2, 4) on B = 4, T = 24, and the ragged
    padding mix on 4 stages (M = 2): every stage rank's output is the same
    bits, within rtol 2e-4 / atol 2e-4 of JAX's."""
    outs = _ranks_of(world, name)
    stages = next(c["stages"] for c in world["cases"] if c["name"] == name)
    assert len(outs) == stages
    for o in outs[1:]:
        np.testing.assert_array_equal(o["out"], outs[0]["out"])
    np.testing.assert_allclose(outs[0]["out"], world["want"][name],
                               rtol=2e-4, atol=2e-4)


def _check_grads(res, want_layers, want_x):
    np.testing.assert_allclose(res["x_grad"], want_x, rtol=5e-3, atol=1e-5)
    assert res["layer_grads"]
    for (layer, leaf), g in res["layer_grads"].items():
        np.testing.assert_allclose(g, want_layers[leaf][layer], rtol=5e-3,
                                   atol=1e-5, err_msg=f"{layer} {leaf}")


def test_grads_match_jax_grad(world):
    """2 stages, M = 2, B = 2, T = 12: each stage's layer gradients and
    every rank's input gradient within rtol 5e-3 / atol 1e-5 of
    ``jax.grad`` through JAX's pipeline (no factor of S); the stages own
    layers 0-1 and 2-3."""
    want_layers, want_x = world["want"]["grad"]
    outs = _ranks_of(world, "grad")
    assert [o["first"] for o in outs] == [0, 2]
    for res in outs:
        _check_grads(res, want_layers, want_x)


def test_planted_broadcast_fault_fails_the_gradient_check(world):
    """The output's gradient summed over the 2 stages (the backward of a
    broadcast written as an all-reduce) doubles every gradient: the check
    above must fail on every rank, while the forward is unchanged."""
    want_layers, want_x = world["want"]["grad"]
    good = _ranks_of(world, "grad")
    for res, ok in zip(_ranks_of(world, "grad_fault"), good):
        np.testing.assert_array_equal(res["out"], ok["out"])
        with pytest.raises(AssertionError):
            _check_grads(res, want_layers, want_x)
        np.testing.assert_allclose(res["x_grad"], 2 * ok["x_grad"],
                                   rtol=1e-5, atol=1e-7)


def test_gpipe_toy_stage_function(world):
    """``gpipe`` of a toy stage (Linear, tanh, a per-microbatch scale) over
    4 stages with M = 3: outputs, input gradients and each stage's
    parameter gradients within 1e-6 of the composition run whole; the
    planted faults fail (swapped microbatches: the outputs; the summed
    cotangent: the gradients). With the input and stages 0-2 frozen, only
    the last stage's layer trains: every rank still runs the reverse
    schedule (no hang), the last stage's gradients match and the frozen
    stages get none."""
    for s, res in enumerate(world["ranks"]):
        toy = res["toy"]
        assert max(toy["out"], toy["x_grad"], toy["param_grad"]) < 1e-6
        assert res["toy_swap"]["out"] > 1e-2
        assert res["toy_sum"]["out"] < 1e-6
        assert min(res["toy_sum"]["x_grad"],
                   res["toy_sum"]["param_grad"]) > 1e-2
        last = res["toy_last"]
        assert last["out"] < 1e-6 and last["x_grad"] is None
        assert last["trained"] == (s == 3)
        if s == 3:
            assert last["param_grad"] < 1e-6
    for res in world["ranks"][1:]:
        np.testing.assert_array_equal(res["toy"]["y"],
                                      world["ranks"][0]["toy"]["y"])


def test_stage_layers_keeps_a_contiguous_part():
    """``stage_layers`` keeps stage s's layers [s L / S, (s + 1) L / S) in
    place (their weights untouched, about 1 / S of the decoder's layer
    bytes) and records (first, L); a split that does not divide raises
    ValueError, as does ``lm_prefill_layers_pp`` on an unstaged decoder."""
    tree = _lm_tree()
    cfg = dataclasses.replace(qwen25vl_tiny().text, num_hidden_layers=DEPTH,
                              vocab_size=VOCAB)

    def layer_bytes(lm):
        return sum(p.numel() * p.element_size()
                   for p in lm.layers.parameters())

    whole = lm_from_jax(tree, cfg, "cpu", torch.float32)
    full = layer_bytes(whole)
    for s in range(2):
        lm = lm_from_jax(tree, cfg, "cpu", torch.float32)
        mesh = tmesh.Mesh({"stage": 2}, s, torch.device("cpu"), "gloo", {})
        tpipe.stage_layers(lm, mesh)
        assert lm.stage_layers == (2 * s, DEPTH)
        assert layer_bytes(lm) * 2 == full
        for i, layer in enumerate(lm.layers):
            torch.testing.assert_close(layer.q_kernel,
                                       whole.layers[2 * s + i].q_kernel,
                                       rtol=0, atol=0)
    with pytest.raises(ValueError):
        tpipe.stage_layers(whole, tmesh.Mesh({"stage": 3}, 0,
                                             torch.device("cpu"), "gloo", {}))
    x, pos, seg = (torch.from_numpy(a) for a in _inputs(2, 8))
    with pytest.raises(ValueError):
        tpipe.lm_prefill_layers_pp(whole, x, pos, seg, None, 2)
