"""Shared by the serving tests (tests/test_torch_serving_paths.py,
test_torch_chunked_admission.py, test_torch_serve.py): the tiny config's
weights for both packages and the requests they serve.

The weights are ``jax_param_tree``'s with the decoder's matrices and
embedding scaled by LM_SCALE (norm scales and biases as they are), so that
greedy tokens vary: at std 0.02 the tiny decoder repeats one token."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_params import jax_param_tree

from visionselector_tpu.core.config import qwen25vl_tiny as jax_tiny
from visionselector_tpu.models.qwen25vl import model as jmodel
from visionselector_tpu.selector import baselines as jbase
from visionselector_tpu_torch.core.config import qwen25vl_tiny
from visionselector_tpu_torch.models.qwen25vl import model as tmodel
from visionselector_tpu_torch.models.qwen25vl.weights import from_jax_params
from visionselector_tpu_torch.preprocess.image import preprocess_image
from visionselector_tpu_torch.preprocess.rope import expand_vision_tokens
from visionselector_tpu_torch.selector import baselines as tbase

LM_SCALE = 8.0
EOS = (-1,)  # run every request to its budget unless a test sets an EOS


def serving_tree(cfg, seed: int, scorer_std: float = 1e-4) -> dict:
    def scale(path, x):
        name = jax.tree_util.keystr(path)
        if name.startswith("['lm']") and not name.endswith(
                ("_scale']", "_bias']")):
            return x * LM_SCALE
        return x

    return jax.tree_util.tree_map_with_path(
        scale, jax_param_tree(cfg, seed, scorer_std))


def four_layers(cfg):
    return dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, num_hidden_layers=4))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tiny model's decode steps are thousands of
    small ops, whose parallel regions stall when the Tier-1 run's workers
    oversubscribe the cores (restored after the module). Autouse in every
    module that imports it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def serving_engines() -> dict:
    """Engines of both packages on the same weights (selector at 0.5,
    ``orig``, and FastV on a 4-layer decoder, whose capture layer must lie
    inside the stack), the request image and ``ids_for(question)``."""
    tree = serving_tree(jax_tiny(), seed=0)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = from_jax_params(tree, qwen25vl_tiny(), "cpu")
    img = (np.random.RandomState(0).rand(56, 84, 3) * 255).astype(np.uint8)
    px, grid = preprocess_image(img)

    def ids_for(question, before=(5, 6, 7)):
        return expand_vision_tokens(list(before), list(question), grid)

    def engines(**kw):
        return (jmodel.QwenVLEngine(jax_tiny(), jparams, **kw),
                tmodel.QwenVLEngine(qwen25vl_tiny(), tparams, device="cpu",
                                    **kw))

    jsel, tsel = engines(use_selector=True, budget=0.5)
    jorig, torig = engines(use_selector=False)
    tree4 = serving_tree(four_layers(jax_tiny()), seed=3)
    tfastv = tmodel.QwenVLEngine(
        four_layers(qwen25vl_tiny()),
        from_jax_params(tree4, four_layers(qwen25vl_tiny()), "cpu"),
        strategy=tbase.get_baseline("fastv", target_layer=2), budget=0.5,
        device="cpu")
    jfastv = jmodel.QwenVLEngine(
        four_layers(jax_tiny()), jax.tree.map(jnp.asarray, tree4),
        use_selector=False, budget=0.5,
        strategy=jbase.get_baseline("fastv", target_layer=2))
    return dict(jsel=jsel, tsel=tsel, jorig=jorig, torig=torig,
                tfastv=tfastv, jfastv=jfastv, px=px, grid=grid,
                ids_for=ids_for)


def request(w, kind):
    """(request kwargs, "sel" or "orig": the engine pair) of a test
    request: the image with a 3-id question, or 12 text ids."""
    if kind == "text":
        return dict(input_ids=np.arange(40, 52, dtype=np.int64)), "sel"
    req = dict(input_ids=w["ids_for"]([8, 9, 10]), pixel_values=w["px"],
               grid_thw=w["grid"])
    return req, ("orig" if kind == "orig" else "sel")


def batch_requests(w):
    """Two image requests and a text-only one."""
    return [request(w, "selector")[0],
            dict(input_ids=w["ids_for"]([8, 70, 71, 72]),
                 pixel_values=w["px"], grid_thw=w["grid"]),
            request(w, "text")[0]]


def stream(engine, req, **kw):
    """(the streamed chunks as lists of ints, the result's tokens)."""
    chunks = []
    res = engine.generate(**req, on_token_chunk=chunks.append, **kw)
    return [list(map(int, c)) for c in chunks], res.tokens


def run_chunked(job):
    """Step a ChunkedPrefill to its end: (its PrefillState, steps)."""
    steps = 1
    while not job.step():
        steps += 1
    return job.finish(), steps
