"""The whole slice — image -> ViT -> LIS top-k -> compaction -> prefill ->
greedy decode — through the port and through ``visionselector_tpu``'s
``QwenVLEngine.generate`` on qwen25vl_tiny, with the same weights
(``from_jax_params``). Selected indices must be bit-equal, first-token
logits within atol 1e-4 (fp32 through ViT and decoder) and 8 greedy tokens
equal. The scorer's weights are scaled to std 0.02 so that score gaps at
the top-k boundary exceed fp32 noise; the test asserts the gap it relies
on."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_params import jax_param_tree

from visionselector_tpu.core.config import qwen25vl_tiny as jax_tiny
from visionselector_tpu.models.qwen25vl import model as jmodel
from visionselector_tpu.preprocess.image import preprocess_image
from visionselector_tpu.preprocess.rope import expand_vision_tokens
from visionselector_tpu_torch.core.config import qwen25vl_tiny
from visionselector_tpu_torch.models.qwen25vl import model as tmodel
from visionselector_tpu_torch.models.qwen25vl.weights import (
    from_jax_params,
    init_params,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW_TOKENS = 8
# 112x112: one window row, 16 merged tokens. 224x280: 20 windows and a
# 320-patch full-attention segment.
IMAGES = [(112, 112), (224, 280)]


@pytest.fixture(scope="module")
def weights():
    cfg = jax_tiny()
    tree = jax_param_tree(cfg, seed=0, scorer_std=0.02)
    jparams = jax.tree.map(jnp.asarray, tree)
    return cfg, jparams, from_jax_params(tree, qwen25vl_tiny(), "cpu")


def _request(hw):
    rng = np.random.RandomState(hw[0] + hw[1])
    img = (rng.rand(*hw, 3) * 255).astype(np.uint8)
    px, grid = preprocess_image(img, min_pixels=1, max_pixels=10**9)
    ids = expand_vision_tokens([100, 200, 300], [400, 500, 600], grid)
    return ids, px, grid


def _jax_first_logits(jeng, ids, px, grid):
    p = jeng._prep_vision(ids, px, grid, grid, None, None)
    vb = p.vb
    out = jmodel._prefill(
        jeng.params, jeng.cfg, p.k_max, jeng.use_selector,
        jnp.asarray(vb.pixel_values), jnp.asarray(vb.rot_pos_ids),
        jnp.asarray(vb.window_seg_ids), jnp.asarray(vb.full_seg_ids),
        jnp.asarray(vb.reverse_index), jnp.asarray(p.n), jnp.asarray(p.k),
        jnp.asarray(ids), jnp.asarray(p.image_pos_padded),
        jnp.asarray(p.text_pos_padded), jnp.asarray(p.num_text),
        jnp.asarray(p.position_ids),
        jnp.asarray(vb.window_kv_bounds), jnp.asarray(vb.full_kv_bounds),
        window_diag=vb.window_diag, window_kv_iters=vb.window_kv_iters,
        full_kv_iters=vb.full_kv_iters)
    return np.asarray(out[6]), p.k


@pytest.mark.parametrize("use_selector", [True, False])
@pytest.mark.parametrize("hw", IMAGES)
def test_generate_matches_jax_engine(weights, hw, use_selector):
    jcfg, jparams, tparams = weights
    ids, px, grid = _request(hw)
    jeng = jmodel.QwenVLEngine(jcfg, jparams, use_selector=use_selector)
    want = jeng.generate(ids, px, grid, max_new_tokens=NEW_TOKENS)
    want_logits, k = _jax_first_logits(jeng, ids, px, grid)
    teng = tmodel.QwenVLEngine(qwen25vl_tiny(), tparams,
                               use_selector=use_selector, device="cpu")
    got = teng.generate(ids, px, grid, max_new_tokens=NEW_TOKENS)

    assert got.num_vision_tokens == want.num_vision_tokens
    assert got.prefill_len == want.prefill_len
    if use_selector:
        s = np.sort(want.scores)[::-1]
        gap = s[k - 1] - s[k]
        noise = np.abs(got.scores - want.scores).max()
        assert gap > 1e-7 and gap > 100 * noise, (gap, noise)
        np.testing.assert_array_equal(got.selected_indices,
                                      want.selected_indices)
        assert len(got.selected_indices) == k
    else:
        assert got.selected_indices is None and want.selected_indices is None
    np.testing.assert_allclose(got.logits.numpy(), want_logits, atol=1e-4,
                               rtol=0)
    assert got.tokens == want.tokens
    assert len(got.tokens) == NEW_TOKENS


def test_generate_stops_at_eos(weights):
    """Greedy decode exits early on EOS, which it leaves out (reference
    count): make the engine's own 3rd token the EOS."""
    _, _, tparams = weights
    ids, px, grid = _request(IMAGES[1])
    eng = tmodel.QwenVLEngine(qwen25vl_tiny(), tparams, device="cpu")
    full = eng.generate(ids, px, grid, max_new_tokens=NEW_TOKENS).tokens
    cut = eng.generate(ids, px, grid, max_new_tokens=NEW_TOKENS,
                       eos_token_ids=(full[2],)).tokens
    assert cut == full[:full.index(full[2])]


def test_unported_options_raise(weights):
    from visionselector_tpu_torch.models.qwen25vl.continuous import (
        ContinuousBatcher,
    )

    _, _, tparams = weights
    ids, px, grid = _request(IMAGES[0])
    eng = tmodel.QwenVLEngine(qwen25vl_tiny(), tparams, device="cpu")
    from visionselector_tpu_torch.selector.baselines import get_baseline

    strat = tmodel.QwenVLEngine(qwen25vl_tiny(), tparams, device="cpu",
                                strategy=get_baseline("fastv"))
    with pytest.raises(NotImplementedError):
        strat.loglikelihood(ids, [5], px, grid)
    # the int4 pool and speculative slots are ported: they construct
    for kw in ({"kv_quant": "int4"}, {"speculative": 2}):
        bat = ContinuousBatcher(eng, n_slots=2, t_max=256, **kw)
        assert (bat.kv_quant, bat.speculative) == (
            kw.get("kv_quant"), kw.get("speculative", 0))
        bat.shutdown()


def test_init_params_shapes_and_scales():
    cfg = qwen25vl_tiny()
    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert p.visual.blocks[0].qkv_kernel.shape == (64, 192)
    assert p.lm.layers[1].k_kernel.shape == (96, 48)
    assert torch.equal(p.lm.final_ln_scale, torch.ones(96))
    assert torch.equal(p.visual.blocks[2].proj_bias, torch.zeros(64))
    assert abs(p.lm.embed_tokens.std().item() - 0.02) < 1e-3
    assert p.scorer.q_kernel.dtype == torch.float32
    assert abs(p.scorer.q_kernel.std().item() - 1e-4) < 1e-5
    again = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(p.lm.layers[0].q_kernel, again.lm.layers[0].q_kernel)


def test_serving_builds_no_graph(weights):
    """With every parameter requiring grad (as after training), one-shot
    ``generate`` (image and text-only) and a batcher run still return
    tensors without a ``grad_fn``: inference stays under ``no_grad``."""
    from visionselector_tpu_torch.models.qwen25vl.continuous import (
        ContinuousBatcher,
    )

    _, _, tparams = weights
    params = tmodel.QwenVLParams(tparams.visual, tparams.lm, tparams.scorer)
    flags = [p.requires_grad for p in params.parameters()]
    try:
        for p in params.parameters():
            p.requires_grad_(True)
        eng = tmodel.QwenVLEngine(qwen25vl_tiny(), params, device="cpu")
        ids, px, grid = _request(IMAGES[0])
        res = eng.generate(ids, px, grid, max_new_tokens=3)
        state = eng.generate(ids, px, grid, max_new_tokens=3,
                             _defer_decode=True)
        text = eng.generate(np.arange(5, 12), max_new_tokens=2)
        assert res.logits.grad_fn is None and text.logits.grad_fn is None
        assert state.cache.k.grad_fn is None and state.logits.grad_fn is None
        bat = ContinuousBatcher(eng, n_slots=2, t_max=256, chunk=2)
        try:
            out = bat.submit(dict(input_ids=ids, pixel_values=px,
                                  grid_thw=grid), 3)
            assert out.tokens == res.tokens
            assert bat.pool.k.grad_fn is None
            assert out.logits is None or out.logits.grad_fn is None
        finally:
            bat.shutdown()
    finally:
        for p, f in zip(params.parameters(), flags):
            p.requires_grad_(f)


def test_port_runs_without_jax_or_triton(tmp_path):
    """Importing the port and running its tiny slice (the predict CLI, the
    continuous batcher and the training CLI) on the CPU with jax, triton,
    safetensors, transformers and the JAX package blocked from import
    works, and launches no kernel."""
    code = """
import json, sys
BLOCKED = ("jax", "jaxlib", "triton", "visionselector_tpu", "safetensors",
           "transformers")
for name in BLOCKED:
    sys.modules[name] = None  # any import of them raises ImportError
import numpy as np, torch
import visionselector_tpu_torch
from visionselector_tpu_torch.api import predict
from visionselector_tpu_torch.api import train as train_cli
from visionselector_tpu_torch.core import checkpoint, safetensors
from visionselector_tpu_torch.core.config import qwen25vl_tiny
from visionselector_tpu_torch.kernels import attention as A
from visionselector_tpu_torch.models.qwen25vl.continuous import (
    ContinuousBatcher)
from visionselector_tpu_torch.models.qwen25vl.model import (
    QwenVLEngine, init_params)
from visionselector_tpu_torch.models.qwen25vl import weights
from visionselector_tpu_torch.train import (
    data, dataset, loss, prefetch, train_step)
predict.main(["--device", "cpu", "--max-new-tokens", "3"])
predict.main(["--device", "cpu", "--method", "orig", "--max-new-tokens", "2"])
cfg = qwen25vl_tiny()
eng = QwenVLEngine(cfg, init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu"), device="cpu")
bat = ContinuousBatcher(eng, n_slots=2, t_max=256, chunk=2, kv_quant="int8")
try:
    res = bat.submit(dict(input_ids=np.arange(5, 12)), 5, (-1,),
                     temperature=0.7, seed=1)
finally:
    bat.shutdown()
assert len(res.tokens) == 5 and bat.stats["chunks"] == 2, res.tokens
train_cli.main(["--smoke", "--device", "cpu", "--total-steps", "2",
                "--batch-size", "1", "--output-dir", sys.argv[1]])
loaded = sorted({m.split(".")[0] for m, mod in sys.modules.items()
                 if mod is not None}
                & {"jax", "jaxlib", "triton", "visionselector_tpu",
                   "safetensors", "transformers"})
print(json.dumps({"loaded": loaded,
                  "launches": [A.FLASH_LAUNCHES, A.DIAG_LAUNCHES,
                               A.DECODE_LAUNCHES]}))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path / "run")],
                       capture_output=True, text=True, timeout=300, cwd=REPO,
                       env=env)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert json.loads(lines[0])["tokens"]
    assert json.loads(lines[1])["method"] == "orig"
    assert json.loads(lines[-1]) == {"loaded": [], "launches": [0, 0, 0]}
    assert os.path.isfile(tmp_path / "run" / "importance_scorer.safetensors")
