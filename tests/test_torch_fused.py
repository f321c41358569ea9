"""The port's fused rotary + attention (K6) against the JAX package's
``fused_vit_attention`` (Pallas, interpret mode on the CPU), and the fused
ViT and engine configurations against the JAX package under
``VST_FUSED_ATTN=1``. Same numpy inputs from a seed go to both; fp32.

Tolerances: kernel level atol 3e-5 / rtol 1e-4 (as the JAX package's own
fused-kernel test: fp32 online softmax against a dense one); ``vit_forward``
atol 1e-4 (fp32 through 4 blocks and the merger, as tests/test_torch_vit.py);
the engine: equal greedy tokens and first-token logits within atol 1e-4.

JAX's jit caches are not keyed on ``VST_*`` variables, so every JAX call
made under the variable runs between ``jax.clear_caches()`` calls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_params import jax_param_tree

from visionselector_tpu.core.config import qwen25vl_tiny as jax_tiny
from visionselector_tpu.kernels import attention as jattn
from visionselector_tpu.kernels import fused_vit_attn as jfused
from visionselector_tpu.models.qwen25vl import model as jmodel
from visionselector_tpu.models.qwen25vl import vit as jvit
from visionselector_tpu.preprocess import indices as jidx
from visionselector_tpu.preprocess.image import preprocess_image
from visionselector_tpu.preprocess.rope import expand_vision_tokens
from visionselector_tpu_torch.core.config import qwen25vl_tiny
from visionselector_tpu_torch.kernels import attention as tattn
from visionselector_tpu_torch.kernels import fused_vit_attn as tfused
from visionselector_tpu_torch.models.qwen25vl import model as tmodel
from visionselector_tpu_torch.models.qwen25vl import vit as tvit
from visionselector_tpu_torch.models.qwen25vl.weights import from_jax_params
from visionselector_tpu_torch.preprocess import indices as tidx

BLOCK = 64


@pytest.fixture
def fused_env(monkeypatch):
    """VST_FUSED_ATTN=1 for the JAX package, with its jit caches cleared
    on the way in and out."""
    jax.clear_caches()
    monkeypatch.setenv("VST_FUSED_ATTN", "1")
    yield
    monkeypatch.delenv("VST_FUSED_ATTN")
    jax.clear_caches()


@pytest.fixture(scope="module")
def params():
    tree = jax_param_tree(jax_tiny(), seed=2, scorer_std=0.02)
    return tree, from_jax_params(tree, qwen25vl_tiny(), "cpu")


def _layouts(s):
    """Window segments (ragged windows of 20-64 rows), full segments (two
    images) and video segments (8 frames of equal length), each with a
    padding tail of 16 rows."""
    wseg = np.zeros(s, np.int32)
    r, i = 0, 1
    while r + 64 <= s - 16:
        n = 20 + (i * 17) % 45
        wseg[r:r + n] = i
        r, i = r + n, i + 1
    fseg = np.zeros(s, np.int32)
    fseg[:150], fseg[150:s - 16] = 1, 2
    n = (s - 16) // 8
    vseg = np.zeros(s, np.int32)
    vseg[:8 * n] = np.repeat(np.arange(1, 9), n)
    return {"window": wseg, "full": fseg, "video": vseg}


@pytest.mark.parametrize("d", [16, 80])
@pytest.mark.parametrize("kind", ["window", "full"])
def test_fused_kernel_matches_pallas(d, kind):
    s, h = 256, 4
    rng = np.random.RandomState(d)
    qkv = rng.randn(s, 3 * h * d).astype(np.float32)
    seg = _layouts(s)[kind]
    pos = rng.randint(0, 12, (s, 2))
    cos, sin = jvit.vision_rotary_cos_sin(jnp.asarray(pos), d)
    bounds = jattn.segment_block_bounds(seg, BLOCK, BLOCK)
    want = jfused.fused_vit_attention(
        jnp.asarray(qkv), jnp.asarray(seg), cos, sin, jnp.asarray(bounds),
        h, d, block_q=BLOCK, block_k=BLOCK, interpret=True)
    got = tfused.fused_vit_attention(
        torch.from_numpy(qkv), torch.from_numpy(seg),
        torch.from_numpy(np.array(cos)), torch.from_numpy(np.array(sin)),
        bounds, h, d)
    assert got.shape == (s, h * d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5,
                               rtol=1e-4)
    assert (got.numpy()[seg == 0] == 0).all()


def test_fused_plain_is_rotary_then_flash():
    """The plain version is the unfused path: apply_rotary on the slab's
    q/k views, then flash_plain with the bounds (bit for bit)."""
    s, h, d = 192, 2, 16
    rng = np.random.RandomState(3)
    qkv = torch.from_numpy(rng.randn(s, 3 * h * d).astype(np.float32))
    seg = torch.from_numpy(_layouts(s)["full"])
    cos, sin = tvit.vision_rotary_cos_sin(
        torch.from_numpy(rng.randint(0, 9, (s, 2))), d)
    bounds = tattn.segment_block_bounds(seg.numpy(), BLOCK, BLOCK)
    q, k, v = qkv.view(s, 3, h, d).unbind(1)
    q, k = tvit.apply_rotary(q, k, cos, sin)
    want = tattn.flash_plain(q[None], k[None], v[None], seg[None], seg[None],
                             kv_bounds=bounds)[0].reshape(s, h * d)
    got = tfused.fused_vit_attention(qkv, seg, cos, sin, bounds, h, d)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="width"):
        tfused.fused_vit_attention(qkv[:, :-3], seg, cos, sin, bounds, h, d)


@pytest.mark.parametrize("grid", [(1, 14, 18), (1, 10, 22)])
def test_vit_forward_fused_matches_jax(params, fused_env, grid):
    tree, tparams = params
    jcfg = jax_tiny().vision
    g = np.asarray([grid])
    n = int(np.prod(grid))
    px = np.random.RandomState(n).randn(n, jcfg.patch_dim).astype(np.float32)
    kw = dict(window_size=jcfg.window_size, pad_to=512, align_windows=True)
    jb = jidx.build_vision_batch(px, g, **kw)
    tb = tidx.build_vision_batch(px, g, **kw)
    want = jvit.vit_forward(
        jax.tree.map(jnp.asarray, tree["visual"]),
        jnp.asarray(jb.pixel_values), jnp.asarray(jb.rot_pos_ids),
        jnp.asarray(jb.window_seg_ids), jnp.asarray(jb.full_seg_ids),
        jnp.asarray(jb.reverse_index), jcfg,
        window_kv_bounds=jnp.asarray(jb.window_kv_bounds),
        full_kv_bounds=jnp.asarray(jb.full_kv_bounds),
        window_diag=jb.window_diag)
    t = torch.as_tensor
    vb = dict(pixel_values=t(tb.pixel_values), rot_pos_ids=t(tb.rot_pos_ids),
              window_seg_ids=t(tb.window_seg_ids),
              full_seg_ids=t(tb.full_seg_ids),
              reverse_index=t(tb.reverse_index),
              window_kv_bounds=t(tb.window_kv_bounds),
              full_kv_bounds=t(tb.full_kv_bounds),
              window_diag=tb.window_diag)
    got = tvit.vit_forward(tparams.visual, attn_variant="fused", **vb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    default = tvit.vit_forward(tparams.visual, **vb)
    np.testing.assert_allclose(got.numpy(), default.numpy(), atol=1e-5,
                               rtol=0)


def test_engine_fused_matches_jax_engine(params, fused_env):
    tree, tparams = params
    rng = np.random.RandomState(7)
    img = (rng.rand(224, 280, 3) * 255).astype(np.uint8)
    px, grid = preprocess_image(img, min_pixels=1, max_pixels=10**9)
    ids = expand_vision_tokens([100, 200, 300], [400, 500], grid)
    jeng = jmodel.QwenVLEngine(jax_tiny(), jax.tree.map(jnp.asarray, tree))
    want = jeng.generate(ids, px, grid, max_new_tokens=6)
    teng = tmodel.QwenVLEngine(qwen25vl_tiny(), tparams, device="cpu",
                               attn_variant="fused")
    got = teng.generate(ids, px, grid, max_new_tokens=6)
    np.testing.assert_array_equal(got.selected_indices,
                                  want.selected_indices)
    assert got.tokens == want.tokens
    default = tmodel.QwenVLEngine(qwen25vl_tiny(), tparams, device="cpu")
    np.testing.assert_allclose(
        got.logits.numpy(),
        default.generate(ids, px, grid, max_new_tokens=1).logits.numpy(),
        atol=1e-4, rtol=0)


@pytest.mark.parametrize("variant", ["fused", "packed"])
def test_batcher_admits_under_each_variant(params, variant):
    """ContinuousBatcher admission prefills run the engine's attention
    configuration: an image and a text-only request give the greedy
    tokens of one-shot generate on the same engine."""
    from visionselector_tpu_torch.models.qwen25vl.continuous import (
        ContinuousBatcher,
    )

    _, tparams = params
    rng = np.random.RandomState(11)
    img = (rng.rand(112, 168, 3) * 255).astype(np.uint8)
    px, grid = preprocess_image(img, min_pixels=1, max_pixels=10**9)
    reqs = [dict(input_ids=expand_vision_tokens([100], [300, 400], grid),
                 pixel_values=px, grid_thw=grid),
            dict(input_ids=np.arange(40, 60))]
    eng = tmodel.QwenVLEngine(qwen25vl_tiny(), tparams, device="cpu",
                              attn_variant=variant)
    bat = ContinuousBatcher(eng, n_slots=2, t_max=256, chunk=2)
    try:
        got = [bat.submit(r, 5, (-1,)).tokens for r in reqs]
    finally:
        bat.shutdown()
    want = [eng.generate(**r, max_new_tokens=5, eos_token_ids=(-1,)).tokens
            for r in reqs]
    assert got == want and all(len(t) == 5 for t in got)
