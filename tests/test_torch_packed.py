"""The port's packed-head attention (K3) and zero-padded ViT heads against
the JAX package: ``_flash_pallas_packed`` (Pallas, interpret mode on the
CPU), ``weights.pad_vit_head_dim``, the padded ``vit_forward`` and the
engine under ``VST_PACKED_ATTN=1``. Same numpy inputs from a seed go to
both; fp32.

Tolerances: kernel level atol 3e-5 / rtol 1e-4 (as the JAX package's own
packed test); padded weights bit-equal; ``vit_forward`` atol 1e-4 against
JAX (fp32 through 4 blocks and the merger) and 1e-5 padded against
unpadded (the same function, zeros summed in); the engine: equal selected
indices and greedy tokens. JAX's jit caches are not keyed on ``VST_*``
variables, so JAX calls under the variable run between
``jax.clear_caches()`` calls.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_params import jax_param_tree

from visionselector_tpu.core.config import qwen25vl_tiny as jax_tiny
from visionselector_tpu.kernels import attention as jattn
from visionselector_tpu.models.qwen25vl import model as jmodel
from visionselector_tpu.models.qwen25vl import vit as jvit
from visionselector_tpu.models.qwen25vl import weights as jweights
from visionselector_tpu.preprocess import indices as jidx
from visionselector_tpu.preprocess.image import preprocess_image
from visionselector_tpu.preprocess.rope import expand_vision_tokens
from visionselector_tpu_torch.core.config import qwen25vl_tiny
from visionselector_tpu_torch.kernels import attention as tattn
from visionselector_tpu_torch.models.qwen25vl import lm as tlm
from visionselector_tpu_torch.models.qwen25vl import model as tmodel
from visionselector_tpu_torch.models.qwen25vl import vit as tvit
from visionselector_tpu_torch.models.qwen25vl.weights import (
    from_jax_params,
    pad_vit_head_dim,
)
from visionselector_tpu_torch.preprocess import indices as tidx

BLOCK = 64


@pytest.fixture(scope="module")
def params():
    tree = jax_param_tree(jax_tiny(), seed=3, scorer_std=0.02)
    return tree, from_jax_params(tree, qwen25vl_tiny(), "cpu")


def _padded_tree(tree):
    out = dict(tree)
    out["visual"] = jax.tree.map(np.asarray, jweights.pad_vit_head_dim(
        tree["visual"], jax_tiny().vision))
    return out


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("real_d, h, h_kv", [(128, 2, 2), (80, 4, 2)])
def test_packed_matches_pallas(causal, real_d, h, h_kv):
    """Internal padding rows; heads of real_d zero-padded to dp = 128 with
    the real scale; GQA unexpanded here, expanded for JAX (as the
    reference's LM expands kv before K3)."""
    b, s, dp = 1, 256, 128
    rng = np.random.RandomState(real_d + causal)
    seg = np.concatenate([np.repeat(np.arange(1, 4), 70),
                          np.zeros(16, np.int32), np.full(30, 4)])
    seg = seg.astype(np.int32)[None]

    def heads(n):
        x = np.zeros((b, s, n, dp), np.float32)
        x[..., :real_d] = rng.randn(b, s, n, real_d)
        return x

    q, k, v = heads(h), heads(h_kv), heads(h_kv)
    scale = real_d**-0.5
    bounds = (None if causal
              else jattn.segment_block_bounds(seg[0], BLOCK, BLOCK))
    rep = h // h_kv
    want = jattn._flash_pallas_packed(
        jnp.asarray(q), jnp.asarray(np.repeat(k, rep, 2)),
        jnp.asarray(np.repeat(v, rep, 2)), jnp.asarray(seg), jnp.asarray(seg),
        causal, scale, block_q=BLOCK, block_k=BLOCK,
        kv_bounds=None if bounds is None else jnp.asarray(bounds),
        interpret=True)
    t = torch.from_numpy
    got = tattn.flash_packed_fwd(
        t(q).flatten(2), t(k).flatten(2), t(v).flatten(2), t(seg), t(seg),
        h, h_kv, dp, causal=causal, scale=scale, kv_bounds=bounds)
    assert got.shape == (b, s, h * dp)
    got = got.unflatten(-1, (h, dp)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=3e-5, rtol=1e-4)
    assert (got[..., real_d:] == 0).all()
    assert (got[0, seg[0] == 0] == 0).all()


def test_packed_reads_slab_views_without_copy():
    """q, k, v as column slices of one [B, S, 3*H*dp] slab: the [B, S, H,
    dp] views share its storage, and the plain path equals flash_plain on
    them."""
    b, s, h, dp = 1, 128, 2, 128
    slab = torch.from_numpy(
        np.random.RandomState(0).randn(b, s, 3 * h * dp).astype(np.float32))
    q, k, v = slab.split(h * dp, dim=-1)
    qh = tattn._heads(q, h, dp, "q")
    assert qh.data_ptr() == slab.data_ptr() and qh.stride()[1:] == (
        3 * h * dp, dp, 1)
    seg = torch.ones(b, s, dtype=torch.int32)
    got = tattn.attention_packed(q, k, v, seg, seg, h, h, dp)
    want = tattn.flash_plain(qh, tattn._heads(k, h, dp, "k"),
                             tattn._heads(v, h, dp, "v"), seg, seg)
    assert torch.equal(got, want.flatten(2))
    with pytest.raises(ValueError, match="heads"):
        tattn.attention_packed(q, k, v, seg, seg, h, h, 96)


def test_pad_vit_head_dim_matches_jax(params):
    """The JAX package's padded tree through from_jax_params equals the
    port's pad_vit_head_dim of the unpadded tower; the input tower is left
    as it was."""
    tree, tparams = params
    before = {n: p.clone() for n, p in tparams.visual.named_parameters()}
    mine = pad_vit_head_dim(tparams.visual, qwen25vl_tiny().vision)
    theirs = from_jax_params(_padded_tree(tree), qwen25vl_tiny(), "cpu")
    assert tvit.head_width(mine) == tvit.head_width(theirs.visual) == 128
    for (name, a), (_, b) in zip(mine.named_parameters(),
                                 theirs.visual.named_parameters()):
        assert torch.equal(a, b), name
    for name, p in tparams.visual.named_parameters():
        assert torch.equal(p, before[name]), name
    with pytest.raises(ValueError, match="already"):
        pad_vit_head_dim(mine, qwen25vl_tiny().vision)


@pytest.mark.parametrize("align", [True, False])
def test_padded_vit_matches_unpadded_and_jax(params, align):
    tree, tparams = params
    jcfg = jax_tiny().vision
    grid = np.asarray([(1, 14, 18)])
    n = int(np.prod(grid))
    px = np.random.RandomState(n).randn(n, jcfg.patch_dim).astype(np.float32)
    kw = dict(window_size=jcfg.window_size, pad_to=512, align_windows=align)
    jb = jidx.build_vision_batch(px, grid, **kw)
    tb = tidx.build_vision_batch(px, grid, **kw)
    want = jvit.vit_forward(
        jax.tree.map(jnp.asarray, _padded_tree(tree)["visual"]),
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
    padded = pad_vit_head_dim(tparams.visual, qwen25vl_tiny().vision)
    got = tvit.vit_forward(padded, **vb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(
        got.numpy(), tvit.vit_forward(tparams.visual, **vb).numpy(),
        atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="padded"):
        tvit.vit_forward(padded, attn_variant="fused", **vb)


def test_apply_rotary_padded_keeps_pad_zero():
    rng = np.random.RandomState(4)
    s, h, d, dp = 32, 3, 80, 128
    q = np.zeros((s, h, dp), np.float32)
    k = np.zeros((s, h, dp), np.float32)
    q[..., :d], k[..., :d] = rng.randn(2, s, h, d)
    pos = rng.randint(0, 30, (s, 2))
    cos, sin = tvit.vision_rotary_cos_sin(torch.from_numpy(pos), d)
    t = torch.from_numpy
    qo, ko = tvit.apply_rotary_padded(t(q), t(k), cos, sin, d)
    qr, kr = tvit.apply_rotary(t(q[..., :d]), t(k[..., :d]), cos, sin)
    assert torch.equal(qo[..., :d], qr) and torch.equal(ko[..., :d], kr)
    assert (qo[..., d:] == 0).all() and (ko[..., d:] == 0).all()
    jq, jk = jvit.apply_rotary_padded(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(cos.numpy()),
                                      jnp.asarray(sin.numpy()), d)
    np.testing.assert_allclose(qo.numpy(), np.asarray(jq), atol=1e-6)
    np.testing.assert_allclose(ko.numpy(), np.asarray(jk), atol=1e-6)


@pytest.mark.parametrize("head_dim", [24, 128])
def test_lm_prefill_packed_routing(monkeypatch, head_dim):
    """Under "packed", a decoder head dim that is a multiple of 128 takes
    the packed entry point once per layer (same values as the flash entry
    point); the tiny decoder's 24 does not."""
    tc = qwen25vl_tiny().text
    if head_dim == 128:
        tc = dataclasses.replace(tc, hidden_size=256, num_attention_heads=2,
                                 num_key_value_heads=1,
                                 mrope_section=(16, 24, 24))
    tc = dataclasses.replace(tc, vocab_size=512)
    assert tc.head_dim == head_dim
    lm = tlm.init_lm_params(tc, torch.Generator().manual_seed(1), "cpu",
                            torch.float32)
    calls = []
    real = tlm.attention_packed

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tlm, "attention_packed", counted)
    t = 96
    x = torch.from_numpy(
        np.random.RandomState(5).randn(1, t, tc.hidden_size)
        .astype(np.float32) * 0.5)
    pos = torch.arange(t).expand(3, 1, t)
    seg = (torch.arange(t) < 80).int()[None]
    h_p, (k_p, v_p) = tlm.lm_prefill(lm, x, pos, seg, attn_variant="packed")
    h_d, (k_d, v_d) = tlm.lm_prefill(lm, x, pos, seg)
    assert len(calls) == (tc.num_hidden_layers if head_dim == 128 else 0)
    assert torch.equal(h_p, h_d) and torch.equal(k_p, k_d)


def test_engine_packed_matches_jax_engine(params, monkeypatch):
    tree, tparams = params
    rng = np.random.RandomState(9)
    img = (rng.rand(224, 280, 3) * 255).astype(np.uint8)
    px, grid = preprocess_image(img, min_pixels=1, max_pixels=10**9)
    ids = expand_vision_tokens([100, 200], [300, 400, 500], grid)
    jax.clear_caches()
    monkeypatch.setenv("VST_PACKED_ATTN", "1")
    try:
        jeng = jmodel.QwenVLEngine(jax_tiny(), jax.tree.map(jnp.asarray, tree))
        want = jeng.generate(ids, px, grid, max_new_tokens=6)
    finally:
        monkeypatch.delenv("VST_PACKED_ATTN")
        jax.clear_caches()
    teng = tmodel.QwenVLEngine(qwen25vl_tiny(), tparams, device="cpu",
                               attn_variant="packed")
    assert tvit.head_width(teng.params.visual) == 128
    assert tvit.head_width(tparams.visual) == 16  # the caller's is kept
    got = teng.generate(ids, px, grid, max_new_tokens=6)
    np.testing.assert_array_equal(got.selected_indices,
                                  want.selected_indices)
    assert got.tokens == want.tokens
    text = teng.generate(np.arange(10, 30), max_new_tokens=4)
    assert text.tokens == tmodel.QwenVLEngine(
        qwen25vl_tiny(), tparams, device="cpu").generate(
            np.arange(10, 30), max_new_tokens=4).tokens
    padded = tmodel.QwenVLParams(teng.params.visual, tparams.lm,
                                 tparams.scorer)
    for variant in ("fused", "packed"):
        with pytest.raises(ValueError, match="unpadded"):
            tmodel.QwenVLEngine(qwen25vl_tiny(), padded, device="cpu",
                                attn_variant=variant)
    with pytest.raises(ValueError, match="attn_variant"):
        tmodel.QwenVLEngine(qwen25vl_tiny(), tparams, device="cpu",
                            attn_variant="slots")
