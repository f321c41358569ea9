"""The training-free strategies' parts against the JAX package's, on the
same numpy inputs (fp32, made from a seed): the host strategies (indices
bit-equal, replacement embeddings within 1e-6), the Dynamic-Qwen predictor
carried across by ``predictor_from_jax`` (logits within 1e-5, the same
kept positions), ``attention_with_received`` (out within 1e-5, recv within
1e-6 relative), ``vit_forward_stats`` on the tiny config with a full and a
window last block (within 1e-4), and the two-stage prefill's parts:
``_fastv_attention_colsum``, ``lm_prefill_layers`` over a layer range and
``layer_qk``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_params import jax_param_tree

from visionselector_tpu.core.config import qwen25vl_tiny as jax_tiny
from visionselector_tpu.kernels import attention as jattn
from visionselector_tpu.models.qwen25vl import lm as jlm
from visionselector_tpu.models.qwen25vl import model as jmodel
from visionselector_tpu.models.qwen25vl import vit as jvit
from visionselector_tpu.selector import baselines as jbase
from visionselector_tpu.selector.baselines import dynamic as jdyn
from visionselector_tpu_torch.core.config import qwen25vl_tiny
from visionselector_tpu_torch.kernels import attention as tattn
from visionselector_tpu_torch.models.qwen25vl import lm as tlm
from visionselector_tpu_torch.models.qwen25vl import model as tmodel
from visionselector_tpu_torch.models.qwen25vl import vit as tvit
from visionselector_tpu_torch.models.qwen25vl.weights import (
    from_jax_params,
    predictor_from_jax,
)
from visionselector_tpu_torch.preprocess import indices as tidx
from visionselector_tpu_torch.selector import baselines as tbase
from visionselector_tpu_torch.selector.baselines import dynamic as tdyn

VIT_SIDE = ("visionzip", "prumerge_plus", "divprune", "holov", "random")


def _vit_inputs(n, seed, d=48, hidden=32):
    rng = np.random.RandomState(seed)
    embeds = rng.randn(n, d).astype(np.float32)
    attn = rng.rand(n).astype(np.float32)
    attn /= attn.sum()
    keys = rng.randn(n, hidden).astype(np.float32)
    return embeds, attn, keys


@pytest.mark.parametrize("budget", [0.1, 0.3])
@pytest.mark.parametrize("n", [60, 300])
@pytest.mark.parametrize("name", VIT_SIDE)
def test_vit_side_strategy_matches_jax(name, n, budget):
    """Same kept indices to the bit, same replacement embeddings; a
    strategy that reads no statistics gets None for them, as the engine
    passes it."""
    embeds, attn, keys = _vit_inputs(n, seed=n + int(budget * 10))
    grid = np.asarray([[1, 2, n // 2]])
    jstrat, tstrat = jbase.get_baseline(name), tbase.get_baseline(name)
    assert tstrat.needs_stats == jstrat.needs_stats
    assert tstrat.name == jstrat.name == name
    stats = (attn, keys) if tstrat.needs_stats else (None, None)
    want_idx, want_emb = jstrat(embeds, *stats, budget, grid)
    got_idx, got_emb = tstrat(embeds, *stats, budget, grid)
    np.testing.assert_array_equal(got_idx, want_idx)
    assert got_idx.dtype == np.int64
    assert np.all(np.diff(got_idx) > 0)
    assert (got_emb is None) == (want_emb is None)
    if want_emb is not None:
        np.testing.assert_allclose(got_emb, want_emb, atol=1e-6, rtol=0)


def _llm_inputs(t, n_img, seed, d=64):
    rng = np.random.RandomState(seed)
    fv = rng.rand(t).astype(np.float32)
    kl1 = (rng.rand(t) * 10).astype(np.float32)
    hidden = rng.randn(t, d).astype(np.float32)
    image_positions = np.arange(5, 5 + n_img, dtype=np.int64)
    return fv, kl1, hidden, image_positions


@pytest.mark.parametrize("budget", [0.1, 0.25, 1.0])
@pytest.mark.parametrize("n_img", [60, 250])
@pytest.mark.parametrize("name", ["fastv", "dart"])
def test_llm_side_strategy_matches_jax(name, n_img, budget):
    fv, kl1, hidden, img = _llm_inputs(n_img + 12, n_img, seed=n_img)
    jstrat, tstrat = jbase.get_baseline(name), tbase.get_baseline(name)
    assert (tstrat.capture, tstrat.target_layer, tstrat.llm_side) == (
        jstrat.capture, jstrat.target_layer, jstrat.llm_side)
    want = jstrat.select(fv, kl1, hidden, img, budget)
    got = tstrat.select(fv, kl1, hidden, img, budget)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_img", [60, 250])
def test_dynamic_predictor_matches_jax(n_img):
    """The predictor carried across (``predictor_from_jax``): logits within
    1e-5 of the JAX ``predictor_forward`` (with and without a policy), the
    same kept positions through ``DynamicSelect.select``."""
    d = 96
    tree = jax.tree.map(np.asarray, jdyn.init_predictor_params(
        jax.random.PRNGKey(1), d))
    pred = predictor_from_jax(tree, "cpu")
    fv, kl1, hidden, img = _llm_inputs(n_img + 12, n_img, seed=3, d=d)
    x = hidden[img][None]
    policy = (np.random.RandomState(4).rand(1, n_img, 1) > 0.3).astype(
        np.float32)
    for pol in (None, policy):
        want = np.asarray(jdyn.predictor_forward(
            tree, jnp.asarray(x), None if pol is None else jnp.asarray(pol)))
        got = tdyn.predictor_forward(
            pred, torch.as_tensor(x),
            None if pol is None else torch.as_tensor(pol))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    jstrat = jbase.get_baseline("dynamic", predictor_params=tree)
    tstrat = tbase.get_baseline("dynamic", predictor=pred)
    np.testing.assert_array_equal(
        tstrat.select(fv, kl1, hidden, img, 0.2),
        jstrat.select(fv, kl1, hidden, img, 0.2))


def test_dynamic_sizes_its_predictor_lazily():
    """Without a predictor, one sized to the hidden width is drawn from
    ``torch.Generator().manual_seed(seed)``: the same kept positions on
    every call and every instance with that seed, with the reference's
    init scales."""
    fv, kl1, hidden, img = _llm_inputs(80, 60, seed=5, d=96)
    a = tbase.get_baseline("dynamic", seed=2)
    b = tbase.get_baseline("dynamic", seed=2)
    first = a.select(fv, kl1, hidden, img, 0.3)
    np.testing.assert_array_equal(first, b.select(fv, kl1, hidden, img, 0.3))
    np.testing.assert_array_equal(first, a.select(fv, kl1, hidden, img, 0.3))
    assert len(first) == int(60 * 0.3)
    p = a.predictor
    assert p.down_kernel.shape == (96, 512) and len(p.blocks) == 2
    assert torch.equal(p.blocks[0].norm1_scale, torch.ones(512))
    assert abs(p.blocks[1].fc1_kernel.std().item() - 0.02) < 1e-3


def _recv_inputs(s, h, d, n_valid, seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(s, h, d).astype(dtype) for _ in range(3))
    seg = np.zeros(s, np.int32)
    seg[:n_valid] = 1
    return q, k, v, seg


@pytest.mark.parametrize("s,n_valid,segs", [
    (640, 600, 1),  # S not a multiple of 512, padding rows
    (1024, 1024, 1),  # two whole blocks, no padding
    (384, 300, 3),  # window segments, padding rows
])
def test_attention_with_received_matches_jax(s, n_valid, segs):
    q, k, v, seg = _recv_inputs(s, 4, 16, n_valid, seed=s)
    seg[:n_valid] = 1 + np.arange(n_valid) * segs // n_valid
    want_out, want_recv = jattn.attention_with_received(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg))
    want_out, want_recv = np.asarray(want_out), np.asarray(want_recv)
    got_out, got_recv = tattn.attention_with_received(
        *(torch.as_tensor(x) for x in (q, k, v, seg)))
    np.testing.assert_allclose(got_out.numpy(), want_out, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_recv.numpy(), want_recv, rtol=1e-6,
                               atol=1e-9)
    assert not got_out[n_valid:].any() and not got_recv[n_valid:].any()
    # each valid query hands out one unit of mass
    assert abs(got_recv.sum().item() - 1.0) < 1e-5
    dense = tattn.mha_reference(
        *(torch.as_tensor(x)[None] for x in (q, k, v)),
        torch.as_tensor(seg)[None], torch.as_tensor(seg)[None])[0]
    np.testing.assert_allclose(got_out.numpy(), dense.numpy(), atol=1e-5)


def test_attention_with_received_planted_fault_is_seen():
    q, k, v, seg = (torch.as_tensor(x)
                    for x in _recv_inputs(640, 4, 16, 600, seed=9))
    out, recv = tattn.attention_with_received(q, k, v, seg)
    bad_out, bad_recv = tattn.attention_with_received(
        q, k, v, seg, fault="unmask_padding_keys")
    assert bad_recv[600:].min() > 0 and (bad_out - out).abs().max() > 1e-2


def _four_layer_cfgs(full_last: bool):
    jcfg, tcfg = jax_tiny(), qwen25vl_tiny()
    full = (1, 3) if full_last else (1, 2)
    return tuple(dataclasses.replace(
        c, vision=dataclasses.replace(c.vision, fullatt_block_indexes=full),
        text=dataclasses.replace(c.text, num_hidden_layers=4))
        for c in (jcfg, tcfg))


@pytest.mark.parametrize("full_last", [True, False])
def test_vit_forward_stats_matches_jax(full_last):
    """Merged tokens, received mass and pooled keys within 1e-4, with the
    last block a full-attention block and a window block; the merged tokens
    equal ``vit_forward``'s."""
    jcfg, tcfg = _four_layer_cfgs(full_last)
    tree = jax_param_tree(jcfg, seed=2)
    tparams = from_jax_params(tree, tcfg, "cpu")
    grid = (1, 14, 18)
    n = int(np.prod(grid))
    px = np.random.RandomState(n).randn(n, jcfg.vision.patch_dim).astype(
        np.float32)
    vb = tidx.build_vision_batch(px, np.asarray([grid]),
                                 window_size=jcfg.vision.window_size,
                                 pad_to=512, align_windows=True)
    want = jvit.vit_forward_stats(
        jax.tree.map(jnp.asarray, tree["visual"]),
        *(jnp.asarray(getattr(vb, a)) for a in (
            "pixel_values", "rot_pos_ids", "window_seg_ids", "full_seg_ids",
            "reverse_index")), jcfg.vision,
        window_kv_bounds=jnp.asarray(vb.window_kv_bounds),
        full_kv_bounds=jnp.asarray(vb.full_kv_bounds),
        window_diag=vb.window_diag)
    t = torch.as_tensor
    kw = dict(pixel_values=t(vb.pixel_values), rot_pos_ids=t(vb.rot_pos_ids),
              window_seg_ids=t(vb.window_seg_ids),
              full_seg_ids=t(vb.full_seg_ids),
              reverse_index=t(vb.reverse_index),
              window_kv_bounds=t(vb.window_kv_bounds),
              full_kv_bounds=t(vb.full_kv_bounds),
              window_diag=vb.window_diag)
    got = tvit.vit_forward_stats(tparams.visual, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=0)
    m = vb.num_merged
    assert got[1][:m].min() > 0
    merged = tvit.vit_forward(tparams.visual, **kw)
    np.testing.assert_allclose(got[0].numpy(), merged.numpy(), atol=1e-5)


@pytest.fixture(scope="module")
def lm_params():
    jcfg, tcfg = _four_layer_cfgs(True)
    tree = jax_param_tree(jcfg, seed=4)
    return jcfg, tree, from_jax_params(tree, tcfg, "cpu")


def _lm_inputs(cfg, t=96, valid=80, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(1, t, cfg.text.hidden_size) * 0.5).astype(np.float32)
    pos = np.zeros((3, 1, t), np.int64)
    pos[:, 0, :valid] = np.stack([np.arange(valid), np.arange(valid) // 3,
                                  np.arange(valid) % 7])
    seg = (np.arange(t) < valid).astype(np.int32)[None]
    return x, pos, seg


@pytest.mark.parametrize("lo,hi", [(0, 2), (2, 4), (1, 2)])
def test_lm_prefill_layers_range_matches_jax(lm_params, lo, hi):
    jcfg, tree, tparams = lm_params
    x, pos, seg = _lm_inputs(jcfg)
    layers = jax.tree.map(lambda a: jnp.asarray(a[lo:hi]),
                          tree["lm"]["layers"])
    want_h, (want_k, want_v) = jlm.lm_prefill_layers(
        layers, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(seg), jcfg.text)
    got_h, (got_k, got_v) = tlm.lm_prefill_layers(
        tparams.lm, range(lo, hi), *(torch.as_tensor(a) for a in (x, pos,
                                                                  seg)))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(got_k.numpy(), np.asarray(want_k), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=1e-4,
                               rtol=0)


def test_lm_prefill_is_the_whole_range_plus_the_norm(lm_params):
    _, _, tparams = lm_params
    x, pos, seg = (torch.as_tensor(a) for a in _lm_inputs(lm_params[0]))
    h, kv = tlm.lm_prefill(tparams.lm, x, pos, seg)
    h_a, kv_a = tlm.lm_prefill_layers(tparams.lm, range(2), x, pos, seg)
    h_b, kv_b = tlm.lm_prefill_layers(tparams.lm, range(2, 4), h_a, pos, seg)
    want = tvit.rms_norm(h_b, tparams.lm.final_ln_scale)
    assert torch.equal(h, want)
    assert torch.equal(kv[0], torch.cat([kv_a[0], kv_b[0]]))
    empty_h, (empty_k, _) = tlm.lm_prefill_layers(tparams.lm, range(4, 4),
                                                  h_b, pos, seg)
    assert torch.equal(empty_h, h_b) and empty_k.shape[0] == 0
    with pytest.raises(ValueError, match="out of range"):
        tlm.lm_prefill_layers(tparams.lm, range(3, 5), x, pos, seg)


@pytest.mark.parametrize("layer", [0, 3])
def test_layer_qk_matches_jax(lm_params, layer):
    """Post-rotary q, and k expanded to q's head count (the reference's
    ``_repeat_kv``); an index past the stack raises (the reference clamps
    it)."""
    jcfg, tree, tparams = lm_params
    x, pos, _ = _lm_inputs(jcfg, seed=layer)
    jlayers = jax.tree.map(jnp.asarray, tree["lm"]["layers"])
    want_q, want_k = jlm.layer_qk(jlayers, layer, jnp.asarray(x),
                                  jnp.asarray(pos), jcfg.text)
    got_q, got_k = tlm.layer_qk(tparams.lm, layer, torch.as_tensor(x),
                                torch.as_tensor(pos))
    assert got_k.shape == got_q.shape == tuple(want_q.shape)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got_k.numpy(), np.asarray(want_k), atol=1e-5,
                               rtol=0)
    # the clamp the port does not copy: JAX reads the last layer at 4
    clamped = jlm.layer_qk(jlayers, 4, jnp.asarray(x), jnp.asarray(pos),
                           jcfg.text)[0]
    last = jlm.layer_qk(jlayers, 3, jnp.asarray(x), jnp.asarray(pos),
                        jcfg.text)[0]
    np.testing.assert_array_equal(np.asarray(clamped), np.asarray(last))
    with pytest.raises(ValueError, match="out of range"):
        tlm.layer_qk(tparams.lm, 4, torch.as_tensor(x), torch.as_tensor(pos))


@pytest.mark.parametrize("t,valid", [(300, 260), (256, 256), (100, 37)])
def test_fastv_colsum_matches_jax(t, valid):
    """Streamed over 128-row query blocks (T not a multiple of 128, padding
    rows); within 1e-6 relative of the reference and of a dense causal
    softmax. Dropping the causal mask (the planted fault) moves it."""
    rng = np.random.RandomState(t)
    q, k = (rng.randn(t, 4, 24).astype(np.float32) for _ in range(2))
    seg = (np.arange(t) < valid).astype(np.int32)
    want = np.asarray(jmodel._fastv_attention_colsum(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(seg), 24**-0.5))
    tq, tk, tseg = (torch.as_tensor(a) for a in (q, k, seg))
    got = tmodel._fastv_attention_colsum(tq, tk, tseg, 24**-0.5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-9)
    logits = torch.einsum("qhd,khd->hqk", tq, tk) * 24**-0.5
    ok = torch.ones(t, t, dtype=torch.bool).tril() & (tseg > 0)[None] & (
        tseg > 0)[:, None]
    dense = torch.where(ok, torch.softmax(
        torch.where(ok, logits, -1e30), -1), 0.0).mean(0).sum(0) / valid
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-5,
                               atol=1e-8)
    bad = tmodel._fastv_attention_colsum(tq, tk, tseg, 24**-0.5,
                                         fault="no_causal")
    assert (bad - got).abs().max() > 1e-3
