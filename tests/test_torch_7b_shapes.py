"""Qwen2.5-VL-7B's structural features on the CPU: the port against the
JAX package on a tiny config built here from ``qwen25vl_tiny()`` with
GQA 14 / 2 (n_rep 7, the 7B's ratio: seven query heads a kv head, which
do not divide a 16-row tile), an untied lm head, and the vision tower's
``out_hidden_size`` equal to the text width (the selector is built at
that width), with the same numpy weights and inputs made from a seed,
fp32:

- prefill logits and a decode step, and ``lm_decode_chunk`` at t_c 4 and
  8 (28 and 56 query rows a kv head) over a float cache (the model's
  dtype: fp32 here, bf16 on the card; the reference writes rows of the
  model's dtype) and an int8 cache, two slots at different lengths,
  within 1e-4;
- ``QwenVLEngine.generate`` with the selector and ``orig``: selected
  indices bit-equal, 8 greedy tokens equal;
- ``config_from_hf`` on a ``config.json`` written from ``qwen25vl_7b()``'s
  fields equals ``qwen25vl_7b()`` field by field.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_serving_params import (  # noqa: F401 (one_thread: autouse)
    EOS,
    one_thread,
    serving_tree,
)

from visionselector_tpu.core.config import qwen25vl_tiny as jax_tiny
from visionselector_tpu.models.qwen25vl import lm as jlm
from visionselector_tpu.models.qwen25vl import model as jmodel
from visionselector_tpu_torch.core.config import qwen25vl_7b, qwen25vl_tiny
from visionselector_tpu_torch.models.qwen25vl import lm as tlm
from visionselector_tpu_torch.models.qwen25vl import model as tmodel
from visionselector_tpu_torch.models.qwen25vl.weights import (
    config_from_hf,
    from_jax_params,
)
from visionselector_tpu_torch.preprocess.image import preprocess_image
from visionselector_tpu_torch.preprocess.rope import expand_vision_tokens

ATOL = 1e-4
WIDTH = 112  # 14 heads of 8
NEW_TOKENS = 8


def seven_b_shaped(cfg):
    """``cfg`` (either package's tiny config) with the 7B's structure."""
    return dataclasses.replace(
        cfg,
        vision=dataclasses.replace(cfg.vision, out_hidden_size=WIDTH),
        text=dataclasses.replace(
            cfg.text, hidden_size=WIDTH, num_attention_heads=14,
            num_key_value_heads=2, mrope_section=(2, 1, 1),
            tie_word_embeddings=False))


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = seven_b_shaped(jax_tiny()), seven_b_shaped(qwen25vl_tiny())
    assert tcfg.text.num_attention_heads // tcfg.text.num_key_value_heads == 7
    tree = serving_tree(jcfg, seed=7, scorer_std=0.02)
    assert "lm_head_kernel" in tree["lm"]
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            from_jax_params(tree, tcfg, "cpu"))


def test_prefill_and_decode_step_match_jax(model):
    jcfg, tcfg, jp, tp = model
    rng = np.random.RandomState(3)
    t, v = 24, 19
    embeds = rng.randn(1, t, WIDTH).astype(np.float32)
    pos = np.stack([np.arange(t), np.arange(t) // 2, np.arange(t) % 5]
                   )[:, None]
    seg = (np.arange(t) < v).astype(np.int32)[None]
    jh, (jk, jv) = jlm.lm_prefill(jp["lm"], jnp.asarray(embeds),
                                  jnp.asarray(pos), jnp.asarray(seg),
                                  jcfg.text)
    th, (tk, _) = tlm.lm_prefill(tp.lm, torch.from_numpy(embeds),
                                 torch.from_numpy(pos), torch.from_numpy(seg))
    np.testing.assert_allclose(tk.numpy()[:, :, :v], np.asarray(jk)[:, :, :v],
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        tlm.lm_head(tp.lm, th[0, :v]).numpy(),
        np.asarray(jlm.lm_head(jp["lm"], jh[0, :v], jcfg.text)), atol=ATOL,
        rtol=0)
    nl, t_max = jcfg.text.num_hidden_layers, 32
    pad = ((0, 0), (0, 0), (0, t_max - t), (0, 0), (0, 0))
    jcache = jlm.KVCache(k=jnp.pad(jk, pad), v=jnp.pad(jv, pad),
                         length=jnp.full((nl, 1), v, jnp.int32))
    x = rng.randn(1, 1, WIDTH).astype(np.float32)
    pos1 = np.full((3, 1, 1), v, np.int64)
    jh, _ = jlm.lm_decode_step(jp["lm"], jcache, jnp.asarray(x),
                               jnp.asarray(pos1), jcfg.text)
    tcache = tlm.KVCache(k=torch.from_numpy(np.array(jcache.k)),
                         v=torch.from_numpy(np.array(jcache.v)),
                         length=torch.full((nl, 1), v, dtype=torch.int64))
    th, _ = tlm.lm_decode_step(tp.lm, tcache, torch.from_numpy(x),
                               torch.from_numpy(pos1))
    np.testing.assert_allclose(
        tlm.lm_head(tp.lm, th[0, 0]).numpy(),
        np.asarray(jlm.lm_head(jp["lm"], jh[0, 0], jcfg.text)), atol=ATOL,
        rtol=0)


CHUNKS = [(t_c, pool) for t_c in (4, 8) for pool in ("float", "int8")]


@pytest.mark.parametrize("t_c, pool", CHUNKS,
                         ids=[f"t_c{t}-{p}" for t, p in CHUNKS])
def test_decode_chunk_matches_jax(model, t_c, pool):
    """t_c rows a slot over a two-slot cache (lengths 17 and 60: the
    second slot's chunk ends on the 64-row tile edge at t_c 4 and crosses
    it at t_c 8): the chunk's logits, the cache lengths and the rows
    written."""
    jcfg, tcfg, jp, tp = model
    cfg = jcfg.text
    rng = np.random.RandomState(10 * t_c + len(pool))
    shape = (cfg.num_hidden_layers, 2, 72, cfg.num_key_value_heads,
             cfg.head_dim)
    kf = rng.randn(*shape).astype(np.float32)
    vf = rng.randn(*shape).astype(np.float32)
    lens = np.tile(np.asarray([[17, 60]], np.int32),
                   (cfg.num_hidden_layers, 1))
    if pool == "int8":
        k8, ks = jlm.quantize_kv(jnp.asarray(kf))
        v8, vs = jlm.quantize_kv(jnp.asarray(vf))
        jc = jlm.QuantKVCache(k=k8, v=v8, k_scale=ks, v_scale=vs,
                              length=jnp.asarray(lens))
        tc = tlm.QuantKVCache(
            k=torch.from_numpy(np.array(k8)), v=torch.from_numpy(np.array(v8)),
            k_scale=torch.from_numpy(np.array(ks)),
            v_scale=torch.from_numpy(np.array(vs)),
            length=torch.from_numpy(lens.astype(np.int64)))
    else:
        jc = jlm.KVCache(k=jnp.asarray(kf), v=jnp.asarray(vf),
                         length=jnp.asarray(lens))
        tc = tlm.KVCache(k=torch.from_numpy(kf.copy()),
                         v=torch.from_numpy(vf.copy()),
                         length=torch.from_numpy(lens.astype(np.int64)))
    x = rng.randn(2, t_c, WIDTH).astype(np.float32)
    pos = (np.asarray([30, 75])[:, None] + np.arange(t_c))[None].repeat(3, 0)
    jh, jc2 = jlm.lm_decode_chunk(jp["lm"], jc, jnp.asarray(x),
                                  jnp.asarray(pos), cfg)
    th, tc2 = tlm.lm_decode_chunk(tp.lm, tc, torch.from_numpy(x),
                                  torch.from_numpy(pos))
    np.testing.assert_allclose(
        tlm.lm_head(tp.lm, th).numpy(),
        np.asarray(jlm.lm_head(jp["lm"], jh, cfg)), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tc2.length.numpy(), np.asarray(jc2.length))
    for b, n in enumerate((17, 60)):  # the chunk's rows, as written
        rows = slice(n, n + t_c)
        got = tc2.k[:, b, rows].numpy()
        want = np.asarray(jc2.k[:, b, rows])
        if pool == "int8":
            np.testing.assert_array_equal(got, want)
            np.testing.assert_allclose(tc2.k_scale[:, b, rows].numpy(),
                                       np.asarray(jc2.k_scale[:, b, rows]),
                                       rtol=1e-5)
        else:
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _request():
    rng = np.random.RandomState(5)
    img = (rng.rand(224, 280, 3) * 255).astype(np.uint8)
    px, grid = preprocess_image(img, min_pixels=1, max_pixels=10**9)
    ids = expand_vision_tokens([100, 200, 300], [400, 500, 600], grid)
    return ids, px, grid


@pytest.mark.parametrize("use_selector", [True, False],
                         ids=["selector", "orig"])
def test_generate_matches_jax_engine(model, use_selector):
    """A 224x280 image (80 merged tokens) at budget 0.3: the selector's
    indices bit-equal (with the score gap they rely on), 8 greedy tokens
    equal."""
    jcfg, tcfg, jp, tp = model
    ids, px, grid = _request()
    want = jmodel.QwenVLEngine(jcfg, jp, use_selector=use_selector,
                               budget=0.3).generate(
        ids, px, grid, max_new_tokens=NEW_TOKENS, eos_token_ids=EOS)
    got = tmodel.QwenVLEngine(tcfg, tp, use_selector=use_selector,
                              budget=0.3, device="cpu").generate(
        ids, px, grid, max_new_tokens=NEW_TOKENS, eos_token_ids=EOS)
    if use_selector:
        np.testing.assert_array_equal(got.selected_indices,
                                      want.selected_indices)
        s = np.sort(np.asarray(got.scores))[::-1]
        k = len(got.selected_indices)
        assert s[k - 1] - s[k] > 1e-4 * np.abs(s).max(), (s[k - 1], s[k])
    else:
        assert got.selected_indices is None
    assert got.prefill_len == want.prefill_len
    assert got.tokens == want.tokens
    assert len(set(got.tokens)) > 1


def test_config_from_hf_reads_the_7b(tmp_path):
    """A config.json written from ``qwen25vl_7b()``'s fields (flat text
    fields, ``rope_scaling.mrope_section``, the vision tower nested) reads
    back as ``qwen25vl_7b()``, field by field: width 3,584, GQA 28 / 4,
    vocab 152,064, an untied head, ``out_hidden_size`` 3,584."""
    want = qwen25vl_7b()
    text = dataclasses.asdict(want.text)
    text["rope_scaling"] = {"type": "mrope",
                            "mrope_section": list(text.pop("mrope_section"))}
    raw = dict(text, vision_config=dataclasses.asdict(want.vision),
               image_token_id=want.image_token_id,
               video_token_id=want.video_token_id,
               vision_start_token_id=want.vision_start_token_id,
               vision_end_token_id=want.vision_end_token_id,
               eos_token_id=want.eos_token_id)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(raw, f)
    got = config_from_hf(str(tmp_path))
    for field in dataclasses.fields(want):
        assert getattr(got, field.name) == getattr(want, field.name), \
            field.name
    assert got == want
    assert (got.text.hidden_size, got.text.num_attention_heads,
            got.text.num_key_value_heads, got.text.vocab_size) == (
        3584, 28, 4, 152064)
    assert got.with_selector().selector.in_features == 3584
