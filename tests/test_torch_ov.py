"""The port's LLaVA-OneVision-1.5 modules (``visionselector_tpu_torch.
models.llava_ov15``) against the JAX package's on llava_ov_tiny, with the
same weights (``ov_from_jax_params``) and inputs made with numpy from a
seed:

- ``build_rice_batch``'s CLS insert / strip maps and segments bit-equal,
  and the kernel-tile padding only appends zero rows of segment 0; a clip
  of 10 temporal groups with 10 CLS slots (one per frame: the port
  engine's count, past the reference engine's 8, at which its
  ``build_rice_batch`` asserts), and the port's ``OVEngine`` runs it end
  to end;
- ``rice_forward`` and ``rice_forward_stats`` within 1e-4 (fp32, two
  blocks), on the port's tile-padded layout against the reference's;
- the Qwen3 decoder (q/k norm, no biases, 1-D rope, head_dim_override)
  and the same widths without q/k norm (biases, an untied head): prefill
  k and logits and a decode step within 1e-4.

The engine is ``tests/test_torch_ov_engine.py``'s.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_ov_params import (  # noqa: F401 (one_thread: autouse fixture)
    EOS,
    configs,
    image,
    one_thread,
    ov_tree,
    port_params,
    video,
)

from visionselector_tpu.models.llava_ov15 import rice as jrice
from visionselector_tpu.models.qwen25vl import lm as jlm
from visionselector_tpu_torch.core.config import TextConfig
from visionselector_tpu_torch.kernels.attention import FLASH_BLOCK
from visionselector_tpu_torch.models.llava_ov15 import model as tmodel
from visionselector_tpu_torch.models.llava_ov15 import rice as trice
from visionselector_tpu_torch.models.qwen25vl import lm as tlm
from visionselector_tpu_torch.models.qwen25vl.weights import lm_from_jax
from visionselector_tpu_torch.preprocess.rope import expand_vision_tokens

ATOL = 1e-4
LONG_CLIP = 10  # temporal groups (RICE's temporal patch is 1): > 8 slots


@pytest.fixture(scope="module")
def weights():
    tree = ov_tree()
    return tree, jax.tree.map(jnp.asarray, tree), port_params(tree)


# -- RICE batch ----------------------------------------------------------


def _batches():
    px, grid = image(112, 140, 0)
    p1, g1 = image(56, 56, 21)
    p2, g2 = image(56, 84, 22)
    vpx, vgrid = video()
    lpx, lgrid = video(frames=LONG_CLIP)
    return {
        "image, exact length": (px, grid, None, None),
        "image, bucket and slots": (px, grid, 256, 8),
        "two images": (np.concatenate([p1, p2]), np.concatenate([g1, g2]),
                       128, 8),
        "video frames": (vpx, vgrid, 256, 8),
        # one CLS slot per frame, as the port's engine allots
        "video of 10 groups": (lpx, lgrid, 256, LONG_CLIP),
    }


@pytest.mark.parametrize("case", list(_batches()))
def test_rice_batch_maps_bit_equal(case):
    px, grid, pad_to, slots = _batches()[case]
    want = jrice.build_rice_batch(px, grid, pad_to=pad_to, cls_slots=slots)
    got = trice.build_rice_batch(px, grid, pad_to=pad_to, cls_slots=slots)
    for name in ("pixel_values", "rot_pos_ids", "insert_map", "strip_map",
                 "seg_ids", "grid_thw"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert (got.num_patches, got.num_merged) == (want.num_patches,
                                                 want.num_merged)


def test_rice_batch_tile_padding_appends_dead_rows():
    """``tile``: S' rounded up to the kernel's tile with zero-row sentinels
    of segment 0; the maps before them are the reference's, and the bounds
    cover every 64-row tile."""
    px, grid = image(112, 140, 0)
    ref = trice.build_rice_batch(px, grid, pad_to=256, cls_slots=8)
    got = trice.build_rice_batch(px, grid, pad_to=256, cls_slots=8,
                                 tile=FLASH_BLOCK)
    sp = len(ref.seg_ids)  # 264
    assert sp % FLASH_BLOCK and len(got.seg_ids) % FLASH_BLOCK == 0
    np.testing.assert_array_equal(got.insert_map[:sp], ref.insert_map)
    np.testing.assert_array_equal(got.seg_ids[:sp], ref.seg_ids)
    assert (got.insert_map[sp:] == 256 + 1).all()
    assert (got.seg_ids[sp:] == 0).all()
    np.testing.assert_array_equal(got.strip_map, ref.strip_map)
    assert ref.kv_bounds is None
    assert got.kv_bounds.shape == (len(got.seg_ids) // FLASH_BLOCK, 2)


def _rice_inputs(case, tile):
    px, grid, pad_to, slots = _batches()[case]
    rb = trice.build_rice_batch(px, grid, pad_to=pad_to, cls_slots=slots,
                                tile=tile)
    return rb, dict(
        pixel_values=torch.from_numpy(rb.pixel_values),
        rot_pos_ids=torch.from_numpy(rb.rot_pos_ids),
        insert_map=torch.from_numpy(rb.insert_map),
        strip_map=torch.from_numpy(rb.strip_map),
        seg_ids=torch.from_numpy(rb.seg_ids),
        kv_bounds=(None if rb.kv_bounds is None
                   else torch.from_numpy(rb.kv_bounds)))


def _jax_rice(jp, case, stats=False):
    px, grid, pad_to, slots = _batches()[case]
    rb = jrice.build_rice_batch(px, grid, pad_to=pad_to, cls_slots=slots)
    fn = jrice.rice_forward_stats if stats else jrice.rice_forward
    out = fn(jp["visual"], jnp.asarray(rb.pixel_values),
             jnp.asarray(rb.rot_pos_ids), jnp.asarray(rb.insert_map),
             jnp.asarray(rb.strip_map), jnp.asarray(rb.seg_ids),
             configs()[0].vision)
    return [np.asarray(o) for o in out] if stats else np.asarray(out)


@pytest.mark.parametrize("case", ["image, bucket and slots", "two images",
                                  "video frames", "video of 10 groups"])
def test_rice_forward_matches_jax(weights, case):
    """Merged tokens of the real patches within 1e-4, on the port's
    tile-padded layout (bounds at the kernel's tile) against the
    reference's unpadded one."""
    _, jp, tp = weights
    want = _jax_rice(jp, case)
    rb, inputs = _rice_inputs(case, FLASH_BLOCK)
    got = trice.rice_forward(tp.visual, **inputs).numpy()
    n = rb.num_merged
    assert got.shape == want.shape
    np.testing.assert_allclose(got[:n], want[:n], atol=ATOL, rtol=0)


def test_rice_forward_stats_matches_jax(weights):
    """Merged tokens, each merged token's received attention mass and its
    pooled last-block keys within 1e-4."""
    _, jp, tp = weights
    case = "two images"
    want = _jax_rice(jp, case, stats=True)
    rb, inputs = _rice_inputs(case, FLASH_BLOCK)
    got = [x.numpy() for x in trice.rice_forward_stats(tp.visual, **inputs)]
    n = rb.num_merged
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[:n], w[:n], atol=ATOL, rtol=0)
    # the stats path's merged tokens are rice_forward's
    np.testing.assert_allclose(
        got[0][:n], trice.rice_forward(tp.visual, **inputs).numpy()[:n],
        atol=1e-6, rtol=0)


def test_engine_runs_a_clip_of_more_than_8_groups(weights):
    """The port's ``OVEngine`` on a clip of 10 temporal groups: its RICE
    batch holds one CLS slot per frame (10; the reference engine allots
    ``max(len(grid_thw), 8)`` = 8 and its ``build_rice_batch`` asserts),
    with the maps of the reference's ``build_rice_batch`` at the same
    explicit slots (before the kernel-tile padding); 4 greedy tokens and
    finite logits from the selector request."""
    _, _, tp = weights
    cfg = configs()[1]
    lpx, lgrid = video(frames=LONG_CLIP)
    assert int(lgrid[:, 0].sum()) == LONG_CLIP > 8
    with pytest.raises(AssertionError):  # the reference engine's slots
        jrice.build_rice_batch(lpx, lgrid, pad_to=256,
                               cls_slots=max(len(lgrid), 8))
    ids = expand_vision_tokens([100, 200], [300, 420], lgrid,
                               image_token_id=cfg.video_token_id)
    eng = tmodel.OVEngine(cfg, tp, use_selector=True, budget=0.3,
                          device="cpu")
    _, prep = eng._prepared(ids, None, None, lpx, lgrid)
    rb = prep.rb
    cls = rb.insert_map == prep.s_bucket  # the CLS sentinel row
    assert int(cls.sum()) == LONG_CLIP
    want = jrice.build_rice_batch(lpx, lgrid, pad_to=prep.s_bucket,
                                  cls_slots=LONG_CLIP)
    sp = len(want.seg_ids)
    for name in ("insert_map", "seg_ids"):
        np.testing.assert_array_equal(getattr(rb, name)[:sp],
                                      getattr(want, name), err_msg=name)
    np.testing.assert_array_equal(rb.strip_map, want.strip_map)
    res = eng.generate(input_ids=ids, pixel_values_videos=lpx,
                       video_grid_thw=lgrid,
                       second_per_grid_ts=np.array([1.0]),
                       max_new_tokens=4, eos_token_ids=EOS)
    assert len(res.tokens) == 4
    assert res.num_vision_tokens == want.num_merged == prep.n
    assert torch.isfinite(res.logits).all()


# -- Qwen3 text model ----------------------------------------------------


def _text_cfgs(qk_norm: bool):
    """(JAX, port) text configs: the OV Qwen3 decoder, or the same widths
    with q/k norm off (biases on, 1-D rope kept)."""
    jcfg, tcfg = configs()
    if qk_norm:
        return jcfg.text, tcfg.text
    kw = dict(qk_norm=False, attention_bias=True, tie_word_embeddings=False)
    return (dataclasses.replace(jcfg.text, **kw),
            dataclasses.replace(tcfg.text, **kw))


@pytest.fixture(scope="module", params=[True, False], ids=["qk_norm",
                                                          "no_qk_norm"])
def decoder(request):
    from visionselector_tpu.models.qwen25vl.lm import init_lm_params

    jtext, ttext = _text_cfgs(request.param)
    shapes = jax.eval_shape(lambda k: init_lm_params(k, jtext),
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(3)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("_scale']"):  # non-trivial norm scales
            return (1 + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        return (rng.randn(*leaf.shape) * 0.1).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    t, valid = 24, 19
    embeds = rng.randn(1, t, jtext.hidden_size).astype(np.float32)
    pos = np.tile(np.arange(t), (3, 1))[:, None]
    seg = (np.arange(t) < valid).astype(np.int32)[None]
    return dict(jtext=jtext, ttext=ttext, jp=jax.tree.map(jnp.asarray, tree),
                lm=lm_from_jax(tree, ttext, "cpu", torch.float32),
                embeds=embeds, pos=pos, seg=seg, valid=valid)


def test_qwen3_flags_build_the_layer(decoder):
    layer = decoder["lm"].layers[0]
    names = {n for n, _ in layer.named_parameters()}
    qk = decoder["ttext"].qk_norm
    assert ("q_norm_scale" in names) == qk and ("q_bias" in names) != qk
    assert tlm.mrope_axis_selector(decoder["ttext"]).eq(0).all()


def test_qwen3_prefill_logits_match_jax(decoder):
    d = decoder
    jh, (jk, _) = jlm.lm_prefill(d["jp"], jnp.asarray(d["embeds"]),
                                 jnp.asarray(d["pos"]), jnp.asarray(d["seg"]),
                                 d["jtext"])
    th, (tk, _) = tlm.lm_prefill(d["lm"], torch.from_numpy(d["embeds"]),
                                 torch.from_numpy(d["pos"]),
                                 torch.from_numpy(d["seg"]))
    v = d["valid"]
    np.testing.assert_allclose(tk.numpy()[:, :, :v], np.asarray(jk)[:, :, :v],
                               atol=ATOL, rtol=0)
    want = jlm.lm_head(d["jp"], jh[0, :v], d["jtext"])
    got = tlm.lm_head(d["lm"], th[0, :v])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_qwen3_decode_step_matches_jax(decoder):
    """One decode step at position ``valid`` after the prefill's cache
    (the port writes the row in place)."""
    d = decoder
    v, t_max = d["valid"], 32
    _, (jk, jv) = jlm.lm_prefill(d["jp"], jnp.asarray(d["embeds"]),
                                 jnp.asarray(d["pos"]), jnp.asarray(d["seg"]),
                                 d["jtext"])
    pad = ((0, 0), (0, 0), (0, t_max - jk.shape[2]), (0, 0), (0, 0))
    nl = d["jtext"].num_hidden_layers
    jcache = jlm.KVCache(k=jnp.pad(jk, pad), v=jnp.pad(jv, pad),
                         length=jnp.full((nl, 1), v, jnp.int32))
    x = np.random.RandomState(9).randn(1, 1, d["jtext"].hidden_size
                                       ).astype(np.float32)
    pos3 = np.full((3, 1, 1), v, np.int64)
    jh, _ = jlm.lm_decode_step(d["jp"], jcache, jnp.asarray(x),
                               jnp.asarray(pos3), d["jtext"])
    tcache = tlm.KVCache(k=torch.from_numpy(np.asarray(jcache.k)).clone(),
                         v=torch.from_numpy(np.asarray(jcache.v)).clone(),
                         length=torch.full((nl, 1), v, dtype=torch.int64))
    th, tcache = tlm.lm_decode_step(d["lm"], tcache, torch.from_numpy(x),
                                    torch.from_numpy(pos3))
    np.testing.assert_allclose(
        tlm.lm_head(d["lm"], th[0, 0]).numpy(),
        np.asarray(jlm.lm_head(d["jp"], jh[0, 0], d["jtext"])), atol=ATOL,
        rtol=0)
    assert int(tcache.length[0, 0]) == v + 1


def test_moe_text_model_is_refused():
    """A text config with ``num_experts`` builds the MoE decoder: each
    layer holds the router and the stacked experts in the reference's
    layout and no dense MLP kernel, and a prefill runs (finite, the
    input's shape)."""
    cfg = TextConfig(num_experts=4, num_hidden_layers=1, hidden_size=32,
                     intermediate_size=64, num_attention_heads=2,
                     num_key_value_heads=1, vocab_size=64,
                     num_experts_per_tok=2, moe_intermediate_size=16,
                     mrope=False)
    lm = tlm.init_lm_params(cfg, torch.Generator().manual_seed(0), "cpu",
                            torch.float32)
    shapes = {n: tuple(p.shape) for n, p in lm.layers[0].named_parameters()}
    assert shapes["router_kernel"] == (32, 4)
    assert shapes["expert_gate_kernel"] == shapes["expert_up_kernel"] == (
        4, 32, 16)
    assert shapes["expert_down_kernel"] == (4, 16, 32)
    assert not {"gate_kernel", "up_kernel", "down_kernel"} & set(shapes)
    x = torch.randn(1, 5, 32, generator=torch.Generator().manual_seed(1))
    h, (k, _) = tlm.lm_prefill(lm, x, torch.arange(5).expand(3, 1, 5),
                               torch.ones(1, 5, dtype=torch.int32))
    assert h.shape == x.shape and torch.isfinite(h).all()
    assert k.shape == (1, 1, 5, 1, 16)
