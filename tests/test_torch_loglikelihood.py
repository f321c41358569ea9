"""Scoring through the port against ``visionselector_tpu`` on qwen25vl_tiny
with the same weights (``from_jax_params``; the scorer at std 0.02 so the
kept set is not decided by fp32 noise): ``QwenVLEngine.loglikelihood``
(text-only, and one image with the selector and with ``orig``),
``run_loglikelihood_choices`` (one prefill, one chunked decode forward per
choice) and ``lm.lm_decode_chunk`` over fp32, bf16 and int8 caches. The
JAX side runs as ``tests/test_eval.py`` runs it (XLA attention on the
CPU). Same numpy inputs to both sides; fp32, except the bf16 cache: the
JAX decoder writes rows of the activations' dtype into the cache, so that
case runs bf16 weights and activations on both sides.

Tolerances: 1e-4 on a summed log-likelihood (sums of up to 20 fp32
log-probs of magnitude ~12) and on hidden states; in bf16, 4 bf16 ulps of
each row's largest |value| (XLA keeps fused elementwise chains in fp32
where PyTorch rounds each op to bf16: 1 ulp measured); a choice scored by the
chunk against the per-pair full prefill within 2e-3 on ``orig``, the JAX
test's own bound (``tests/test_eval.py:744``); the chunk path in reverse
choice order exactly equal (each choice rewrites every cache row it
reads)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_params import jax_param_tree

from visionselector_tpu.core.config import qwen25vl_tiny as jax_tiny
from visionselector_tpu.models.qwen25vl import lm as jlm
from visionselector_tpu.models.qwen25vl import model as jmodel
from visionselector_tpu.preprocess.image import preprocess_image
from visionselector_tpu.preprocess.rope import expand_vision_tokens
from visionselector_tpu_torch.core.config import qwen25vl_tiny
from visionselector_tpu_torch.models.qwen25vl import lm as tlm
from visionselector_tpu_torch.models.qwen25vl import model as tmodel
from visionselector_tpu_torch.models.qwen25vl.weights import from_jax_params

ATOL = 1e-4
PAIR_ATOL = 2e-3
BUDGET = 0.5
# choices of 1, 5, 12 and 20 ids: c_max 32, two 16-row groups
CHOICES = [np.arange(n) + 700 + 50 * i for i, n in enumerate((1, 5, 12, 20))]


@pytest.fixture(scope="module")
def engines():
    """{use_selector: (JAX engine, port engine)} on the same weights."""
    jcfg = jax_tiny()
    tree = jax_param_tree(jcfg, seed=0, scorer_std=0.02)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = from_jax_params(tree, qwen25vl_tiny(), "cpu")
    return {sel: (jmodel.QwenVLEngine(jcfg, jparams, use_selector=sel,
                                      budget=BUDGET),
                  tmodel.QwenVLEngine(qwen25vl_tiny(), tparams,
                                      use_selector=sel, budget=BUDGET,
                                      device="cpu"))
            for sel in (True, False)}


@pytest.fixture(scope="module")
def image_request():
    rng = np.random.RandomState(1)
    img = (rng.rand(112, 140, 3) * 255).astype(np.uint8)
    px, grid = preprocess_image(img, min_pixels=1, max_pixels=10**9)
    ids = expand_vision_tokens([100, 200, 300], [400, 500, 600], grid)
    return ids, dict(pixel_values=px, grid_thw=grid)


def _continuations(teng, ids, vision):
    """The port's own greedy continuation (scored greedy) and a fixed one."""
    greedy = teng.generate(ids, max_new_tokens=3, **vision).tokens
    return {"greedy": np.asarray(greedy), "other": np.arange(11, 16)}


@pytest.mark.parametrize("cont", ["greedy", "other"])
def test_text_loglikelihood_matches_jax(engines, cont):
    jeng, teng = engines[True]
    ctx = np.arange(5, 30)
    c = _continuations(teng, ctx, {})[cont]
    want = jeng.loglikelihood(ctx, c)
    got = teng.loglikelihood(ctx, c)
    assert isinstance(got[0], float) and isinstance(got[1], bool)
    assert abs(got[0] - want[0]) < ATOL, (got, want)
    assert got[1] == want[1] == (cont == "greedy")


@pytest.mark.parametrize("cont", ["greedy", "other"])
@pytest.mark.parametrize("use_selector", [True, False])
def test_image_loglikelihood_matches_jax(engines, image_request, use_selector,
                                         cont):
    """The continuation is scored at the compacted sequence's tail: with
    the selector its positions are those of the compacted length."""
    jeng, teng = engines[use_selector]
    ids, vision = image_request
    c = _continuations(teng, ids, vision)[cont]
    want = jeng.loglikelihood(ids, c, **vision)
    got = teng.loglikelihood(ids, c, **vision)
    assert abs(got[0] - want[0]) < ATOL, (got, want)
    assert got[1] == want[1] == (cont == "greedy")


@pytest.fixture(scope="module")
def choice_scores(engines, image_request):
    """{use_selector: (JAX, port, port in reverse choice order)}."""
    ids, vision = image_request
    out = {}
    for sel, (jeng, teng) in engines.items():
        out[sel] = (
            jmodel.run_loglikelihood_choices(jeng, ids, CHOICES, **vision),
            tmodel.run_loglikelihood_choices(teng, ids, CHOICES, **vision),
            tmodel.run_loglikelihood_choices(teng, ids, CHOICES[::-1],
                                             **vision)[::-1])
    return out


@pytest.mark.parametrize("use_selector", [True, False])
def test_choices_match_jax(choice_scores, use_selector):
    want, got, _ = choice_scores[use_selector]
    assert len(got) == len(CHOICES)
    for (ll_g, gr_g), (ll_w, gr_w) in zip(got, want):
        assert abs(ll_g - ll_w) < ATOL, (got, want)
        assert gr_g == gr_w


@pytest.mark.parametrize("use_selector", [True, False])
def test_choices_reverse_order_equal(choice_scores, use_selector):
    """Every choice starts from the prefill's cache length and rewrites rows
    [base, base + c_max) before reading them: no choice sees another's."""
    _, got, reverse = choice_scores[use_selector]
    assert got == reverse


def test_choices_match_per_pair_on_orig(engines, image_request,
                                        choice_scores):
    """Uncompressed, the chunk's decode positions are the full prefill's."""
    _, teng = engines[False]
    ids, vision = image_request
    for cont, (ll_s, gr_s) in zip(CHOICES, choice_scores[False][1]):
        ll_p, gr_p = teng.loglikelihood(ids, cont, **vision)
        assert abs(ll_s - ll_p) < PAIR_ATOL, (ll_s, ll_p)
        assert gr_s == gr_p


def test_score_chunk_leaves_the_prefix_cache(engines):
    """A choice's chunk writes its rows in place but not the cache length."""
    _, teng = engines[True]
    state = teng.generate(np.arange(5, 20), max_new_tokens=17,
                          eos_token_ids=(-1,), _defer_decode=True)
    before = state.cache.length.clone()
    prefix = state.cache.k[:, :, :int(before[0, 0])].clone()
    tmodel._score_chunk(teng.params, state.cache, torch.arange(1, 17), 16,
                        state.start_pos, state.logits, 16)
    assert torch.equal(state.cache.length, before)
    assert torch.equal(state.cache.k[:, :, :int(before[0, 0])], prefix)


def test_unported_and_invalid_requests_raise(engines, image_request):
    _, teng = engines[True]
    ids, vision = image_request
    px, grid = vision["pixel_values"], vision["grid_thw"]
    with pytest.raises(ValueError):
        teng.loglikelihood(ids, [])
    with pytest.raises(ValueError):
        teng.loglikelihood([], [5])
    # a strategy engine scores nothing, as the reference's (its
    # compression adapters give only generate_until)
    from visionselector_tpu_torch.selector.baselines import get_baseline

    strat = tmodel.QwenVLEngine(qwen25vl_tiny(), teng.params, device="cpu",
                                strategy=get_baseline("visionzip"))
    with pytest.raises(NotImplementedError, match="selector and orig"):
        strat.loglikelihood(ids, [5], px, grid)


# lm_decode_chunk: a prefix of VALID committed rows, t_c rows on top.
T, VALID = 24, 19


@pytest.fixture(scope="module")
def chunk_setup():
    jcfg = jax_tiny()
    tree = jax_param_tree(jcfg, seed=2)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = from_jax_params(tree, qwen25vl_tiny(), "cpu")
    rng = np.random.RandomState(0)
    embeds = rng.randn(1, T, jcfg.text.hidden_size).astype(np.float32) * 0.5
    pos = np.stack([np.arange(T), np.arange(T) // 2 + 3,
                    (np.arange(T) * 7) % 11]).astype(np.int64)[:, None]
    seg = (np.arange(T) < VALID).astype(np.int32)[None]
    _, (jk, jv) = jlm.lm_prefill(jparams["lm"], jnp.asarray(embeds),
                                 jnp.asarray(pos), jnp.asarray(seg),
                                 jcfg.text)
    bf16 = (jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), tree),
            from_jax_params(tree, qwen25vl_tiny(), "cpu").to(torch.bfloat16))
    return dict(cfg=jcfg, fp32=(jparams, tparams), bf16=bf16,
                k=np.asarray(jk), v=np.asarray(jv))


def _chunk_caches(cfg, k, v, t_max, kind):
    """The same committed prefix in a JAX and a port cache of ``kind``
    (fp32, bf16, or int8 with scales)."""
    n_layers = cfg.num_hidden_layers
    full = [np.zeros((n_layers, 1, t_max) + k.shape[3:], np.float32)
            for _ in range(2)]
    full[0][:, :, :T], full[1][:, :, :T] = k, v
    length = np.full((n_layers, 1), VALID, np.int64)
    if kind == "int8":
        (k8, ks), (v8, vs) = (jlm.quantize_kv(jnp.asarray(x)) for x in full)
        jc = jlm.QuantKVCache(k=k8, v=v8, k_scale=ks, v_scale=vs,
                              length=jnp.asarray(length, jnp.int32))
        tc = tlm.QuantKVCache(*(torch.from_numpy(np.array(x))
                                for x in (k8, v8, ks, vs)),
                              length=torch.from_numpy(length))
        return jc, tc
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if kind == "bf16"
                else (jnp.float32, torch.float32))
    jc = jlm.KVCache(k=jnp.asarray(full[0], jdt), v=jnp.asarray(full[1], jdt),
                     length=jnp.asarray(length, jnp.int32))
    tc = tlm.KVCache(k=torch.from_numpy(full[0]).to(tdt),
                     v=torch.from_numpy(full[1]).to(tdt),
                     length=torch.from_numpy(length))
    return jc, tc


def _rows(cache, kind, t_c):
    """The chunk's rows [VALID, VALID + t_c) of the k cache, as fp32."""
    sl = (slice(None), slice(None), slice(VALID, VALID + t_c))
    if kind == "int8":
        return np.asarray(cache.k[sl], np.float32) * np.asarray(
            cache.k_scale[sl], np.float32)[..., None]
    return np.asarray(jnp.asarray(cache.k[sl], jnp.float32))


def _assert_bf16_close(got, want, ulps=4):
    """|got - want| within ``ulps`` bf16 ulps of each row's largest
    |want| (a value in [2^e, 2^(e+1)) has bf16 spacing 2^(e-7))."""
    amax = np.abs(want).max(-1, keepdims=True)
    ulp = np.exp2(np.floor(np.log2(amax)) - 7)
    err = (np.abs(got - want) / ulp).max()
    assert err <= ulps, err


@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("t_c", [1, 4, 16])
def test_lm_decode_chunk_matches_jax(chunk_setup, t_c, kind):
    jcfg = chunk_setup["cfg"]
    jparams, tparams = chunk_setup["bf16" if kind == "bf16" else "fp32"]
    jc, tc = _chunk_caches(jcfg.text, chunk_setup["k"], chunk_setup["v"],
                           T + 16 + 4, kind)
    rng = np.random.RandomState(t_c)
    x = rng.randn(1, t_c, jcfg.text.hidden_size).astype(np.float32)
    pos = np.broadcast_to(30 + np.arange(t_c), (3, 1, t_c)).astype(np.int64)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if kind == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    jh, jc2 = jlm.lm_decode_chunk(jparams["lm"], jc, jx, jnp.asarray(pos),
                                  jcfg.text)
    th, tc2 = tlm.lm_decode_chunk(tparams.lm, tc, tx, torch.from_numpy(pos))
    want = np.asarray(jnp.asarray(jh, jnp.float32))
    if kind == "bf16":
        _assert_bf16_close(th.float().numpy(), want)
    else:
        np.testing.assert_allclose(th.numpy(), want, atol=ATOL, rtol=0)
    assert tc2.k is tc.k and tc2.v is tc.v  # written in place
    assert tc2.length.tolist() == np.asarray(jc2.length).tolist()
    assert tc.length.tolist() == [[VALID]] * jcfg.text.num_hidden_layers
    tk = tc.k[:, :, VALID:VALID + t_c].float()
    if kind == "int8":
        tk = tk * tc.k_scale[:, :, VALID:VALID + t_c, :, None]
    if kind == "bf16":
        _assert_bf16_close(tk.numpy(), _rows(jc2, kind, t_c))
    else:
        np.testing.assert_allclose(tk.numpy(), _rows(jc2, kind, t_c),
                                   atol=ATOL, rtol=0)


def test_decode_step_is_a_one_row_chunk(chunk_setup):
    """lm_decode_step takes the chunk path with t_c = 1: the same hidden
    states and rows bit for bit."""
    jcfg, (_, tparams) = chunk_setup["cfg"], chunk_setup["fp32"]
    jk, jv = chunk_setup["k"], chunk_setup["v"]
    x = torch.from_numpy(np.random.RandomState(7).randn(
        1, 1, jcfg.text.hidden_size).astype(np.float32))
    pos = torch.full((3, 1, 1), 31)
    outs = []
    for fn in (tlm.lm_decode_step, tlm.lm_decode_chunk):
        _, tc = _chunk_caches(jcfg.text, jk, jv, T + 4, "fp32")
        h, tc2 = fn(tparams.lm, tc, x, pos)
        outs.append((h, dataclasses.astuple(tc2)))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)
