"""Quantized decoders through the port's engines and serving paths, on the
4-layer tiny configs of both families (fp32, the same numpy weights given
to both packages, each package quantizing them itself).

- ``QwenVLEngine`` / ``OVEngine`` generate under ``int8`` and the grouped
  int4 spec (``int4:g24`` for Qwen2.5-VL, hidden / 4; ``int4:g32`` for
  LLaVA-OneVision-1.5, whose o kernel's 128-wide input 24 does not
  divide) against the JAX engine on its own quantized tree: selected
  indices bit-equal, first-token logits within 1e-4 (fp32 through ViT and
  decoder), 8 greedy tokens equal.
- The paths that must carry the quantized weights unchanged, each against
  the same quantized engine's one-shot ``generate`` (or its per-choice
  ``loglikelihood``): ``generate_batch``, ``ContinuousBatcher`` over
  ``int4:g24`` with a bf16 / fp32, int8 and int4 pool (the reference's
  ``test_int4_lm_serves_like_its_oracle``; a quantized pool's later tokens
  drift from one-shot, so those hold the first token and the count),
  speculative decoding, ``run_loglikelihood_choices`` (1e-4 nats), and
  FastV's two-stage prefill (``layer_qk`` reads q / k through ``_dense``)
  against the JAX engine's tokens."""

import concurrent.futures as cf
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_ov_params import ov_tree, requests as ov_requests
from torch_serving_params import (  # noqa: F401 (one_thread: autouse)
    four_layers,
    one_thread,
    serving_tree,
)

from visionselector_tpu.core.config import llava_ov_tiny as jax_ov_tiny
from visionselector_tpu.core.config import qwen25vl_tiny as jax_tiny
from visionselector_tpu.models.llava_ov15 import model as jov
from visionselector_tpu.models.qwen25vl import lm as jlm
from visionselector_tpu.models.qwen25vl import model as jmodel
from visionselector_tpu.selector import baselines as jbase
from visionselector_tpu_torch.core.config import llava_ov_tiny, qwen25vl_tiny
from visionselector_tpu_torch.kernels import wq_matmul as wq
from visionselector_tpu_torch.models.llava_ov15 import model as tov
from visionselector_tpu_torch.models.llava_ov15.weights import (
    ov_from_jax_params,
)
from visionselector_tpu_torch.models.qwen25vl import lm as tlm
from visionselector_tpu_torch.models.qwen25vl import model as tmodel
from visionselector_tpu_torch.models.qwen25vl.continuous import (
    ContinuousBatcher,
)
from visionselector_tpu_torch.models.qwen25vl.weights import from_jax_params
from visionselector_tpu_torch.preprocess.image import preprocess_image
from visionselector_tpu_torch.preprocess.rope import expand_vision_tokens
from visionselector_tpu_torch.selector import baselines as tbase

EOS = (-1,)
NEW_TOKENS = 8
TIMEOUT = 300
GROUPED = {"qwen25vl": "int4:g24", "llava_ov15": "int4:g32"}


def _qwen_request(seed=0, question=(8, 9, 10)):
    img = (np.random.RandomState(seed).rand(56, 84, 3) * 255).astype(
        np.uint8)
    px, grid = preprocess_image(img)
    return dict(input_ids=expand_vision_tokens([5, 6, 7], list(question),
                                               grid),
                pixel_values=px, grid_thw=grid)


@functools.lru_cache(maxsize=None)
def _quantized(family, spec):
    """(JAX config, port config, JAX parameters, port parameters) of the
    same 4-layer weights, each package quantizing them with ``spec``;
    made once and shared by the module's engines, which only read them."""
    if family == "qwen25vl":
        jcfg, tcfg = four_layers(jax_tiny()), four_layers(qwen25vl_tiny())
        tree = serving_tree(jcfg, seed=1, scorer_std=0.02)
        tparams = from_jax_params(tree, tcfg, "cpu")
    else:
        jcfg, tcfg = four_layers(jax_ov_tiny()), four_layers(llava_ov_tiny())
        tree = ov_tree(layers=4, seed=1)
        tparams = ov_from_jax_params(tree, tcfg, "cpu")
    jparams = jlm.apply_weight_quantization(
        jax.tree.map(jnp.asarray, tree), spec)
    tlm.apply_weight_quantization(tparams, spec)
    return jcfg, tcfg, jparams, tparams


def _engines(family, spec, **kw):
    """(JAX engine, port engine) over ``_quantized(family, spec)``."""
    jcfg, tcfg, jparams, tparams = _quantized(family, spec)
    if family == "qwen25vl":
        jE, tE = jmodel.QwenVLEngine, tmodel.QwenVLEngine
    else:
        jE, tE = jov.OVEngine, tov.OVEngine
    jkw = dict(kw)
    if "strategy" in kw:
        name, target = kw["strategy"]
        jkw["strategy"] = jbase.get_baseline(name, target_layer=target)
        kw["strategy"] = tbase.get_baseline(name, target_layer=target)
    return jE(jcfg, jparams, **jkw), tE(tcfg, tparams, device="cpu", **kw)


def _request(family):
    if family == "qwen25vl":
        return _qwen_request()
    return ov_requests()["image"]


@pytest.mark.parametrize("family, spec", [
    ("qwen25vl", "int8"), ("qwen25vl", GROUPED["qwen25vl"]),
    ("llava_ov15", "int8"), ("llava_ov15", GROUPED["llava_ov15"])])
def test_generate_matches_jax_engine(family, spec):
    jeng, teng = _engines(family, spec, use_selector=True, budget=0.5)
    r = _request(family)
    want = jeng.generate(**r, max_new_tokens=NEW_TOKENS, eos_token_ids=EOS)
    got = teng.generate(**r, max_new_tokens=NEW_TOKENS, eos_token_ids=EOS)
    np.testing.assert_array_equal(got.selected_indices,
                                  want.selected_indices)
    state = jeng.generate(**r, max_new_tokens=2, eos_token_ids=EOS,
                          _defer_decode=True)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(state.logits),
                               atol=1e-4, rtol=0)
    assert got.tokens == [int(t) for t in want.tokens]
    assert len(got.tokens) == NEW_TOKENS and len(set(got.tokens)) > 1


@pytest.fixture(scope="module")
def qeng():
    """The port's Qwen engine over ``int4:g24`` weights (selector 0.5)."""
    return _engines("qwen25vl", GROUPED["qwen25vl"], use_selector=True,
                    budget=0.5)[1]


def _reqs():
    return [(_qwen_request(1, (8,)), 6), (_qwen_request(1, (9, 11)), 4),
            (dict(input_ids=np.arange(40, 50, dtype=np.int64)), 8)]


@pytest.mark.parametrize("kv_quant", [None, "int8", "int4"])
def test_batcher_serves_like_one_shot(qeng, kv_quant):
    reqs = _reqs()
    want = [qeng.generate(**r, max_new_tokens=m, eos_token_ids=EOS).tokens
            for r, m in reqs]
    bat = ContinuousBatcher(qeng, n_slots=2, t_max=128, chunk=4,
                            kv_quant=kv_quant)
    try:
        with cf.ThreadPoolExecutor(max_workers=len(reqs)) as ex:
            futs = [ex.submit(bat.submit, r, m, EOS) for r, m in reqs]
            results = [f.result(timeout=TIMEOUT) for f in futs]
    finally:
        bat.shutdown()
    for res, w, (_, m) in zip(results, want, reqs):
        assert len(res.tokens) == m
        if kv_quant is None:
            assert res.tokens == w
        else:
            assert res.tokens[0] == w[0]


def test_generate_batch_and_speculative(qeng):
    """``generate_batch`` rows and prompt-lookup speculative decoding give
    each request's own greedy tokens."""
    reqs = _reqs()
    want = [qeng.generate(**r, max_new_tokens=6, eos_token_ids=EOS).tokens
            for r, _ in reqs]
    got = qeng.generate_batch([r for r, _ in reqs], max_new_tokens=6,
                              eos_token_ids=EOS)
    assert [g.tokens for g in got] == want
    for (r, _), w in zip(reqs, want):
        res = tmodel.generate_speculative(qeng, **r, max_new_tokens=6,
                                          propose_len=3, eos_token_ids=EOS)
        assert res.tokens == w


def test_choices_match_per_choice_loglikelihood():
    """``run_loglikelihood_choices`` on a quantized ``orig`` engine (one
    prefill, then one decode chunk per choice) against each choice's own
    full-prefill ``loglikelihood``."""
    _, eng = _engines("qwen25vl", "int8", use_selector=False)
    r = _qwen_request(2)
    choices = [np.array([11]), np.array([12, 13, 14]), np.array([15, 16])]
    got = tmodel.run_loglikelihood_choices(eng, r["input_ids"], choices,
                                           pixel_values=r["pixel_values"],
                                           grid_thw=r["grid_thw"])
    for (ll, greedy), c in zip(got, choices):
        want_ll, want_greedy = eng.loglikelihood(r["input_ids"], c,
                                                 r["pixel_values"],
                                                 r["grid_thw"])
        assert abs(ll - want_ll) < 1e-4 * len(c) and greedy == want_greedy


def test_fastv_two_stage_prefill_matches_jax():
    """FastV at target layer 2 on a quantized decoder: stage A, ``layer_qk``
    of the capture layer (its q / k kernels quantized), stage B, then
    decode, against the JAX engine's tokens and kept count."""
    jeng, teng = _engines("qwen25vl", GROUPED["qwen25vl"], use_selector=False,
                          budget=0.5, strategy=("fastv", 2))
    r = _qwen_request(3)
    want = jeng.generate(**r, max_new_tokens=NEW_TOKENS, eos_token_ids=EOS)
    got = teng.generate(**r, max_new_tokens=NEW_TOKENS, eos_token_ids=EOS)
    assert got.tokens == [int(t) for t in want.tokens]
    assert got.prefill_len == want.prefill_len


def test_decode_rows_take_the_plain_route_on_the_cpu(qeng):
    """On CPU tensors every quantized product is the plain version: no
    kernel launch and no dequantize-route count."""
    before = (wq.WQ_LAUNCHES, wq.WQ_DEQUANT_CALLS)
    qeng.generate(**_qwen_request(), max_new_tokens=3, eos_token_ids=EOS)
    assert (wq.WQ_LAUNCHES, wq.WQ_DEQUANT_CALLS) == before
