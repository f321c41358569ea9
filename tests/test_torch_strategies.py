"""The training-free strategies through the whole engine: every registered
baseline on the port's ``QwenVLEngine(strategy=...)`` against the JAX
package's engine with the same weights (``from_jax_params``) and the same
request, on the tiny config with 4 decoder layers and target layer 2 (no
index out of range). Selected indices, ``prefill_len`` and 8 greedy tokens
must be equal, the first-token logits within 1e-4 (fp32 throughout), the
LLM-side cache's per-layer lengths and decode start those of the
reference. Also: FastV at budget 1.0 gives ``orig``'s tokens, an
out-of-range target raises, scoring refuses a strategy, the batcher serves
a FastV engine, and the CLIs take ``--method <baseline>``."""

import dataclasses
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_port_params import jax_param_tree

from visionselector_tpu.core.config import qwen25vl_tiny as jax_tiny
from visionselector_tpu.models.qwen25vl import model as jmodel
from visionselector_tpu.preprocess.image import preprocess_image
from visionselector_tpu.preprocess.rope import expand_vision_tokens
from visionselector_tpu.selector import baselines as jbase
from visionselector_tpu.selector.baselines.dynamic import (
    init_predictor_params,
)
from visionselector_tpu_torch.core.config import qwen25vl_tiny
from visionselector_tpu_torch.models.qwen25vl import model as tmodel
from visionselector_tpu_torch.models.qwen25vl.weights import (
    from_jax_params,
    predictor_from_jax,
)
from visionselector_tpu_torch.selector import baselines as tbase

NEW_TOKENS = 8
TARGET = 2
METHODS = ("visionzip", "prumerge_plus", "divprune", "holov", "random",
           "fastv", "dart", "dynamic")


def four_layers(cfg):
    return dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, num_hidden_layers=4))


@pytest.fixture(scope="module")
def weights():
    cfg = four_layers(jax_tiny())
    tree = jax_param_tree(cfg, seed=3)
    jparams = jax.tree.map(jnp.asarray, tree)
    pred = jax.tree.map(np.asarray, init_predictor_params(
        jax.random.PRNGKey(0), cfg.text.hidden_size))
    return (cfg, jparams, four_layers(qwen25vl_tiny()),
            from_jax_params(tree, four_layers(qwen25vl_tiny()), "cpu"), pred)


def _request(hw=(224, 280), seed=7):
    rng = np.random.RandomState(seed)
    img = (rng.rand(*hw, 3) * 255).astype(np.uint8)
    px, grid = preprocess_image(img, min_pixels=1, max_pixels=10**9)
    ids = expand_vision_tokens([100, 200, 300], [400, 500, 600, 700], grid)
    return ids, px, grid


def _strategies(name, pred):
    if name == "dynamic":
        return (jbase.get_baseline(name, predictor_params=pred),
                tbase.get_baseline(name, predictor=predictor_from_jax(
                    pred, "cpu")))
    kw = {"target_layer": TARGET} if name in ("fastv", "dart") else {}
    return jbase.get_baseline(name, **kw), tbase.get_baseline(name, **kw)


def _jax_generate(jeng, ids, px, grid):
    """The JAX engine's prefill state, its cache lengths (read before the
    decode loop donates the cache) and its greedy tokens."""
    state = jeng.generate(ids, px, grid, max_new_tokens=NEW_TOKENS,
                          _defer_decode=True)
    lengths = np.asarray(state.cache.length)
    tokens = jmodel._run_decode_loop(
        jeng.params, jeng.cfg, state.cache, jnp.asarray(state.next_token),
        state.start_pos, (jeng.cfg.eos_token_id,), NEW_TOKENS)
    return state, lengths, tokens


@pytest.mark.parametrize("name", METHODS)
def test_strategy_engine_matches_jax(weights, name):
    jcfg, jparams, tcfg, tparams, pred = weights
    ids, px, grid = _request()
    jstrat, tstrat = _strategies(name, pred)
    jeng = jmodel.QwenVLEngine(jcfg, jparams, use_selector=False,
                               strategy=jstrat)
    want, want_lengths, want_tokens = _jax_generate(jeng, ids, px, grid)
    teng = tmodel.QwenVLEngine(tcfg, tparams, strategy=tstrat, device="cpu")
    assert not teng.use_selector
    state = teng.generate(ids, px, grid, max_new_tokens=NEW_TOKENS,
                          _defer_decode=True)
    got = state.result
    np.testing.assert_array_equal(got.selected_indices,
                                  want.result.selected_indices)
    assert got.prefill_len == want.result.prefill_len
    assert got.num_vision_tokens == want.result.num_vision_tokens
    assert state.start_pos == want.start_pos
    np.testing.assert_array_equal(state.cache.length.numpy(), want_lengths)
    np.testing.assert_allclose(state.logits.numpy(), np.asarray(want.logits),
                               atol=1e-4, rtol=0)
    res = teng.generate(ids, px, grid, max_new_tokens=NEW_TOKENS)
    assert res.tokens == [int(t) for t in want_tokens]
    assert len(res.tokens) == NEW_TOKENS
    n = got.num_vision_tokens
    if getattr(tstrat, "llm_side", False):
        # layers [0, target) hold the whole sequence, the rest the kept one;
        # decode continues at the original sequence's next position
        t_orig = len(ids)
        assert state.cache.length[:TARGET].eq(t_orig).all()
        assert state.cache.length[TARGET:].eq(got.prefill_len).all()
        assert got.prefill_len == len(ids) - n + len(got.selected_indices)
    assert 0 < len(got.selected_indices) < n


@pytest.mark.parametrize("name", ["visionzip", "fastv"])
def test_strategy_repetition_penalty_matches_jax(weights, name):
    """The penalty re-picks the first token from the strategy path's own
    prefill logits (stage B's on the LLM-side path), then penalizes every
    decode step, as the reference does."""
    jcfg, jparams, tcfg, tparams, pred = weights
    ids, px, grid = _request()
    jstrat, tstrat = _strategies(name, pred)
    want = jmodel.QwenVLEngine(jcfg, jparams, use_selector=False,
                               strategy=jstrat).generate(
        ids, px, grid, max_new_tokens=NEW_TOKENS, repetition_penalty=5.0)
    got = tmodel.QwenVLEngine(tcfg, tparams, strategy=tstrat,
                              device="cpu").generate(
        ids, px, grid, max_new_tokens=NEW_TOKENS, repetition_penalty=5.0)
    assert got.tokens == [int(t) for t in want.tokens]
    assert len(set(got.tokens)) > 1


def test_fastv_full_budget_is_orig(weights):
    """FastV keeping every image token computes ``orig``'s function (the
    stage-B gather is the identity on the valid prefix)."""
    _, _, tcfg, tparams, _ = weights
    ids, px, grid = _request()
    orig = tmodel.QwenVLEngine(tcfg, tparams, use_selector=False,
                               device="cpu")
    fastv = tmodel.QwenVLEngine(tcfg, tparams, budget=1.0,
                                strategy=tbase.get_baseline("fastv"),
                                device="cpu")
    want = orig.generate(ids, px, grid, max_new_tokens=NEW_TOKENS)
    got = fastv.generate(ids, px, grid, max_new_tokens=NEW_TOKENS)
    assert got.tokens == want.tokens
    assert got.prefill_len == want.prefill_len
    np.testing.assert_array_equal(got.selected_indices,
                                  np.arange(got.num_vision_tokens))
    np.testing.assert_allclose(got.logits.numpy(), want.logits.numpy(),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("name,target", [("fastv", 5), ("fastv", 0),
                                         ("dart", 4), ("dynamic", 4)])
def test_out_of_range_target_raises(weights, name, target):
    """The capture layer must exist: FastV reads layer target - 1, DART and
    Dynamic-Qwen layer target. The reference clamps such an index; the
    port raises."""
    _, _, tcfg, tparams, _ = weights
    ids, px, grid = _request((112, 112))
    eng = tmodel.QwenVLEngine(
        tcfg, tparams, strategy=tbase.get_baseline(name, target_layer=target),
        device="cpu")
    with pytest.raises(ValueError, match="outside the 4-layer decoder"):
        eng.generate(ids, px, grid, max_new_tokens=2)


def test_fastv_at_the_last_layer_runs(weights):
    """FastV with target = n reads layer n - 1 and runs no stage-B layer:
    in range, so it runs, and its cache holds the whole sequence in every
    layer."""
    _, _, tcfg, tparams, _ = weights
    ids, px, grid = _request((112, 112))
    eng = tmodel.QwenVLEngine(
        tcfg, tparams, strategy=tbase.get_baseline("fastv", target_layer=4),
        device="cpu")
    state = eng.generate(ids, px, grid, max_new_tokens=3, _defer_decode=True)
    assert state.cache.length.eq(len(ids)).all()
    assert len(eng.generate(ids, px, grid, max_new_tokens=3).tokens) == 3


def test_strategy_refusals(weights):
    _, _, tcfg, tparams, _ = weights
    ids, px, grid = _request((112, 112))
    eng = tmodel.QwenVLEngine(tcfg, tparams,
                              strategy=tbase.get_baseline("visionzip"),
                              device="cpu")
    with pytest.raises(NotImplementedError):
        eng.loglikelihood(ids, [5, 6], px, grid)
    with pytest.raises(NotImplementedError):
        tmodel.run_loglikelihood_choices(eng, ids, [[5], [6]],
                                         pixel_values=px, grid_thw=grid)
    for variant in ("fused", "packed"):
        with pytest.raises(ValueError, match="default attention route"):
            tmodel.QwenVLEngine(tcfg, tparams, attn_variant=variant,
                                strategy=tbase.get_baseline("fastv"),
                                device="cpu")
    with pytest.raises(KeyError):
        tbase.get_baseline("nope")
    assert tbase.available_baselines() == jbase.available_baselines()
    from visionselector_tpu_torch.api import predict, run_eval

    for methods in (run_eval.METHODS, predict.METHODS):
        assert set(methods) >= {"orig", "selector",
                                *tbase.available_baselines()}


def test_batcher_serves_a_fastv_engine(weights):
    """A FastV request through the continuous batcher (per-layer cache
    lengths copied into its slot) gives one-shot ``generate``'s tokens,
    beside a text-only request in another slot."""
    from visionselector_tpu_torch.models.qwen25vl.continuous import (
        ContinuousBatcher,
    )

    _, _, tcfg, tparams, _ = weights
    ids, px, grid = _request()
    eng = tmodel.QwenVLEngine(tcfg, tparams,
                              strategy=tbase.get_baseline("fastv"),
                              device="cpu")
    want = eng.generate(ids, px, grid, max_new_tokens=NEW_TOKENS)
    text_want = eng.generate(np.arange(5, 17), max_new_tokens=5)
    bat = ContinuousBatcher(eng, n_slots=2, t_max=512, chunk=3)
    try:
        out = {}
        th = threading.Thread(target=lambda: out.setdefault(
            "text", bat.submit(dict(input_ids=np.arange(5, 17)), 5)))
        th.start()
        got = bat.submit(dict(input_ids=ids, pixel_values=px,
                              grid_thw=grid), NEW_TOKENS)
        th.join(timeout=120)
        assert not th.is_alive()
    finally:
        bat.shutdown()
    assert got.tokens == want.tokens
    np.testing.assert_array_equal(got.selected_indices,
                                  want.selected_indices)
    assert out["text"].tokens == text_want.tokens


def test_predict_cli_takes_a_baseline(capsys):
    from visionselector_tpu_torch.api import predict

    assert predict.main(["--device", "cpu", "--method", "fastv",
                         "--max-new-tokens", "3"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["method"] == "fastv" and len(out["tokens"]) == 3
    assert out["kept_vision_tokens"] < out["num_vision_tokens"]
    assert predict.main(["--device", "cpu", "--method", "prumerge+",
                         "--max-new-tokens", "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["method"] == "prumerge_plus"


def _task_dir(tmp_path):
    """A 2-token generate task with one image doc and one text doc."""
    from PIL import Image

    cfg, data = tmp_path / "configs", tmp_path / "data"
    cfg.mkdir()
    data.mkdir()
    (cfg / "tasks.json").write_text(json.dumps([
        {"name": "strat_gen", "metric": "exact_match", "max_new_tokens": 2}]))
    Image.fromarray((np.random.RandomState(0).rand(56, 56, 3) * 255).astype(
        np.uint8)).save(data / "img.png")
    docs = [{"question": "What is it?", "answers": ["A"], "image": "img.png"},
            {"question": "Say hi.", "answers": ["hi"]}]
    (data / "strat_gen.jsonl").write_text(
        "".join(json.dumps(d) + "\n" for d in docs))
    return str(cfg), str(data)


def test_run_eval_and_token_compression_take_baselines(tmp_path,
                                                       monkeypatch):
    """``api.run_eval --method visionzip`` on the smoke config, then
    ``run_token_compression`` over two methods: each writes its result
    file, every doc gets a prediction, and the harness tags the requests
    with the strategy's name (the response cache's key)."""
    from visionselector_tpu_torch.api import run_eval, run_token_compression
    from visionselector_tpu_torch.eval import caching

    tags = []
    key = caching.ResponseCache.key
    monkeypatch.setattr(caching.ResponseCache, "key", staticmethod(
        lambda task, doc_id, question, method, budget: tags.append(method)
        or key(task, doc_id, question, method, budget)))
    monkeypatch.setenv(caching.CACHE_ENV, str(tmp_path / "cache"))
    cfg, data = _task_dir(tmp_path)
    out = tmp_path / "out"
    common = ["--device", "cpu", "--data-dir", data, "--tasks", "strat_gen",
              "--task-config-dir", cfg, "--output-dir", str(out)]
    assert run_eval.main(common + ["--method", "visionzip"]) == 0
    res = json.loads((out / "visionzip_0.2_rank0.json").read_text())
    assert res["method"] == "visionzip"
    assert run_token_compression.main(
        ["--methods", "fastv,orig"] + common) == 0
    for m in ("visionzip", "fastv", "orig"):
        samples = (out / f"samples_{m}_0.2_rank0.jsonl").read_text()
        assert len(samples.splitlines()) == 2
    assert [t.split(":")[-2] for t in tags] == (
        ["visionzip"] * 2 + ["fastv"] * 2 + ["orig"] * 2)
