"""The port's evaluation harness against ``visionselector_tpu``'s, in one
process on qwen25vl_tiny with the same weights and the same stub tokenizer
(``tests/test_eval.py``'s: word hashes, stable within a process):
``evaluate`` over synthetic ``generate_until`` and multiple-choice
(loglikelihood) tasks of image and text-only docs, the multi-round and
pairwise ``loglikelihood`` adapter methods, ``merge_results`` across two
ranks, the response cache and the EVAL_TIME probes. Predictions must be
equal and the results dicts equal, apart from wall and device times.
Tasks are registered in both ``TASKS`` registries and removed after."""

import contextlib
import dataclasses
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image
from torch_port_params import jax_param_tree

from visionselector_tpu.core.config import qwen25vl_tiny as jax_tiny
from visionselector_tpu.eval import evaluator as jev
from visionselector_tpu.eval import tasks as jtasks
from visionselector_tpu.models.qwen25vl import model as jmodel
from visionselector_tpu_torch.core.config import qwen25vl_tiny
from visionselector_tpu_torch.eval import evaluator as tev
from visionselector_tpu_torch.eval import extract_time
from visionselector_tpu_torch.eval import tasks as ttasks
from visionselector_tpu_torch.models.qwen25vl import model as tmodel
from visionselector_tpu_torch.models.qwen25vl.weights import from_jax_params

GEN, MC = "port_gen", "port_mc"
TIMING = ("/wall_s", "avg_prefill_ms", "avg_latency_ms")


class Tok:
    """The JAX eval tests' stub tokenizer."""

    def encode(self, s):
        return [abs(hash(w)) % 1000 + 600 for w in s.split()][:8]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)


@pytest.fixture(scope="module")
def engines():
    jcfg = jax_tiny()
    tree = jax_param_tree(jcfg, seed=0, scorer_std=0.02)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = from_jax_params(tree, qwen25vl_tiny(), "cpu")
    return (jmodel.QwenVLEngine(jcfg, jparams, budget=0.5),
            tmodel.QwenVLEngine(qwen25vl_tiny(), tparams, budget=0.5,
                                device="cpu"))


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """Two tasks registered in both registries (removed at the end): a
    generate_until task of 4 docs (2 text-only, 2 with images of two
    sizes), 4 new tokens; an MC loglikelihood task of 4 docs with 2, 3, 4
    and no choices (A-D), one with an image."""
    d = tmp_path_factory.mktemp("eval_data")
    rng = np.random.RandomState(0)
    for name, hw in (("a.png", (56, 56)), ("b.png", (112, 84))):
        Image.fromarray((rng.rand(*hw, 3) * 255).astype(np.uint8)).save(
            d / name)
    gen = [{"question": "What is two?", "answers": ["2"]},
           {"question": "Read the chart.", "answers": ["x"],
            "image": "a.png"},
           {"question": "Name a color.", "answers": ["red"]},
           {"question": "Count the bars.", "answers": ["3"],
            "image": "b.png"}]
    mc = [{"question": "Pick one.", "answers": ["B"],
           "choices": ["a cat", "a dog"]},
          {"question": "Which shape?", "answers": ["A"], "image": "a.png",
           "choices": ["round", "square one", "flat"]},
          {"question": "Best answer?", "answers": ["C"],
           "choices": ["one", "two", "three four five", "six"]},
          {"question": "Letter only.", "answers": ["D"]}]
    for name, docs in ((GEN, gen), (MC, mc)):
        with open(d / f"{name}.jsonl", "w") as f:
            f.writelines(json.dumps(doc) + "\n" for doc in docs)
    configs = {GEN: dict(metric="exact_match", max_new_tokens=4),
               MC: dict(metric="multiple_choice",
                        request_type="loglikelihood")}
    regs = ((jtasks.TASKS, jtasks.TaskConfig),
            (ttasks.TASKS, ttasks.TaskConfig))
    for reg, cls in regs:
        for name, kw in configs.items():
            reg[name] = cls(name, **kw)
    yield str(d)
    for reg, _ in regs:
        for name in configs:
            reg.pop(name)


def _run(adapter, evaluate, data_dir, path, **kw):
    res = evaluate(adapter, [GEN, MC], data_dir, log_samples_path=str(path),
                   **kw)
    with open(path) as f:
        preds = [json.loads(line)["prediction"] for line in f]
    return res, preds


def _untimed(res):
    return {k: v for k, v in res.items() if not k.endswith(TIMING)}


@pytest.fixture(scope="module")
def runs(engines, data_dir, tmp_path_factory):
    """evaluate through the JAX adapter and the port's, EVAL_TIME on."""
    jeng, teng = engines
    d = tmp_path_factory.mktemp("eval_runs")
    jres = _run(jev.EngineAdapter(jeng, Tok(), eval_time=True), jev.evaluate,
                data_dir, d / "jax.jsonl")
    tadapter = tev.EngineAdapter(teng, Tok(), eval_time=True)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        tres = _run(tadapter, tev.evaluate, data_dir, d / "port.jsonl")
    return jres, tres, tadapter, printed.getvalue()


def test_evaluate_matches_jax_adapter(runs):
    (jres, jpreds), (tres, tpreds), _, _ = runs
    assert len(tpreds) == 8 and all(isinstance(p, str) for p in tpreds)
    assert tpreds == jpreds
    assert sorted(tres) == sorted(jres)
    assert _untimed(tres) == _untimed(jres)
    assert tres[f"{GEN}/n"] == tres[f"{MC}/n"] == 4.0
    assert all(p in "ABCD" and len(p) == 1 for p in tpreds[4:])


def test_mc_predictions_are_the_argmax_of_choice_lls(engines, data_dir, runs):
    """Each MC prediction is the letter of the choice with the largest
    ``run_loglikelihood_choices`` score, computed here directly."""
    _, teng = engines
    _, (_, tpreds), adapter, _ = runs
    reqs = ttasks.load_task_docs(ttasks.TASKS[MC], data_dir)
    for req, pred in zip(reqs, tpreds[4:]):
        kw, _ = adapter._prepare_request(req)
        choices = req.choices or ["A", "B", "C", "D"]
        conts = [np.asarray(Tok().encode(" " + c.strip())) for c in choices]
        lls = tmodel.run_loglikelihood_choices(teng, kw.pop("input_ids"),
                                               conts, **kw)
        assert pred == "ABCD"[int(np.argmax([ll for ll, _ in lls]))]


def test_eval_time_probes_print_and_summarize(runs):
    """The printed EVAL_TIME lines, one set per generated request, scrape
    (``extract_time``) to the summary's averages; its token counts equal
    the reference's."""
    (jres, _), (tres, _), _, printed = runs
    for key in ("avg_visual_tokens", "avg_input_tokens", "avg_output_tokens"):
        assert tres[key] == jres[key]
    assert tres["avg_prefill_ms"] > 0 and tres["avg_latency_ms"] > 0
    scraped = extract_time.extract(printed)
    assert scraped["n_prefill_ms"] == scraped["n_visual_tokens"] == 4.0
    for key in ("avg_visual_tokens", "avg_prefill_ms", "avg_latency_ms"):
        assert scraped[key] == pytest.approx(tres[key], rel=1e-9)


def test_adapter_loglikelihood_pairs_match_jax(engines, data_dir):
    jeng, teng = engines
    pairs = []
    for reqs, task in ((jtasks, jtasks.TASKS), (ttasks, ttasks.TASKS)):
        docs = reqs.load_task_docs(task[MC], data_dir)[:2]
        pairs.append([(r, " a cat") for r in docs] + [(docs[1], " flat")])
    want = jev.EngineAdapter(jeng, Tok()).loglikelihood(pairs[0])
    got = tev.EngineAdapter(teng, Tok()).loglikelihood(pairs[1])
    for (ll_g, gr_g), (ll_w, gr_w) in zip(got, want):
        assert abs(ll_g - ll_w) < 1e-4 and gr_g == gr_w


def test_multi_round_matches_jax(engines, data_dir):
    jeng, teng = engines
    outs = []
    for adapter, tasks in ((jev.EngineAdapter(jeng, Tok()), jtasks),
                           (tev.EngineAdapter(teng, Tok()), ttasks)):
        req = tasks.load_task_docs(tasks.TASKS[GEN], data_dir)[1]
        multi = dataclasses.replace(req, question=["First round?",
                                                   "Second round?"])
        outs.append(adapter.generate_until_multi_round([multi]))
    assert outs[1] == outs[0] and outs[1][0]


def test_merge_results_across_two_ranks(engines, data_dir, runs, tmp_path):
    """Two ranks (each padded to the same count) merge to the single run's
    metrics; the reference's merge reads the port's logs alike."""
    _, teng = engines
    _, (single, _), _, _ = runs
    logs = []
    for rank in range(2):
        path = tmp_path / f"rank{rank}.jsonl"
        tev.evaluate(tev.EngineAdapter(teng, Tok()), [GEN, MC], data_dir,
                     limit=3, rank=rank, world_size=2,
                     log_samples_path=str(path))
        logs.append(str(path))
    merged = tev.merge_results(logs)
    assert merged == jev.merge_results(logs)
    assert merged[f"{GEN}/n"] == merged[f"{MC}/n"] == 3.0
    # the first 3 docs of the single 4-doc run score the same
    with open(logs[0]) as f0, open(logs[1]) as f1:
        recs = [json.loads(line) for line in f0.readlines() + f1.readlines()]
    assert sum(r["is_padding"] for r in recs) == 2
    assert len({(r["task"], r["doc_id"]) for r in recs}) == 6
    for task in (GEN, MC):
        assert 0.0 <= merged[f"{task}/{ttasks.TASKS[task].metric}"] <= 1.0
    assert set(merged) == {k for k in _untimed(single)
                           if not k.startswith("avg_")}


def test_second_run_served_from_cache(engines, data_dir, tmp_path,
                                      monkeypatch):
    _, teng = engines
    monkeypatch.setenv("LM_HARNESS_CACHE_PATH", str(tmp_path / "cache"))
    first = tev.evaluate(tev.EngineAdapter(teng, Tok()), [GEN], data_dir,
                         limit=2)
    adapter = tev.EngineAdapter(teng, Tok())
    called = []
    monkeypatch.setattr(adapter, "generate_until",
                        lambda reqs: called.append(reqs) or [])
    again = tev.evaluate(adapter, [GEN], data_dir, limit=2)
    assert called == [] and _untimed(again) == _untimed(first)


def test_unported_requests_raise(engines, data_dir):
    """A video doc (once refused) is prepared as the JAX adapter prepares
    it: ``process_video`` of its ``.npy`` clip, ``<|video_pad|>`` tokens
    and ``second_per_grid_ts``; no visualization grid."""
    jeng, teng = engines
    clip = (np.random.RandomState(3).rand(5, 56, 84, 3) * 255).astype(
        np.uint8)
    path = os.path.join(data_dir, "clip.npy")
    np.save(path, clip)
    req = dataclasses.replace(
        ttasks.load_task_docs(ttasks.TASKS[GEN], data_dir)[0],
        video_path=path)
    got, grid = tev.EngineAdapter(teng, Tok())._prepare_request(req)
    want, _ = jev.EngineAdapter(jeng, Tok())._prepare_request(req)
    assert grid is None and sorted(got) == sorted(want)
    assert "pixel_values_videos" in got and "pixel_values" not in got
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
