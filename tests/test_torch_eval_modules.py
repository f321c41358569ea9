"""The port's copies of the JAX package's jax-free eval modules
(``visionselector_tpu_torch/eval/{metrics,filters,tasks,caching,tracker,
extract_time,replay,visualize}.py``) against their originals: the same
inputs through both give equal outputs. Each metric, each filter pipeline,
the task registry, doc loading with a count and a fractional limit, rank
sharding, aggregation, the response cache's keys, EVAL_TIME scraping, the
replay adapter and the visualization PNGs."""

import dataclasses
import json
import os

import numpy as np
import pytest

from visionselector_tpu.eval import caching as jcaching
from visionselector_tpu.eval import extract_time as jextract
from visionselector_tpu.eval import filters as jfilters
from visionselector_tpu.eval import metrics as jmetrics
from visionselector_tpu.eval import replay as jreplay
from visionselector_tpu.eval import tasks as jtasks
from visionselector_tpu.eval import tracker as jtracker
from visionselector_tpu.eval import visualize as jvisualize
from visionselector_tpu_torch.eval import caching as tcaching
from visionselector_tpu_torch.eval import extract_time as textract
from visionselector_tpu_torch.eval import filters as tfilters
from visionselector_tpu_torch.eval import metrics as tmetrics
from visionselector_tpu_torch.eval import replay as treplay
from visionselector_tpu_torch.eval import tasks as ttasks
from visionselector_tpu_torch.eval import tracker as ttracker
from visionselector_tpu_torch.eval import visualize as tvisualize

# The built-in task registries, as imported: a test of another file run
# earlier in the same worker may register a task at run time
# (tests/test_eval.py registers "mytask" in the JAX package's registry).
JAX_TASKS = dict(jtasks.TASKS)
PORT_TASKS = dict(ttasks.TASKS)

PREDICTIONS = ["104", "The answer is (B).", "yes, it is", "the cat",
               "12 dollars", "helo world", "25%", "no\nmaybe", "", "C"]
ANSWERS = [["100"], ["B"], ["yes"], ["cat"] * 3 + ["dog"] * 7,
           ["12 dollars", "twelve"], ["hello world"], ["0.25"], ["no"],
           ["x"], ["A"]]


@pytest.mark.parametrize("name", sorted(jmetrics.METRICS))
def test_metric_matches_reference(name):
    assert sorted(tmetrics.METRICS) == sorted(jmetrics.METRICS)
    for pred, answers in zip(PREDICTIONS, ANSWERS):
        target = (answers[0] if name in ("multiple_choice", "yes_no")
                  else answers)
        assert (tmetrics.METRICS[name](pred, target)
                == jmetrics.METRICS[name](pred, target)), (pred, answers)


@pytest.mark.parametrize("case", ["bootstrap", "pope", "cider", "anls"])
def test_metric_helpers_match_reference(case):
    values = [float(x) for x in np.random.RandomState(0).rand(37) > 0.4]
    if case == "bootstrap":
        assert (tmetrics.bootstrap_stderr(values)
                == jmetrics.bootstrap_stderr(values))
        assert tmetrics.mean(values) == jmetrics.mean(values)
    elif case == "pope":
        preds, gold = ["yes", "no", "yes", "no"], ["yes", "yes", "no", "no"]
        assert (tmetrics.pope_aggregate(preds, gold)
                == jmetrics.pope_aggregate(preds, gold))
    elif case == "cider":
        preds = ["a cat on a mat", "two dogs", "a red car"]
        refs = [["a cat sits on the mat"], ["two dogs play"], ["a car"]]
        got, want = tmetrics.cider_d(preds, refs), jmetrics.cider_d(preds,
                                                                   refs)
        assert got[0] == want[0] and list(got[1]) == list(want[1])
    else:
        assert (tmetrics.anls("helo", ["hello"], threshold=0.7)
                == jmetrics.anls("helo", ["hello"], threshold=0.7))


@pytest.mark.parametrize("name", sorted(jfilters.PIPELINES))
def test_filter_pipeline_matches_reference(name):
    assert sorted(tfilters.PIPELINES) == sorted(jfilters.PIPELINES)
    assert (tfilters.apply_filters(name, PREDICTIONS)
            == jfilters.apply_filters(name, PREDICTIONS))


def test_task_registry_matches_reference():
    assert sorted(PORT_TASKS) == sorted(JAX_TASKS)
    for name, task in JAX_TASKS.items():
        assert dataclasses.asdict(PORT_TASKS[name]) == dataclasses.asdict(
            task)


def _write_docs(tmp_path, n=10):
    with open(tmp_path / "chartqa.jsonl", "w") as f:
        for i in range(n):
            doc = {"question": f"What is {i}?", "answers": [str(i)]}
            if i % 3 == 0:
                doc["image"] = "img.png"
            if i % 4 == 1:
                doc["images"] = ["a.png", "b.png"]
            if i % 5 == 2:
                doc["choices"] = ["x", "y"]
            f.write(json.dumps(doc) + "\n")
    return str(tmp_path)


def _fields(reqs):
    return [(dataclasses.asdict(dataclasses.replace(r, task=None)),
             r.task.name) for r in reqs]


@pytest.mark.parametrize("limit", [None, 4, 0.35])
def test_task_docs_limit_and_shard_match_reference(tmp_path, limit):
    data_dir = _write_docs(tmp_path)
    jreqs = jtasks.load_task_docs(jtasks.TASKS["chartqa"], data_dir, limit)
    treqs = ttasks.load_task_docs(ttasks.TASKS["chartqa"], data_dir, limit)
    assert _fields(treqs) == _fields(jreqs)
    for rank in range(3):
        assert (_fields(ttasks.shard_requests(treqs, rank, 3))
                == _fields(jtasks.shard_requests(jreqs, rank, 3)))
    preds = [str(i) if i % 2 else "no" for i in range(len(treqs))]
    for name in ("chartqa", "pope", "scienceqa_img"):
        tt = dataclasses.replace(ttasks.TASKS[name])
        jt = jtasks.TASKS[name]
        assert (ttasks.aggregate_scores(
            tt, preds, [dataclasses.replace(r, task=tt) for r in treqs])
            == jtasks.aggregate_scores(
                jt, preds, [dataclasses.replace(r, task=jt) for r in jreqs]))


def test_task_config_files_register_alike(tmp_path):
    """A JSON and a YAML task file register equal configs; both registries
    are restored afterwards."""
    with open(tmp_path / "a.json", "w") as f:
        json.dump({"name": "port_cfg_a", "metric": "exact_match",
                   "max_new_tokens": 4}, f)
    with open(tmp_path / "b.yaml", "w") as f:
        f.write("name: port_cfg_b\nmetric: multiple_choice\n"
                "request_type: loglikelihood\n")
    saved = dict(jtasks.TASKS), dict(ttasks.TASKS)
    try:
        assert (ttasks.load_task_configs(str(tmp_path))
                == jtasks.load_task_configs(str(tmp_path)))
        for name in ("port_cfg_a", "port_cfg_b"):
            assert (dataclasses.asdict(ttasks.TASKS[name])
                    == dataclasses.asdict(jtasks.TASKS[name]))
    finally:
        for reg, old in zip((jtasks.TASKS, ttasks.TASKS), saved):
            reg.clear()
            reg.update(old)


def test_extract_time_matches_reference():
    text = ("Input visual token number is: 252\n"
            "Generation prefill time is: 108.5\nnoise\n"
            "Generation total time is: 1200.25\n"
            "Input visual token number is: 300\n"
            "Generation prefill time is: 99.0\n"
            "Generation total time is: 1000\n")
    assert textract.extract(text) == jextract.extract(text)
    assert textract.extract("") == jextract.extract("")


def test_cache_keys_and_roundtrip_match_reference(tmp_path):
    args = ("chartqa", 3, "What is 3?", "qwen25vl:smoke:selector", 0.2)
    assert tcaching.ResponseCache.key(*args) == jcaching.ResponseCache.key(
        *args)
    tc = tcaching.ResponseCache(str(tmp_path))
    tc.put(tc.key(*args), "three")
    # a response written by the port reads back through the reference
    assert jcaching.ResponseCache(str(tmp_path)).get(
        jcaching.ResponseCache.key(*args)) == "three"


def test_replay_adapter_matches_reference(tmp_path):
    data_dir = _write_docs(tmp_path, n=4)
    log = tmp_path / "samples_rank0.jsonl"
    with open(log, "w") as f:
        for i in range(4):
            f.write(json.dumps({"task": "chartqa", "doc_id": i,
                                "question": f"What is {i}?",
                                "answers": [str(i)], "prediction": str(i % 2),
                                "is_padding": False}) + "\n")
    jreqs = jtasks.load_task_docs(jtasks.TASKS["chartqa"], data_dir)
    treqs = ttasks.load_task_docs(ttasks.TASKS["chartqa"], data_dir)
    assert (treplay.ReplayAdapter(str(log)).generate_until(treqs)
            == jreplay.ReplayAdapter(str(log)).generate_until(jreqs))


def test_tracker_writes_the_reference_files(tmp_path):
    results = {"chartqa/relaxed_accuracy": 0.5, "chartqa/n": 2.0}
    for mod, sub in ((jtracker, "j"), (ttracker, "t")):
        tr = mod.EvaluationTracker(output_dir=str(tmp_path / sub),
                                   model_name="qwen25vl", model_args="x=1")
        tr.save_results_aggregated(results, config={"tasks": ["chartqa"]})
        tr.save_results_samples("chartqa", [{"doc_id": 0}])
        tr.finish()
    names = [sorted(f.split("_")[0] for f in os.listdir(tmp_path / s))
             for s in ("j", "t")]
    assert names[0] == names[1]
    blobs = []
    for s in ("j", "t"):
        path = [f for f in os.listdir(tmp_path / s)
                if f.startswith("results_")][0]
        with open(tmp_path / s / path) as f:
            blob = json.load(f)
        blobs.append((blob["results"], sorted(blob)))
    assert blobs[0] == blobs[1]


def test_visualize_selection_writes_equal_pngs(tmp_path):
    pytest.importorskip("PIL")
    rng = np.random.RandomState(0)
    img = (rng.rand(112, 168, 3) * 255).astype(np.uint8)
    grid = np.array([[1, 8, 12]])
    scores = rng.randn(24).astype(np.float32)
    kept = np.sort(np.argsort(-scores)[:6])
    outs = [mod.visualize_selection(img, scores, kept, grid,
                                    str(tmp_path / name))
            for mod, name in ((jvisualize, "j"), (tvisualize, "t"))]
    assert len(outs[0]) == len(outs[1]) > 0
    for a, b in zip(outs[0], outs[1]):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
