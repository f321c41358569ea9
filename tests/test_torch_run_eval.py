"""The port's eval CLIs on the CPU: ``api.run_eval`` end to end on the tiny
random-weight config (``--device cpu``), in a process that cannot import
jax, transformers or the JAX package; ``--merge`` and ``--from-log``
against the reference CLI's output on the same sample logs; each flag the
port does not take raising NotImplementedError with its ROADMAP item;
``api.run_selector`` and ``api.lmms_eval_cli``'s mapping onto ``run_eval``
arguments against the reference's; ``api.predict``'s ``load_tokenizer``
and ``chat_prompt_ids``; ``run_eval --speculative`` equal to the plain run
and ``predict --speculative`` exiting 0."""

import json
import os
import subprocess
import sys

import pytest

from visionselector_tpu.api import lmms_eval_cli as jlmms
from visionselector_tpu.api import predict as jpredict
from visionselector_tpu.api import run_eval as jrun_eval
from visionselector_tpu.api import run_selector as jrun_selector
from visionselector_tpu_torch.api import lmms_eval_cli as tlmms
from visionselector_tpu_torch.api import predict as tpredict
from visionselector_tpu_torch.api import run_eval as trun_eval
from visionselector_tpu_torch.api import run_selector as trun_selector

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _task_dir(tmp_path):
    """A task config dir (a 2-token generate task, an MC task) and their
    docs: one text-only and one image doc each."""
    from PIL import Image
    import numpy as np

    cfg, data = tmp_path / "configs", tmp_path / "data"
    cfg.mkdir()
    data.mkdir()
    with open(cfg / "tasks.json", "w") as f:
        json.dump([{"name": "cli_gen", "metric": "exact_match",
                    "max_new_tokens": 2},
                   {"name": "cli_mc", "metric": "multiple_choice",
                    "request_type": "loglikelihood"}], f)
    Image.fromarray((np.random.RandomState(0).rand(56, 56, 3) * 255).astype(
        np.uint8)).save(data / "img.png")
    docs = [{"question": "Say hi.", "answers": ["hi"], "choices": ["x", "y"]},
            {"question": "What is it?", "answers": ["A"], "image": "img.png",
             "choices": ["a thing", "b"]}]
    for name in ("cli_gen", "cli_mc"):
        with open(data / f"{name}.jsonl", "w") as f:
            f.writelines(json.dumps(d) + "\n" for d in docs)
    return str(cfg), str(data)


def test_run_eval_cli_without_jax_or_transformers(tmp_path):
    """``run_eval --device cpu`` on the tiny config, then ``--merge`` of
    its sample log, in a process where jax, transformers, PyYAML and the
    JAX package cannot be imported (JSON task files): the json files are
    written, every doc has a prediction, and no kernel is launched."""
    cfg, data = _task_dir(tmp_path)
    out = str(tmp_path / "out")
    code = f"""
import json, sys
for name in ("jax", "jaxlib", "triton", "visionselector_tpu", "transformers",
             "yaml"):
    sys.modules[name] = None  # any import of them raises ImportError
from visionselector_tpu_torch.api import run_eval
from visionselector_tpu_torch.kernels import attention as A
args = ["--data-dir", {data!r}, "--tasks", "cli_gen,cli_mc",
        "--task-config-dir", {cfg!r}, "--budgets", "0.5",
        "--device", "cpu", "--output-dir", {out!r}]
assert run_eval.main(args) == 0
assert run_eval.main(args + ["--merge"]) == 0
loaded = sorted({{m.split(".")[0] for m, mod in sys.modules.items()
                 if mod is not None}}
                & {{"jax", "jaxlib", "visionselector_tpu", "transformers"}})
print(json.dumps({{"loaded": loaded, "launches": [
    A.FLASH_LAUNCHES, A.DIAG_LAUNCHES, A.DECODE_LAUNCHES]}}))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == {
        "loaded": [], "launches": [0, 0, 0]}
    with open(os.path.join(out, "selector_0.5_rank0.json")) as f:
        res = json.load(f)
    assert res["device"] == "cpu"
    assert res["results"]["cli_gen/n"] == res["results"]["cli_mc/n"] == 2.0
    with open(os.path.join(out, "samples_selector_0.5_rank0.jsonl")) as f:
        preds = [json.loads(line)["prediction"] for line in f]
    assert len(preds) == 4 and preds[2] in ("A", "B") and preds[3] in (
        "A", "B")
    with open(os.path.join(out, "merged_selector_0.5.json")) as f:
        merged = json.load(f)
    assert merged["ranks"] == 1
    assert merged["results"]["cli_mc/multiple_choice"] == \
        res["results"]["cli_mc/multiple_choice"]
    assert os.listdir(os.path.join(out, "tracker"))


def _sample_logs(tmp_path):
    """Two ranks' sample logs of chartqa (3 docs, one padding row)."""
    data = tmp_path / "data"
    data.mkdir()
    with open(data / "chartqa.jsonl", "w") as f:
        for i in range(3):
            f.write(json.dumps({"question": f"What is {i}?",
                                "answers": [str(i)]}) + "\n")
    out = tmp_path / "out"
    out.mkdir()
    recs = {0: [(0, "0", False), (2, "1", False)],
            1: [(1, "1", False), (1, "1", True)]}
    for rank, rows in recs.items():
        with open(out / f"samples_selector_0.2_rank{rank}.jsonl", "w") as f:
            for doc_id, pred, pad in rows:
                f.write(json.dumps({
                    "task": "chartqa", "doc_id": doc_id,
                    "question": f"What is {doc_id}?" + "\nAnswer the "
                    "question using a single word or phrase.",
                    "answers": [str(doc_id)], "prediction": pred,
                    "is_padding": pad}) + "\n")
    return str(data), str(out)


@pytest.mark.parametrize("mode", ["merge", "from_log"])
def test_merge_and_from_log_match_reference(tmp_path, mode, capsys):
    data, out = _sample_logs(tmp_path)
    printed = []
    for main in (jrun_eval.main, trun_eval.main):
        if mode == "merge":
            args = ["--data-dir", data, "--tasks", "chartqa", "--merge",
                    "--output-dir", out]
            name = "merged_selector_0.2.json"
        else:
            args = ["--data-dir", data, "--tasks", "chartqa", "--from-log",
                    out, "--output-dir", out]
            name = "from_log.json"
        assert main(args) == 0
        printed.append(json.loads(capsys.readouterr().out.splitlines()[-1]))
        with open(os.path.join(out, name)) as f:
            printed.append(json.load(f)["results"])
    wall = [k for k in printed[0] if k.endswith("/wall_s")]
    for res in printed:
        for k in wall:
            res.pop(k, None)
    assert printed[2:] == printed[:2]
    assert printed[1]["chartqa/n"] == 3.0


@pytest.mark.parametrize("flags, item", [
    (["--family", "llava_ov15", "--quantize", "int8"], 9),
    (["--quantize", "int8"], 9),
])
def test_unported_flags_raise_with_their_item(tmp_path, flags, item):
    with pytest.raises(NotImplementedError, match=f"item {item}\\b"):
        trun_eval.main(["--data-dir", str(tmp_path), "--tasks", "chartqa",
                        "--device", "cpu"] + flags)


def _gen_task(tmp_path):
    """A config dir with one 8-token generate task and its docs: a text
    doc and an image doc."""
    from PIL import Image
    import numpy as np

    cfg, data = tmp_path / "configs", tmp_path / "data"
    cfg.mkdir()
    data.mkdir()
    with open(cfg / "tasks.json", "w") as f:
        json.dump([{"name": "spec_gen", "metric": "exact_match",
                    "max_new_tokens": 8}], f)
    Image.fromarray((np.random.RandomState(1).rand(56, 56, 3) * 255).astype(
        np.uint8)).save(data / "img.png")
    with open(data / "spec_gen.jsonl", "w") as f:
        for d in ({"question": "Say hi twice.", "answers": ["hi"]},
                  {"question": "What is it?", "answers": ["A"],
                   "image": "img.png"},
                  {"question": "Name it.", "answers": ["B"],
                   "image": "img.png"}):
            f.write(json.dumps(d) + "\n")
    return str(cfg), str(data)


@pytest.mark.parametrize("flags", [
    [],
    ["--decode-batch", "2"],
    ["--family", "llava_ov15", "--method", "visionzip"],
], ids=["one-by-one", "decode-batch-2", "ov-visionzip"])
def test_run_eval_speculative_equals_plain(tmp_path, flags):
    """``--speculative 3`` (refused until ROADMAP item 7 was ported) gives
    the plain run's predictions: one-request groups decode speculatively,
    ``--decode-batch 2`` groups still batch; the OV family and a
    strategy too."""
    cfg, data = _gen_task(tmp_path)
    preds = []
    for spec in ([], ["--speculative", "3"]):
        out = str(tmp_path / f"out{len(spec)}")
        assert trun_eval.main(
            ["--data-dir", data, "--tasks", "spec_gen", "--task-config-dir",
             cfg, "--budgets", "0.5", "--device", "cpu", "--output-dir",
             out] + flags + spec) == 0
        method = flags[-1] if "--method" in flags else "selector"
        with open(os.path.join(out, f"samples_{method}_0.5_rank0.jsonl")) \
                as f:
            preds.append([json.loads(line)["prediction"] for line in f])
    assert preds[1] == preds[0] and len(preds[0]) == 3


@pytest.mark.parametrize("family", ["qwen25vl", "llava_ov15"])
def test_predict_speculative_exits_zero(family, capsys):
    """``api.predict --speculative 3`` exits 0 and prints the plain run's
    tokens with its verify steps and proposal counts."""
    args = ["--device", "cpu", "--family", family, "--max-new-tokens", "6",
            "--prompt-ids", "5,6,7,5,6"]
    assert tpredict.main(args) == 0
    plain = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert tpredict.main(args + ["--speculative", "3"]) == 0
    spec = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert spec["tokens"] == plain["tokens"] and len(spec["tokens"]) == 6
    assert spec["spec_proposed"] == 3 * spec["decode_dispatches"]
    assert 1 <= spec["decode_dispatches"] <= 5


def test_run_eval_refuses_a_missing_card(tmp_path, monkeypatch):
    """``--device cuda`` (the default) without a GPU fails; it does not fall
    back to the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        trun_eval.main(["--data-dir", str(tmp_path), "--tasks", "chartqa"])


@pytest.mark.parametrize("argv", [
    [],
    ["--tasks", "chartqa", "--budgets", "0.5"],
    ["--model-path", "/ckpt", "--limit", "4"],
])
def test_run_selector_argv_matches_reference(monkeypatch, argv):
    seen = []
    monkeypatch.setattr(jrun_eval, "main", lambda a: seen.append(a) or 0)
    assert jrun_selector.main(list(argv)) == 0
    assert trun_selector.selector_argv(argv) == seen[0]


@pytest.mark.parametrize("argv", [
    ["--model", "qwen2_5_vl_with_token_compression", "--model_args",
     "pretrained=/ckpt,method=selector,budgets=0.1,0.2", "--tasks",
     "chartqa", "--data_dir", "/data", "--limit", "0.5"],
    ["--model", "qwen2_5_vl", "--model_args", "min_pixels=3136,max_pixels="
     "1000000", "--tasks", "mme", "--data_dir", "/data",
     "--output_path", "res"],
    ["--model", "from_log", "--model_args", "logs=/a.jsonl,/b.jsonl",
     "--tasks", "pope", "--data_dir", "/data", "--limit", "8"],
    ["--model", "openai_compatible", "--model_args",
     "base_url=http://localhost:1,model=m", "--tasks", "pope",
     "--data_dir", "/data"],
    ["--model", "llava_onevision1_5", "--model_args", "method=orig",
     "--tasks", "pope", "--data_dir", "/data"],
])
def test_lmms_eval_cli_maps_like_reference(monkeypatch, argv):
    """The port passes ``run_eval`` what the reference passes, plus its
    ``--device``; the same model_args parsing."""
    seen = []
    monkeypatch.setattr(jrun_eval, "main", lambda a: seen.append(a) or 0)
    assert jlmms.main(argv) == 0
    got = tlmms.run_eval_argv(tlmms.build_parser().parse_args(argv))
    if "--device" in got:
        i = got.index("--device")
        assert got[i + 1] == "cuda"
        got = got[:i] + got[i + 2:]
    assert got == seen[0]
    ma = argv[argv.index("--model_args") + 1]
    assert tlmms.parse_model_args(ma) == jlmms.parse_model_args(ma)


def test_lmms_eval_cli_batch_size_maps_to_decode_batch():
    args = tlmms.build_parser().parse_args(
        ["--model", "qwen2_5_vl", "--tasks", "pope", "--data_dir", "/d",
         "--batch_size", "4"])
    argv = tlmms.run_eval_argv(args)
    assert argv[argv.index("--decode-batch") + 1] == "4"
    with pytest.raises(SystemExit):
        tlmms.run_eval_argv(tlmms.build_parser().parse_args(
            ["--model", "nope", "--tasks", "pope"]))


def test_lmms_eval_cli_openai_compatible_is_refused(tmp_path):
    """The ``openai_compatible`` model maps to ``--http-endpoint``, which
    refuses a loglikelihood-scored task before any request, as the
    reference's does (chat completions give no token log-probs)."""
    (tmp_path / "scienceqa_img.jsonl").write_text(json.dumps(
        {"question": "Pick one.", "answers": ["A"],
         "choices": ["a", "b"]}) + "\n")
    argv = ["--model", "openai_compatible", "--model_args",
            "base_url=http://localhost:1,model=m", "--tasks",
            "scienceqa_img_ll", "--data_dir", str(tmp_path),
            "--output_path", str(tmp_path / "out")]
    for cli in (tlmms, jlmms):
        with pytest.raises(SystemExit, match="log-probs"):
            cli.main(argv)


class _Tok:
    def encode(self, s):
        return [len(w) for w in s.split()]


def test_chat_prompt_ids_match_reference():
    assert (tpredict.chat_prompt_ids(_Tok(), "Describe it.")
            == jpredict.chat_prompt_ids(_Tok(), "Describe it."))


def test_load_tokenizer_returns_none_without_transformers(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    monkeypatch.setitem(sys.modules, "transformers", None)
    assert tpredict.load_tokenizer(str(tmp_path)) is None
    assert "--prompt-ids" in capsys.readouterr().err


def test_load_tokenizer_reads_a_local_tokenizer(tmp_path):
    """A tokenizer saved in the checkpoint directory loads without the
    network, as the reference's does, and encodes the chat prompt alike."""
    pytest.importorskip("transformers")
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    words = ["<unk>", "Describe", "it.", "hello"]
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)},
                                     unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok,
                            unk_token="<unk>").save_pretrained(str(tmp_path))
    got = tpredict.load_tokenizer(str(tmp_path))
    want = jpredict.load_tokenizer(str(tmp_path))
    assert got is not None
    assert (tpredict.chat_prompt_ids(got, "Describe it.")
            == jpredict.chat_prompt_ids(want, "Describe it."))
